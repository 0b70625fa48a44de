"""Classification fine-tuning step (EuroSAT), in PyTorch.

Counterpart of ``dinomc_tpu/train/cls_trainer.py``; parity target the
reference ``main_eurosat.py``: an end-to-end fine-tune of the backbone and a
linear classifier by SGD (``main_eurosat.py:101-107``), CE loss with
optional label smoothing, or ``MultiLabelSoftMarginLoss`` with
``multilabel`` (``main_bigearthnet.py``). With ``freeze_backbone`` the
features are computed without autograd, so the backward never enters the
backbone, and the optimizer's frozen mask leaves the backbone's parameters
and optimizer state untouched. A ResNet's BatchNorm normalizes by the batch
in the train step and moves its running statistics in both modes, as the
JAX step keeps ``new_bn`` whether the backbone is frozen or not;
``cls_predict`` normalizes by the running statistics. The classifier is a
(D, C) ``kernel`` and a ``bias``, as in the JAX package. The step updates
``ClsTrainState`` in place. Encoders come from
``models/encoders.EncoderConfig`` (the ViTs, Swin-T, the ResNets and XCiT,
whose LPI BatchNorm reads the batch in ``cls_predict`` too).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dinomc_tpu_torch.models.encoders import EncoderConfig
from dinomc_tpu_torch.objectives.segmentation import multilabel_soft_margin_loss
from dinomc_tpu_torch.train import optim
from dinomc_tpu_torch.train.dino_trainer import set_matmul_precision


@dataclasses.dataclass(frozen=True)
class ClsConfig:
    arch: str = "vit_small"
    patch_size: int = 8
    num_classes: int = 10
    multilabel: bool = False
    optimizer: str = "sgd"  # momentum 0.9, as the JAX step passes none
    label_smoothing: float = 0.0
    freeze_backbone: bool = False  # True: linear-probe-style training
    # "bfloat16" is the training path; "float32" for the parity tests
    compute_dtype: str = "bfloat16"

    def encoder(self) -> EncoderConfig:
        return EncoderConfig(arch=self.arch, patch_size=self.patch_size,
                             compute_dtype=getattr(torch, self.compute_dtype))


class LinearClassifier(nn.Module):
    """logits = feats @ kernel + bias; kernel (D, C) drawn 0.01 * N(0, 1)."""

    def __init__(self, D: int, C: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(0.01 * torch.randn(D, C, generator=gen))
        self.bias = nn.Parameter(torch.zeros(C))


@dataclasses.dataclass
class ClsTrainState:
    """Train state, updated in place by ``cls_train_step``."""

    step: int
    model: nn.ModuleDict  # {'backbone', 'fc'}
    opt_state: Dict
    generator: torch.Generator  # DropPath draws, on the state's device


def init_cls_train_state(cfg: ClsConfig, seed: int = 0, device="cpu") -> ClsTrainState:
    """Backbone, then classifier, drawn on the CPU from ``seed`` (every
    device starts from the same weights), moved to ``device``."""
    opt_init, _ = optim.OPTIMIZERS[cfg.optimizer]
    set_matmul_precision()
    gen = torch.Generator().manual_seed(seed)
    enc = cfg.encoder()
    backbone = enc.build(gen)
    model = nn.ModuleDict({
        "backbone": backbone, "fc": LinearClassifier(enc.embed_dim, cfg.num_classes, gen),
    }).to(device)
    return ClsTrainState(
        step=0, model=model, opt_state=opt_init(dict(model.named_parameters())),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )


def cls_logits(model: nn.ModuleDict, images: torch.Tensor, cfg: ClsConfig, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, C) f32 logits."""
    enc = cfg.encoder()
    if cfg.freeze_backbone:
        # linear-probe mode: no autograd through the backbone, so the
        # backward skips it (the frozen mask alone would still pay for it);
        # BatchNorm still moves its running statistics when ``train``
        with torch.no_grad():
            feats = enc.apply(model["backbone"], images, train, generator)
    else:
        feats = enc.apply(model["backbone"], images, train, generator)
    fc = model["fc"]
    return feats @ fc.kernel + fc.bias


def _loss(logits: torch.Tensor, labels: torch.Tensor, cfg: ClsConfig) -> torch.Tensor:
    if cfg.multilabel:
        return multilabel_soft_margin_loss(logits, labels)
    logp = F.log_softmax(logits.float(), dim=-1)
    if cfg.label_smoothing > 0:
        C = logits.shape[-1]
        target = F.one_hot(labels.long(), C) * (1 - cfg.label_smoothing) + cfg.label_smoothing / C
        return -(target * logp).sum(-1).mean()
    return -logp.gather(1, labels.long().view(-1, 1)).mean()


def cls_train_step(
    state: ClsTrainState,
    images: torch.Tensor,  # (B, S, S, 3) normalized
    labels: torch.Tensor,  # (B,) int or (B, C) multi-hot
    lr: float,
    weight_decay: float,
    cfg: ClsConfig,
) -> Dict:
    """One optimizer step, in place. Returns metrics; loss and accuracy stay
    device tensors (reading them syncs the host)."""
    model = state.model
    params = dict(model.named_parameters())
    frozen = (optim.path_mask(params, lambda n: n.startswith("backbone"))
              if cfg.freeze_backbone else None)
    live = [n for n in params if not (frozen and frozen[n])]
    logits = cls_logits(model, images, cfg, True, state.generator)
    loss = _loss(logits, labels, cfg)
    grads = torch.autograd.grad(loss, [params[n] for n in live],
                                allow_unused=True, materialize_grads=True)
    _, opt_update = optim.OPTIMIZERS[cfg.optimizer]
    opt_update(dict(zip(live, grads)), state.opt_state, params, lr, weight_decay,
               optim.wd_mask(params), frozen_mask=frozen)
    state.step += 1
    logits = logits.detach()
    if cfg.multilabel:
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
    else:
        acc = (logits.argmax(-1) == labels).float().mean()
    return {"loss": loss.detach(), "acc": acc, "lr": lr}


@torch.no_grad()
def cls_predict(model: nn.ModuleDict, images: torch.Tensor, cfg: ClsConfig) -> torch.Tensor:
    """Eval-mode logits (B, C): BatchNorm by its running statistics."""
    return cls_logits(model, images, cfg)
