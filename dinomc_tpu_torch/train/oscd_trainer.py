"""OSCD change-detection training step, in PyTorch.

Counterpart of ``dinomc_tpu/train/oscd_trainer.py``; parity target the
reference ``SiamSegment`` LightningModule (``main_oscd.py:28-104``): a
frozen siamese encoder (the optimizer holds the decoder only, ``:100-104``),
BCE-with-logits or ``dice_bce`` (``:36``), Adam with ExponentialLR(0.95) an
epoch, and binary precision / recall / F1 / IoU at a 0.5 sigmoid threshold.
Adam is ``optim.adamw_update`` with weight decay 0 and the frozen mask, as
in the JAX package. The step updates ``OSCDTrainState`` in place:
parameters, the encoder's BatchNorm statistics when it trains, Adam's state
and the step counter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from dinomc_tpu_torch.models.siamese import Siamese, SiameseConfig, siamese_forward
from dinomc_tpu_torch.objectives.segmentation import bce_with_logits, dice_bce_loss
from dinomc_tpu_torch.train import optim
from dinomc_tpu_torch.train.dino_trainer import set_matmul_precision


@dataclasses.dataclass(frozen=True)
class OSCDConfig:
    model: SiameseConfig = SiameseConfig()
    loss: str = "bce"  # 'bce' | 'dice_bce'

    def frozen_pred(self, name: str) -> bool:
        return self.model.freeze_encoder and name.startswith("encoder")


@dataclasses.dataclass
class OSCDTrainState:
    """Train state, updated in place by ``oscd_train_step``. The generator
    draws nothing (the JAX state's ``rng`` is unused too); it keeps the
    checkpoint layout of the other train states."""

    step: int
    model: Siamese
    opt_state: Dict
    generator: torch.Generator


def exponential_lr(base_lr: float, epoch: int, gamma: float = 0.95) -> float:
    """torch ``ExponentialLR`` (``main_oscd.py``)."""
    return base_lr * (gamma**epoch)


def init_oscd_train_state(
    cfg: OSCDConfig,
    seed: int = 0,
    device="cpu",
    pretrained_encoder: Optional[Dict[str, torch.Tensor]] = None,
) -> OSCDTrainState:
    """Model initialized on the CPU from ``seed``, the encoder optionally
    replaced by ``pretrained_encoder`` (a ResNet state dict with its
    BatchNorm statistics, loaded strictly), then moved to ``device``."""
    set_matmul_precision()
    model = Siamese(cfg.model, torch.Generator().manual_seed(seed))
    if pretrained_encoder is not None:
        model.encoder.load_state_dict(pretrained_encoder, strict=True)
    model = model.to(device)
    return OSCDTrainState(
        step=0,
        model=model,
        opt_state=optim.adamw_init(dict(model.named_parameters())),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )


def oscd_train_step(
    state: OSCDTrainState,
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,  # (B, H, W) in {0, 1}
    lr: float,
    cfg: OSCDConfig,
) -> Dict[str, torch.Tensor]:
    """One Adam step. Returns the loss and the batch's precision, recall, F1
    and IoU at 0.5 as device tensors (reading them syncs the host)."""
    params = dict(state.model.named_parameters())
    live = [n for n in params if not cfg.frozen_pred(n)]
    logits = siamese_forward(state.model, x1, x2, train=True)
    mask = mask.float()
    loss = dice_bce_loss(logits, mask) if cfg.loss == "dice_bce" else bce_with_logits(logits, mask)
    grads = torch.autograd.grad(loss, [params[n] for n in live], allow_unused=True,
                                materialize_grads=True)
    optim.adamw_update(
        dict(zip(live, grads)), state.opt_state, params, lr, 0.0, optim.wd_mask(params),
        frozen_mask=optim.path_mask(params, cfg.frozen_pred),
    )
    state.step += 1
    with torch.no_grad():
        pred = (torch.sigmoid(logits) > 0.5).float()
        tp = (pred * mask).sum()
        precision = tp / pred.sum().clamp_min(1.0)
        recall = tp / mask.sum().clamp_min(1.0)
        f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-12)
        # binary Jaccard on the same threshold (reference main_oscd.py:41)
        iou = tp / (pred.sum() + mask.sum() - tp).clamp_min(1.0)
    return {"loss": loss.detach(), "precision": precision, "recall": recall, "f1": f1,
            "iou": iou}


@torch.no_grad()
def oscd_predict(model: Siamese, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Eval-mode change logits (B, H, W): running statistics, not moved."""
    return siamese_forward(model, x1, x2, train=False)
