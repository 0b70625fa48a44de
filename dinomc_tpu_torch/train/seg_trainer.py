"""Segmentation fine-tuning step (UPerNet on DINO features), in PyTorch.

Counterpart of ``dinomc_tpu/train/seg_trainer.py``; parity target the
reference ``train_model`` (``train_dino_mc_seg.py:27-208``): AdamW, the
DiceCrossEntropy loss on the decode logits (plus mmseg's 0.4-weighted
auxiliary CE with ``use_aux_loss``), and backbone or decoder freezing. A
frozen backbone is cut twice, as in the JAX package: the forward runs it
without autograd (``stop_backbone_grad``), so the backward never enters the
ViT, and the AdamW frozen mask leaves its parameters, moments and step
counts untouched. The step updates ``SegTrainState`` in place: parameters,
BatchNorm running statistics, AdamW state and the step counter.

``mesh`` (``core/mesh.py``; JAX ``seg_train_step``'s ``mesh``): with a
``seq`` axis > 1 the backbone runs sequence-parallel (``models/upernet.py``).
Every rank holds the whole batch and runs the decoder and the loss on it;
the gradients are summed over all ranks and divided by the world size (each
rank's backbone gradient covers its token and batch blocks; the decoder's is
the same on every rank), so every rank takes the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from dinomc_tpu_torch.models.upernet import UPerNet, UPerNetConfig, upernet_forward
from dinomc_tpu_torch.objectives.segmentation import cross_entropy_loss, dice_ce_loss
from dinomc_tpu_torch.parallel import distributed as pd
from dinomc_tpu_torch.train import optim
from dinomc_tpu_torch.train.dino_trainer import set_matmul_precision


@dataclasses.dataclass(frozen=True)
class SegConfig:
    model: UPerNetConfig = UPerNetConfig()
    train_backbone: bool = False
    train_decoder: bool = True
    use_aux_loss: bool = False
    ignore_index: Optional[int] = None

    def frozen_pred(self, name: str) -> bool:
        if not self.train_backbone and name.startswith("backbone"):
            return True
        if not self.train_decoder and not name.startswith("backbone"):
            return True
        return False


@dataclasses.dataclass
class SegTrainState:
    """Train state, updated in place by ``seg_train_step``."""

    step: int
    model: UPerNet
    opt_state: Dict
    generator: torch.Generator  # dropout draws, on the state's device


def init_seg_train_state(cfg: SegConfig, seed: int = 0, device="cpu") -> SegTrainState:
    """Model initialized on the CPU from ``seed`` (so every device starts
    from the same weights), then moved to ``device``."""
    set_matmul_precision()
    model = UPerNet(cfg.model, torch.Generator().manual_seed(seed)).to(device)
    return SegTrainState(
        step=0,
        model=model,
        opt_state=optim.adamw_init(dict(model.named_parameters())),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )


def seg_loss_and_grads(
    state: SegTrainState,
    images: torch.Tensor,  # (B, H, W, 3) normalized
    masks: torch.Tensor,  # (B, H, W) int
    cfg: SegConfig,
    drop_masks: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
):
    """Forward, loss and the gradients of every trainable parameter.
    Returns (loss, logits, {name: grad}); changes only the BatchNorm
    statistics and the dropout generator. ``mesh``: the gradients are the
    mean over its ranks."""
    model = state.model
    params = dict(model.named_parameters())
    live = [name for name in params if not cfg.frozen_pred(name)]
    out = upernet_forward(
        model, images, train=True, generator=state.generator, with_aux=cfg.use_aux_loss,
        stop_backbone_grad=not cfg.train_backbone, drop_masks=drop_masks, mesh=mesh,
    )
    logits = out[0] if cfg.use_aux_loss else out
    loss = dice_ce_loss(logits, masks, cfg.ignore_index)
    if cfg.use_aux_loss:
        loss = loss + cfg.model.aux_loss_weight * cross_entropy_loss(out[1], masks, cfg.ignore_index)
    # Parameters the loss does not reach (the unused auxiliary head, the
    # ViT's final norm) get zero gradients, as they do in JAX, so AdamW still
    # decays them.
    grads = torch.autograd.grad(
        loss, [params[n] for n in live], allow_unused=True, materialize_grads=True,
    ) if live else ()
    if grads and mesh is not None and mesh.active:
        flat = torch.cat([g.reshape(-1) for g in grads])
        pd.all_reduce_(flat).mul_(1.0 / mesh.world)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return loss.detach(), logits.detach(), dict(zip(live, grads))


def finish_seg_step(state: SegTrainState, grads, lr: float, weight_decay: float,
                    cfg: SegConfig) -> None:
    """Masked AdamW and the step count, in place."""
    params = dict(state.model.named_parameters())
    optim.adamw_update(
        grads, state.opt_state, params, lr, weight_decay, optim.wd_mask(params),
        frozen_mask=optim.path_mask(params, cfg.frozen_pred),
    )
    state.step += 1


def seg_train_step(
    state: SegTrainState,
    images: torch.Tensor,
    masks: torch.Tensor,
    lr: float,
    weight_decay: float,
    cfg: SegConfig,
    drop_masks: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Dict:
    """One optimizer step. Dropout masks come from ``drop_masks`` if given,
    else from ``state.generator``. Returns metrics; the loss and pixel
    accuracy stay device tensors (reading them syncs the host). ``mesh``:
    the sequence-parallel step (module docstring)."""
    loss, logits, grads = seg_loss_and_grads(state, images, masks, cfg, drop_masks, mesh)
    finish_seg_step(state, grads, lr, weight_decay, cfg)
    acc = (logits.argmax(-1) == masks).float().mean()
    return {"loss": loss, "pixel_acc": acc, "lr": lr}


@torch.no_grad()
def seg_predict(model: UPerNet, images: torch.Tensor, mesh=None) -> torch.Tensor:
    """Eval-mode logits (B, H, W, C), 'whole' test mode; ``mesh`` with a
    ``seq`` axis > 1 spreads the backbone's tokens over its ranks."""
    return upernet_forward(model, images, train=False, mesh=mesh)
