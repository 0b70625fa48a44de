"""Segmentation losses over NHWC logits, and the multi-label loss.

Counterpart of ``dinomc_tpu/objectives/segmentation.py`` (reference
``utils/loss.py``): pixel cross-entropy with ``ignore_index`` and the
``DiceCrossEntropyLoss`` of the seg fine-tune (``utils/loss.py:175-199``),
logits (B, H, W, C) and targets (B, H, W) integers as in the JAX package;
OSCD's binary ``dice_bce_loss``; the soft-IoU losses ``miou_loss``,
``mmiou_loss`` and ``liou_loss``; and the classification step's
``multilabel_soft_margin_loss``. All in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Mean CE over the valid positions (torch ``CrossEntropyLoss``
    semantics), in f32."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = target.long().clamp(0, num_classes - 1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    w = torch.ones_like(picked)
    if ignore_index is not None:
        w = (target != ignore_index).float()
    return -(picked * w).sum() / w.sum().clamp_min(1e-12)


def soft_dice_loss_per_class(
    probs: torch.Tensor, one_hot: torch.Tensor, smooth: float = 1e-5,
) -> torch.Tensor:
    """1 - mean dice over (B, C), each dice over the spatial dims."""
    inter = (probs * one_hot).sum(dim=(1, 2))
    union = probs.sum(dim=(1, 2)) + one_hot.sum(dim=(1, 2))
    return 1.0 - ((2.0 * inter + smooth) / (union + smooth)).mean()


def dice_ce_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Cross-entropy plus soft dice; ignored pixels leave the dice's one-hot."""
    num_classes = logits.shape[-1]
    ce = cross_entropy_loss(logits, target, ignore_index)
    probs = torch.softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(target.long().clamp(0, num_classes - 1), num_classes).float()
    if ignore_index is not None:
        one_hot = one_hot * (target != ignore_index)[..., None]
    return ce + soft_dice_loss_per_class(probs, one_hot)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on raw logits, in the stable form
    ``max(x, 0) - x * t + log1p(exp(-|x|))``, in f32."""
    logits, target = logits.float(), target.float()
    return (logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))).mean()


def dice_bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """OSCD's binary loss (``utils/loss.py:15-43``) on raw logits and {0, 1}
    targets of one shape: (0.5 * BCEWithLogits + 0.5 * (1 - soft dice over
    the whole batch)) * 2, the dice unsmoothed as in the reference."""
    logits, target = logits.float(), target.float()
    probs = torch.sigmoid(logits)
    bce = bce_with_logits(logits, target)
    dice = 2.0 * (probs * target).sum() / (target.sum() + probs.sum()).clamp_min(1e-12)
    return (0.5 * bce + 0.5 * (1.0 - dice)) * 2.0


def _soft_iou_per_class(probs: torch.Tensor, one_hot: torch.Tensor) -> torch.Tensor:
    """(B, C) soft IoU of (B, H, W, C) inputs: inter / (a + b - ab), summed
    over the pixels."""
    B, C = probs.shape[0], probs.shape[-1]
    inter = (probs * one_hot).reshape(B, -1, C).sum(dim=1)
    union = (probs + one_hot - probs * one_hot).reshape(B, -1, C).sum(dim=1)
    return inter / (union + 1e-8)


def _one_hot(target: torch.Tensor, C: int) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, C) gives a zero row."""
    return (target.long()[..., None] == torch.arange(C, device=target.device)).float()


def miou_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mIoULoss (``utils/loss.py:99-134``): minus the mean soft IoU of the
    softmax probabilities."""
    C = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    return -_soft_iou_per_class(probs, _one_hot(target, C)).mean()


def mmiou_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Minimax mmIoULoss (``utils/loss.py:136-172``): minus the least and the
    mean soft IoU. The reference has the softmax commented out, so the raw
    inputs are used, as in the JAX package."""
    iou = _soft_iou_per_class(logits.float(), _one_hot(target, logits.shape[-1]))
    return -iou.min() - iou.mean()


def liou_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``liou_loss`` (``utils/loss.py:46-84``): -log of the least soft IoU
    over the (batch, class) matrix of softmax probabilities. The reference
    trainers define it and never call it."""
    C = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    return -torch.log(_soft_iou_per_class(probs, _one_hot(target, C)).min())


def multilabel_soft_margin_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.MultiLabelSoftMarginLoss`` (``main_bigearthnet.py``): the
    batch mean of the class mean of -[y log s(x) + (1 - y) log s(-x)],
    logits (B, C), targets (B, C) in {0, 1}, in f32."""
    logits, target = logits.float(), target.float()
    per_class = -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits))
    return per_class.mean(dim=1).mean()
