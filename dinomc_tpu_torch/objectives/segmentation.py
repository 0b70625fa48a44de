"""Segmentation losses over NHWC logits, and the multi-label loss.

Counterpart of ``dinomc_tpu/objectives/segmentation.py`` (reference
``utils/loss.py``): pixel cross-entropy with ``ignore_index`` and the
``DiceCrossEntropyLoss`` of the seg fine-tune (``utils/loss.py:175-199``),
logits (B, H, W, C) and targets (B, H, W) integers as in the JAX package;
and the classification step's ``multilabel_soft_margin_loss``. The OSCD and
soft-IoU losses are not ported yet (ROADMAP.md queue 1 #16).
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


def multilabel_soft_margin_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.MultiLabelSoftMarginLoss`` (``main_bigearthnet.py``): the
    batch mean of the class mean of -[y log s(x) + (1 - y) log s(-x)],
    logits (B, C), targets (B, C) in {0, 1}, in f32."""
    logits, target = logits.float(), target.float()
    per_class = -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits))
    return per_class.mean(dim=1).mean()
