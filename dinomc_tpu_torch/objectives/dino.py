"""DINO loss with teacher centering.

Counterpart of ``dinomc_tpu/objectives/dino.py``; parity target the
reference ``DINOLoss`` (``main_dino_mc.py:419-473``): student log-softmax at
``student_temp``, teacher softmax of (logits - center) / teacher_temp,
cross-entropy over every (teacher view, student view) pair except the
same-view pairs, averaged over pairs; the center moves by EMA toward the
batch mean of the teacher logits. A pure function: the trainer stores the
returned center.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def dino_loss(
    student_logits: torch.Tensor,  # (n_crops, B, K) f32
    teacher_logits: torch.Tensor,  # (n_globals, B, K) f32
    center: torch.Tensor,  # (K,) f32
    teacher_temp: float,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scalar loss, updated center); the center carries no grad."""
    n_crops, B = student_logits.shape[:2]
    n_globals = teacher_logits.shape[0]
    teacher_logits = teacher_logits.detach()
    student_logp = F.log_softmax(student_logits / student_temp, dim=-1)
    teacher_q = F.softmax((teacher_logits - center) / teacher_temp, dim=-1)
    pair_ce = -torch.einsum("ibk,jbk->ij", teacher_q, student_logp) / B
    mask = 1.0 - torch.eye(n_globals, n_crops, device=pair_ce.device)
    n_terms = n_globals * n_crops - min(n_globals, n_crops)
    loss = (pair_ce * mask).sum() / n_terms
    with torch.no_grad():
        batch_center = teacher_logits.reshape(-1, teacher_logits.shape[-1]).mean(dim=0)
        new_center = center * center_momentum + batch_center * (1.0 - center_momentum)
    return loss, new_center
