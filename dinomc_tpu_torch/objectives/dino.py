"""DINO loss with teacher centering.

Counterpart of ``dinomc_tpu/objectives/dino.py``; parity target the
reference ``DINOLoss`` (``main_dino_mc.py:419-473``): student log-softmax at
``student_temp``, teacher softmax of (logits - center) / teacher_temp,
cross-entropy over every (teacher view, student view) pair except the
same-view pairs, averaged over pairs; the center moves by EMA toward the
batch mean of the teacher logits. A pure function: the trainer stores the
returned center.

On a process mesh (``core/mesh.py``) the centre's batch mean is the global
batch's: each rank's mean is all-reduced over the data axis (the
reference's ``dist.all_reduce``, ``main_dino_mc.py:463-473``). Under head
tensor parallelism (model axis > 1) each rank holds the logits of its
out_dim block for the rows of its model group: the teacher softmax and the
student log-softmax become log-sum-exps over the model group (an
all-reduce of the row max, then of the sum of exponentials, differentiable
on the student side), and the cross-entropy's sum over out_dim is an
all-reduce, so every rank of a model group returns the group's loss.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dinomc_tpu_torch.parallel import distributed as pd


def dino_loss(
    student_logits: torch.Tensor,  # (n_crops, B, K) f32
    teacher_logits: torch.Tensor,  # (n_globals, B, K) f32
    center: torch.Tensor,  # (K,) f32
    teacher_temp: float,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scalar loss, updated center); the center carries no grad.
    On a ``mesh`` with a model axis, K is this rank's out_dim block and
    ``center`` its block of the centre."""
    n_crops, B = student_logits.shape[:2]
    n_globals = teacher_logits.shape[0]
    teacher_logits = teacher_logits.detach()
    tp = mesh is not None and mesh.size("model") > 1
    if tp:
        group = mesh.group("model")
        student_logp = _log_softmax_tp(student_logits / student_temp, group)
        with torch.no_grad():
            teacher_q = _log_softmax_tp((teacher_logits - center) / teacher_temp, group).exp()
    else:
        student_logp = F.log_softmax(student_logits / student_temp, dim=-1)
        teacher_q = F.softmax((teacher_logits - center) / teacher_temp, dim=-1)
    pair_ce = -torch.einsum("ibk,jbk->ij", teacher_q, student_logp) / B
    mask = 1.0 - torch.eye(n_globals, n_crops, device=pair_ce.device)
    n_terms = n_globals * n_crops - min(n_globals, n_crops)
    loss = (pair_ce * mask).sum() / n_terms
    if tp:
        loss = pd.all_reduce_sum(loss, group)
    with torch.no_grad():
        batch_center = teacher_logits.reshape(-1, teacher_logits.shape[-1]).mean(dim=0)
        if mesh is not None and mesh.active:
            batch_center = global_mean(batch_center, mesh)
        new_center = center * center_momentum + batch_center * (1.0 - center_momentum)
    return loss, new_center


def global_mean(local_mean: torch.Tensor, mesh) -> torch.Tensor:
    """The data axis's mean of per-rank means over equal row counts."""
    return mesh.reduce_(local_mean.clone(), "data") / mesh.size("data")


def _log_softmax_tp(x: torch.Tensor, group) -> torch.Tensor:
    """log-softmax over a last axis split across ``group``: the row max
    all-reduced (a constant shift, outside autograd), then the sum of
    exponentials, differentiably."""
    m = x.detach().amax(dim=-1, keepdim=True)
    pd.all_reduce_(m, group, dist.ReduceOp.MAX)
    z = x - m
    lse = pd.all_reduce_sum(z.exp().sum(dim=-1, keepdim=True), group).log()
    return z - lse
