"""AdamW, SGD, LARS and gradient transforms for the trainers.

Counterpart of ``dinomc_tpu/train/optim.py``. Parameters,
gradients, masks and moments are dictionaries keyed by the student's
parameter names (``backbone.blocks.0.attn.qkv.weight``, ...). Semantics are
the JAX package's:

  * two param groups: bias / 1-D leaves get no weight decay
    (``get_params_groups``, ``utils/utils.py:649-660``);
  * **per-tensor** clipping by min(1, clip / (||g|| + 1e-6))
    (``clip_gradients``, ``utils/utils.py:145-154``);
  * torch AdamW with per-parameter step counts; a frozen parameter (the
    weight-norm ``g`` under ``norm_last_layer``, the last layer during the
    freeze epochs) is skipped entirely, as torch skips a ``grad is None``
    parameter: value, moments and step count stay as they are.

The JAX package stacks the ViT's blocks along a leading depth axis, and
both rules act on its leaves (``stacked_name``): one joint norm clips all
blocks' copies of a tensor, and a block's LayerNorm scale, one row of a
(depth, D) leaf, is decayed. The port keeps one tensor per block, as the
reference's state dict does, and applies the rules to the stacked groups;
LARS's trust ratio likewise takes the joint norm of a group.

Unlike the functional JAX version, ``clip_gradients_per_tensor`` and the
updates change their tensors in place under ``torch.no_grad()``.

On sharded tensors (``core/mesh.py``: a rank holds one block of a split
tensor's gradient, moments and parameter) AdamW, SGD and LARS update each
block where it lies. The joint norms of clipping and of LARS's trust ratio
take a ``sq_reduce`` hook: it receives each tensor's local sum of squares
and returns them with every split tensor's summed over its blocks (an
all-reduce), so a group's norm is the square root of the shards' squared
norms summed.
``OPTIMIZERS`` maps a name to (init, update), as in JAX.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


_BLOCK = re.compile(r"\.blocks\.\d+\.")


def stacked_name(name: str) -> str:
    """The JAX package's leaf that holds this tensor: every block's copy of
    a tensor is one slice of a leaf stacked along the depth axis
    (``backbone.blocks.3.norm1.weight`` -> ``backbone.blocks.*.norm1.weight``)."""
    return _BLOCK.sub(".blocks.*.", name)


def _groups(names) -> Dict[str, List[str]]:
    """Parameter names by the JAX package's leaf (``stacked_name``)."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        groups.setdefault(stacked_name(name), []).append(name)
    return groups


def wd_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """1.0 for regularized leaves, 0.0 for ``*.bias`` and 1-D leaves, the
    rank taken of the stacked leaf (a block's tensor gains the depth axis)."""

    def ndim(name, p):
        return p.ndim + (stacked_name(name) != name)

    return {
        name: 0.0 if (name.endswith("bias") or ndim(name, p) <= 1) else 1.0
        for name, p in params.items()
    }


def path_mask(params: Mapping[str, torch.Tensor], pred: Callable[[str], bool]) -> Dict[str, float]:
    """1.0 where the parameter name satisfies ``pred``, else 0.0."""
    return {name: 1.0 if pred(name) else 0.0 for name in params}


SqReduce = Optional[Callable[[Tensors], Tensors]]


def _sq_sums(tensors: Mapping[str, torch.Tensor], sq_reduce: SqReduce) -> Tensors:
    """Each tensor's f32 sum of squares, summed over its shards by
    ``sq_reduce`` where given. Sums of squares, not vector_norm: torch's CPU
    norm kernel drifts by ~1e-4 relative over a 4M-element tensor in
    float32; sum does not."""
    sq = {n: t.float().square().sum() for n, t in tensors.items()}
    return sq_reduce(sq) if sq_reduce is not None else sq


@torch.no_grad()
def clip_gradients_per_tensor(grads: Tensors, clip: float, sq_reduce: SqReduce = None) -> Tensors:
    """Scale each stacked leaf's gradients in place by
    min(1, clip / (||g|| + 1e-6)), ||g|| the norm over all of the leaf's
    tensors (over all their shards, with ``sq_reduce``). No host sync: the
    coefficient stays on the device."""
    sq = _sq_sums(grads, sq_reduce)
    for names in _groups(grads).values():
        norm = torch.stack([sq[n] for n in names]).sum().sqrt()
        coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
        for n in names:
            grads[n].mul_(coef.to(grads[n].dtype))
    return grads


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Zero f32 moments and a zero step count per parameter."""
    return {
        "mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "count": {n: 0 for n in params},
    }


@torch.no_grad()
def adamw_update(
    grads: Tensors,
    state: Dict[str, Dict],
    params: Mapping[str, torch.Tensor],
    lr: float,
    weight_decay: float,
    wd_mask_tree: Mapping[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    frozen_mask: Optional[Mapping[str, float]] = None,
    sq_reduce: SqReduce = None,
) -> None:
    """Torch-AdamW: p -= lr * (mhat / (sqrt(vhat) + eps) + wd * mask * p),
    in place on ``params`` and ``state``. ``frozen_mask`` (1.0 = frozen)
    skips a parameter entirely. Bias corrections are computed on the host
    in f32 from the per-parameter step count."""
    one = np.float32(1.0)
    for name, p in params.items():
        if frozen_mask is not None and frozen_mask[name] > 0.5:
            continue
        g = grads[name].float()
        m, v = state["mu"][name], state["nu"][name]
        c = state["count"][name] + 1
        state["count"][name] = c
        m.add_((g - m) * (1 - b1))
        v.add_((g * g - v) * (1 - b2))
        bc1 = float(one - np.float32(b1) ** np.float32(c))
        bc2 = float(one - np.float32(b2) ** np.float32(c))
        upd = (m / bc1) / ((v / bc2).sqrt_().add_(eps))
        if wd_mask_tree[name] and weight_decay:
            upd.add_(p.float(), alpha=weight_decay)
        p.sub_((upd * lr).to(p.dtype))


def sgd_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Zero f32 momentum buffers per parameter."""
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}}


@torch.no_grad()
def sgd_update(
    grads: Tensors,
    state: Dict[str, Dict],
    params: Mapping[str, torch.Tensor],
    lr: float,
    weight_decay: float,
    wd_mask_tree: Mapping[str, float],
    momentum: float = 0.9,
    frozen_mask: Optional[Mapping[str, float]] = None,
    sq_reduce: SqReduce = None,
) -> None:
    """Torch SGD with momentum (no dampening, no Nesterov):
    m = momentum * m + g + wd * mask * p, then p -= lr * m, in place. A
    frozen parameter (``frozen_mask`` 1.0) keeps its value and its buffer,
    as torch skips a parameter whose grad is None."""
    for name, p in params.items():
        if frozen_mask is not None and frozen_mask[name] > 0.5:
            continue
        g = grads[name].float()
        if wd_mask_tree[name] and weight_decay:
            g = g + weight_decay * p.float()
        m = state["mu"][name]
        m.mul_(momentum).add_(g)
        p.sub_((m * lr).to(p.dtype))


def lars_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Zero f32 momentum buffers per parameter."""
    return sgd_init(params)


@torch.no_grad()
def lars_update(
    grads: Tensors,
    state: Dict[str, Dict],
    params: Mapping[str, torch.Tensor],
    lr: float,
    weight_decay: float,
    wd_mask_tree: Mapping[str, float],
    momentum: float = 0.9,
    eta: float = 0.001,
    frozen_mask: Optional[Mapping[str, float]] = None,
    sq_reduce: SqReduce = None,
) -> None:
    """LARS, BarlowTwins flavour (reference ``utils/utils.py:570-608``), in
    place. On a regularized leaf (``wd_mask`` 1) the gradient gains
    wd * p and is scaled by the trust ratio eta * ||p|| / ||g + wd * p||
    (1 where either norm is 0), both norms over the whole stacked leaf; the
    others (bias and 1-D, the reference's ``exclude_bias_and_norm``) take the
    raw gradient. Then m = momentum * m + g and p -= lr * m. A frozen
    parameter keeps its value and its buffer. No host sync: the ratio stays
    on the device. ``sq_reduce``: as for ``clip_gradients_per_tensor``.
    (AdamW and SGD take it too, and need no norm.)"""
    for names in _groups(params).values():
        live = [n for n in names if not (frozen_mask is not None and frozen_mask[n] > 0.5)]
        if not live:
            continue
        gs = {n: grads[n].float() for n in names}
        if wd_mask_tree[names[0]]:
            gs = {n: g + weight_decay * params[n].float() for n, g in gs.items()}
            p_sq = _sq_sums({n: params[n] for n in names}, sq_reduce)
            g_sq = _sq_sums(gs, sq_reduce)
            p_norm = torch.stack([p_sq[n] for n in names]).sum().sqrt()
            g_norm = torch.stack([g_sq[n] for n in names]).sum().sqrt()
            q = torch.where((p_norm > 0) & (g_norm > 0), eta * p_norm / (g_norm + 1e-12),
                            torch.ones_like(p_norm))
            gs = {n: g * q for n, g in gs.items()}
        for n in live:
            m = state["mu"][n]
            m.mul_(momentum).add_(gs[n])
            params[n].sub_((m * lr).to(params[n].dtype))


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "sgd": (sgd_init, sgd_update),
    "lars": (lars_init, lars_update),
}
