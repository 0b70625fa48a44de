"""Swin window attention: the CUDA kernels K7 (forward) and K8 (backward)
in ``csrc/window_attention.cu``, their head-stacked variant K9 (forward) and
K10 (backward) in ``csrc/window_attention_stacked.cu``, and the plain
PyTorch version of all four.

Counterpart of ``dinomc_tpu/ops/pallas/window_attention.py``
(``packed_window_attention``, ``variant='perhead'`` and ``'stacked'``). The
function is per window softmax(Q K^T / sqrt(hd) + bias[h] + mask[w mod nW])
V over 49-token windows, heads of 32 channels; the two variants compute the
same function. The TPU kernel packed G windows into one score product behind
a block-diagonal mask; the CUDA kernels compute one window at a time, so
nothing of that packing (``pick_group``, the rank-49 augmentation, the
stacked variant's block-stacked K'/V' operands) is kept. All four run on
wgmma and TMA (``csrc/hopper_window.cuh``): the forwards on
``window_fwd_block``, the backwards on ``window_bwd_block``, one consumer
warpgroup a head. K7/K8 give a block one head over many windows; K9/K10 give
a block a chunk of heads of each of its windows (``STACKED_HEADS``), whose
mask and loads one producer warp serves. Every kernel reads Swin's q/k/v
column slices through one tensor map over the qkv tensor and sizes its grid
to one wave of resident blocks.
The backward's dbias comes from per-block partials summed in a fixed order
(no atomics) and stays in f32; the TPU kernels round dS to bf16 before
summing it.

``window_attention`` launches the kernels of its ``variant`` for CUDA
tensors (bf16 q/k/v only) and runs ``window_attention_reference`` for CPU
tensors; there is no fallback between the two on a CUDA tensor. The
relative-position gather ``table[index]`` stays a PyTorch op in the caller,
so the table's gradient comes from autograd through the gather.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from dinomc_tpu_torch.ops.hopper import _build

WINDOW_TOKENS = 49  # a 7 x 7 window
HEAD_DIM = 32
# Most heads a block of K9 / K10 takes (csrc/window_attention_stacked.cu
# instantiates K9 for 1, 2, 3, 4 and 6 heads, K10 for 1 to 3: what fits in
# shared memory), each timed against the others by
# scripts/attention_variants.py (PERF.md): K9's 1, 3 and 6 tie over a
# Swin-T step's stages, and 3 is the fastest at stage 1.
STACKED_HEADS = {"fwd": 3, "bwd": 3}


def window_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    mask: Optional[torch.Tensor], heads: int,
) -> torch.Tensor:
    """Plain version of the kernels (the einsum form of the JAX package's
    ``models/swin._window_attention``): f32 scores plus the (heads, N, N)
    bias and the (nW, N or 1, N) mask of window ``w mod nW``, f32 softmax,
    probabilities rounded to the input dtype before the PV product, output
    in the input dtype. q, k, v (nB, N, C) -> (nB, N, C)."""
    nB, N, C = q.shape
    hd = C // heads
    qh, kh, vh = (x.float().reshape(nB, N, heads, hd) for x in (q, k, v))
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(hd) + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(nB // nW, nW, heads, N, N) + mask[:, None]).reshape(nB, heads, N, N)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", p.float(), vh)
    return out.reshape(nB, N, C).to(q.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_args(q, k, v, bias, mask, heads: int, chunks: int, per_sm: int):
    """Validate the kernels' inputs; returns (q, k, v, bias, mask, geometry)
    with geometry = (nB, nW, mask_rows, wpc, sw, sn), copying q/k/v only
    when they do not share a kernel-readable layout. ``chunks``: the blocks
    a window's heads take (``heads`` for K7/K8, one a head); ``per_sm``:
    the blocks an SM holds at once, so the grid is one wave."""
    name = "window_attention"
    _build.require_cuda(name, q, k, v, bias, *(() if mask is None else (mask,)))
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16 q/k/v (got {q.dtype})")
    if bias.dtype != torch.float32 or (mask is not None and mask.dtype != torch.float32):
        raise TypeError(f"{name} kernel takes an f32 bias and mask")
    nB, N, C = q.shape
    if not (q.shape == k.shape == v.shape) or N != WINDOW_TOKENS or C != heads * HEAD_DIM:
        raise ValueError(f"{name}: q/k/v must share one (nB, {WINDOW_TOKENS}, heads*{HEAD_DIM}) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if bias.shape != (heads, N, N):
        raise ValueError(f"{name}: bias must be ({heads}, {N}, {N}), got {tuple(bias.shape)}")
    nW, mask_rows = 1, 1
    if mask is not None:
        nW, mask_rows = mask.shape[0], mask.shape[1]
        if mask.shape[2] != N or mask_rows not in (1, N) or nB % nW:
            raise ValueError(f"{name}: mask must be (nW, {N} or 1, {N}) with nW | {nB}, "
                             f"got {tuple(mask.shape)}")
        mask = mask.contiguous()
    ok = (
        q.stride() == k.stride() == v.stride()
        and q.stride(-1) == 1
        and all(s % 8 == 0 for s in q.stride()[:2])
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    )
    if not ok:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    blocks = per_sm * _sm_count(q.device.index or 0)
    wpc = max(1, -(-nB * chunks // blocks))
    return q, k, v, bias.contiguous(), mask, (nB, nW, mask_rows, wpc) + q.stride()[:2]


@functools.cache
def _per_sm(entry: str, index: int, *hc: int) -> int:
    """Blocks that one SM of device ``index`` holds at once of the kernel
    whose occupancy the C function ``entry`` reports (with ``hc`` heads a
    block for K9 / K10)."""
    n = getattr(_build.library(), entry)(*hc, index)
    if n <= 0:
        raise RuntimeError(f"window attention ({entry}{hc or ''}): no block fits an SM "
                           f"(CUDA error {-n})")
    return n


def window_attention_fwd(q, k, v, bias, mask, heads: int) -> torch.Tensor:
    """K7: returns o, (nB, 49, C) bf16 contiguous. The windows are cut into
    one wave of resident blocks."""
    _build.require_cuda("window_attention", q)
    per_sm = _per_sm("dinomc_win_attn_fwd_per_sm", q.device.index or 0)
    q, k, v, bias, mask, (nB, nW, mask_rows, wpc, sw, sn) = _kernel_args(
        q, k, v, bias, mask, heads, heads, per_sm)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.library().dinomc_win_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        nB, heads, nW, mask_rows, wpc, sw, sn, 1.0 / math.sqrt(HEAD_DIM),
        _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "window attention forward")
    _build.LAUNCHES["window_attention_fwd"] += 1
    return o


def window_attention_bwd(q, k, v, bias, mask, do, heads: int):
    """K8 (and its fixed-order dbias reduction): returns (dq, dk, dv), each
    (nB, 49, C) bf16, the column slices of one (nB, 49, 3C) buffer, and
    dbias (heads, 49, 49) f32. The windows are cut into one wave of resident
    blocks."""
    _build.require_cuda("window_attention", q)
    per_sm = _per_sm("dinomc_win_attn_bwd_per_sm", q.device.index or 0)
    q, k, v, bias, mask, (nB, nW, mask_rows, wpc, sw, sn) = _kernel_args(
        q, k, v, bias, mask, heads, heads, per_sm)
    do = do.to(torch.bfloat16).contiguous()
    C = q.shape[-1]
    grads = torch.empty((nB, WINDOW_TOKENS, 3 * C), dtype=q.dtype, device=q.device)
    dq, dk, dv = grads[..., :C], grads[..., C:2 * C], grads[..., 2 * C:]
    part = torch.empty((-(-nB // wpc), heads, WINDOW_TOKENS, WINDOW_TOKENS),
                       dtype=torch.float32, device=q.device)
    dbias = torch.empty((heads, WINDOW_TOKENS, WINDOW_TOKENS), dtype=torch.float32, device=q.device)
    err = _build.library().dinomc_win_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), part.data_ptr(), dbias.data_ptr(), nB, heads, nW, mask_rows,
        wpc, sw, sn, grads.stride(0), grads.stride(1), 1.0 / math.sqrt(HEAD_DIM),
        _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "window attention backward")
    _build.LAUNCHES["window_attention_bwd"] += 1
    return dq, dk, dv, dbias


def head_chunk(heads: int, most: int) -> int:
    """Heads a block of K9 / K10 takes: the largest divisor of ``heads`` that
    is at most ``most``."""
    return max(d for d in range(1, min(heads, most) + 1) if heads % d == 0)


def window_attention_stacked_fwd(q, k, v, bias, mask, heads: int) -> torch.Tensor:
    """K9: returns o, (nB, 49, C) bf16 contiguous. A block takes
    ``head_chunk(heads, STACKED_HEADS["fwd"])`` heads; the windows are cut
    into one wave of resident blocks."""
    hc = head_chunk(heads, STACKED_HEADS["fwd"])
    _build.require_cuda("window_attention", q)
    per_sm = _per_sm("dinomc_wins_attn_fwd_per_sm", q.device.index or 0, hc)
    q, k, v, bias, mask, (nB, nW, mask_rows, wpc, sw, sn) = _kernel_args(
        q, k, v, bias, mask, heads, heads // hc, per_sm)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.library().dinomc_wins_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        nB, heads, hc, nW, mask_rows, wpc, sw, sn, 1.0 / math.sqrt(HEAD_DIM),
        _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "stacked window attention forward")
    _build.LAUNCHES["window_attention_stacked_fwd"] += 1
    return o


def window_attention_stacked_bwd(q, k, v, bias, mask, do, heads: int):
    """K10 (and its fixed-order dbias reduction): returns (dq, dk, dv), each
    (nB, 49, C) bf16, the column slices of one (nB, 49, 3C) buffer, and
    dbias (heads, 49, 49) f32. A block takes
    ``head_chunk(heads, STACKED_HEADS["bwd"])`` heads; the windows are cut
    into one wave of resident blocks."""
    hc = head_chunk(heads, STACKED_HEADS["bwd"])
    _build.require_cuda("window_attention", q)
    per_sm = _per_sm("dinomc_wins_attn_bwd_per_sm", q.device.index or 0, hc)
    q, k, v, bias, mask, (nB, nW, mask_rows, wpc, sw, sn) = _kernel_args(
        q, k, v, bias, mask, heads, heads // hc, per_sm)
    do = do.to(torch.bfloat16).contiguous()
    C = q.shape[-1]
    grads = torch.empty((nB, WINDOW_TOKENS, 3 * C), dtype=q.dtype, device=q.device)
    dq, dk, dv = grads[..., :C], grads[..., C:2 * C], grads[..., 2 * C:]
    part = torch.empty((-(-nB // wpc), heads, WINDOW_TOKENS, WINDOW_TOKENS),
                       dtype=torch.float32, device=q.device)
    dbias = torch.empty((heads, WINDOW_TOKENS, WINDOW_TOKENS), dtype=torch.float32, device=q.device)
    err = _build.library().dinomc_wins_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), part.data_ptr(), dbias.data_ptr(), nB, heads, hc, nW, mask_rows,
        wpc, sw, sn, grads.stride(0), grads.stride(1), 1.0 / math.sqrt(HEAD_DIM),
        _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "stacked window attention backward")
    _build.LAUNCHES["window_attention_stacked_bwd"] += 1
    return dq, dk, dv, dbias


_VARIANTS = {  # variant -> (forward, backward) launchers
    "perhead": (window_attention_fwd, window_attention_bwd),
    "stacked": (window_attention_stacked_fwd, window_attention_stacked_bwd),
}


class WindowAttention(torch.autograd.Function):
    """Autograd wrapper: K7 forward and K8 backward, or K9 and K10 for
    ``variant='stacked'``. Saves q, k, v, bias and the mask; P is
    recomputed in the backward. The mask is a constant."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, heads, variant="perhead"):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.heads, ctx.variant = heads, variant
        return _VARIANTS[variant][0](q, k, v, bias, mask, heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = _VARIANTS[ctx.variant][1](q, k, v, bias, mask, do, ctx.heads)
        return dq, dk, dv, dbias, None, None, None


def window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    mask: Optional[torch.Tensor], heads: int, variant: str = "perhead",
) -> torch.Tensor:
    """Window attention over q, k, v (nB, 49, heads * 32) with the relative
    bias (heads, 49, 49) f32 and an optional (nW, 49 or 1, 49) f32 mask for
    window ``w mod nW``. CUDA tensors go through the kernels of ``variant``
    (``'perhead'``: K7/K8, ``'stacked'``: K9/K10; bf16 only); CPU tensors
    through ``window_attention_reference``, the plain version of both."""
    if variant not in _VARIANTS:
        raise ValueError(f"window_attention variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask, heads)
    return WindowAttention.apply(q, k, v, bias, mask, int(heads), variant)
