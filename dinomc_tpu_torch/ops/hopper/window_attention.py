"""Swin window attention: the CUDA kernels K7 (forward) and K8 (backward)
in ``csrc/window_attention.cu``, and their plain PyTorch version.

Counterpart of ``dinomc_tpu/ops/pallas/window_attention.py``
(``packed_window_attention``, ``variant='perhead'``). The function is per
window softmax(Q K^T / sqrt(hd) + bias[h] + mask[w mod nW]) V over 49-token
windows, heads of 32 channels. The TPU kernel packed G windows into one
score product behind a block-diagonal mask; the CUDA kernels compute one
window and one head at a time, so nothing of that packing (``pick_group``,
the rank-49 augmentation) is kept. The backward's dbias comes from per-block
partials summed in a fixed order (no atomics) and stays in f32; the TPU
kernel rounds dS to bf16 before summing it.

``window_attention`` launches the kernels for CUDA tensors (bf16 q/k/v
only) and runs ``window_attention_reference`` for CPU tensors; there is no
fallback between the two on a CUDA tensor. The relative-position gather
``table[index]`` stays a PyTorch op in the caller, so the table's gradient
comes from autograd through the gather.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from dinomc_tpu_torch.ops.hopper import _build

WINDOW_TOKENS = 49  # a 7 x 7 window
HEAD_DIM = 32
BLOCKS_PER_SM = 4  # blocks the window range is cut into, per SM


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


def _kernel_args(q, k, v, bias, mask, heads: int):
    """Validate the kernels' inputs; returns (q, k, v, bias, mask, geometry)
    with geometry = (nB, nW, mask_rows, wpc, sw, sn), copying q/k/v only
    when they do not share a kernel-readable layout."""
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
    blocks = BLOCKS_PER_SM * _sm_count(q.device.index or 0)
    wpc = max(1, -(-nB * heads // blocks))
    return q, k, v, bias.contiguous(), mask, (nB, nW, mask_rows, wpc) + q.stride()[:2]


def window_attention_fwd(q, k, v, bias, mask, heads: int) -> torch.Tensor:
    """K7: returns o, (nB, 49, C) bf16 contiguous."""
    q, k, v, bias, mask, (nB, nW, mask_rows, wpc, sw, sn) = _kernel_args(q, k, v, bias, mask, heads)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.library().dinomc_win_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        nB, heads, nW, mask_rows, wpc, sw, sn, o.stride(0), o.stride(1),
        1.0 / math.sqrt(HEAD_DIM), _build.stream_handle(q),
    )
    _build.check(err, "window attention forward")
    _build.LAUNCHES["window_attention_fwd"] += 1
    return o


def window_attention_bwd(q, k, v, bias, mask, do, heads: int):
    """K8 (and its fixed-order dbias reduction): returns (dq, dk, dv), each
    (nB, 49, C) bf16 contiguous, and dbias (heads, 49, 49) f32."""
    q, k, v, bias, mask, (nB, nW, mask_rows, wpc, sw, sn) = _kernel_args(q, k, v, bias, mask, heads)
    do = do.to(torch.bfloat16).contiguous()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    part = torch.empty((-(-nB // wpc), heads, WINDOW_TOKENS, WINDOW_TOKENS),
                       dtype=torch.float32, device=q.device)
    dbias = torch.empty((heads, WINDOW_TOKENS, WINDOW_TOKENS), dtype=torch.float32, device=q.device)
    err = _build.library().dinomc_win_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), part.data_ptr(), dbias.data_ptr(), nB, heads, nW, mask_rows,
        wpc, sw, sn, do.stride(0), do.stride(1), 1.0 / math.sqrt(HEAD_DIM),
        _build.stream_handle(q),
    )
    _build.check(err, "window attention backward")
    _build.LAUNCHES["window_attention_bwd"] += 1
    return dq, dk, dv, dbias


class WindowAttention(torch.autograd.Function):
    """Autograd wrapper: K7 forward, K8 backward. Saves q, k, v, bias and
    the mask; P is recomputed in the backward. The mask is a constant."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, heads):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.heads = heads
        return window_attention_fwd(q, k, v, bias, mask, heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, bias, mask, do, ctx.heads)
        return dq, dk, dv, dbias, None, None


def window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    mask: Optional[torch.Tensor], heads: int,
) -> torch.Tensor:
    """Window attention over q, k, v (nB, 49, heads * 32) with the relative
    bias (heads, 49, 49) f32 and an optional (nW, 49 or 1, 49) f32 mask for
    window ``w mod nW``. CUDA tensors go through the kernels (bf16 only);
    CPU tensors through ``window_attention_reference``."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask, heads)
    return WindowAttention.apply(q, k, v, bias, mask, int(heads))
