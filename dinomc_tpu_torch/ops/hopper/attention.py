"""Fused multi-head attention: the CUDA kernels K1 (forward) and K2
(backward) in ``csrc/attention.cu``, and their plain PyTorch version.

Counterpart of ``dinomc_tpu/ops/pallas/attention.py``. The kernels take
(B, N, h, d) bf16 tensors in place (the strided q/k/v views of a ViT's qkv
tensor), mask the ragged edge themselves and save the per-row log-sum-exp
for the backward. ``fused_mha`` launches them for CUDA tensors and runs
``fused_mha_reference`` for CPU tensors; there is no fallback between the
two on a CUDA tensor.
"""

from __future__ import annotations

import torch

from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.remat import kept

# The crop-packing planner's length bound, kept from the TPU kernel
# (ops/pallas/attention.py:45) so the same pairs form. The CUDA kernel tiles
# any N; re-tuning this bound for the card is later work.
LANE = 128
MAX_FUSED_LEN = 1024
HEAD_DIMS = (16, 32, 64)


def _pad_len(n: int) -> int:
    return -(-n // LANE) * LANE


def _live_mask(n: int, boundary: int, device) -> torch.Tensor:
    """(N, N) bool: key c is live for query r (block-diagonal when packed)."""
    idx = torch.arange(n, device=device)
    if not boundary:
        return torch.ones((n, n), dtype=torch.bool, device=device)
    return (idx[:, None] < boundary) == (idx[None, :] < boundary)


def fused_mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    boundary: int = 0,
) -> torch.Tensor:
    """Plain version of the kernel: f32 scores and softmax over masked keys,
    probabilities rounded to the input dtype before the PV product, output in
    the input dtype. (B, N, h, d) -> (B, N, h, d)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    s = s.masked_fill(~_live_mask(q.shape[1], boundary, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


def _kernel_args(q, k, v, name: str = "fused_mha"):
    """Validate the inputs of an attention kernel (K1/K2, K4-K6); returns
    (q, k, v, strides), copying only when the three tensors do not share a
    kernel-readable layout."""
    _build.require_cuda(name, q, k, v)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16 q/k/v (got {q.dtype})")
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"{name}: q/k/v must share one (B, N, h, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head_dim {HEAD_DIMS}, got {d}")
    ok = (
        q.stride() == k.stride() == v.stride()
        and q.stride(-1) == 1
        and all(s % 8 == 0 for s in q.stride()[:3])
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    )
    if not ok:
        # one copy of each input into the contiguous (B, N, h, d) layout
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, q.stride()[:3]


def attention_fwd(q, k, v, scale: float, boundary: int):
    """K1: returns (o (B, N, h, d) bf16 contiguous, lse (B, h, N) f32)."""
    q, k, v, (sb, sn, sh) = _kernel_args(q, k, v)
    B, N, H, D = q.shape
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.dinomc_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, N, H, D, sb, sn, sh, float(scale), int(boundary), _build.stream_handle(q),
        q.device.index,
    )
    _build.check(err, "attention forward")
    _build.LAUNCHES["attention_fwd"] += 1
    return o, lse


def _grad_input(do):
    """``do`` as a backward kernel takes it: a contiguous bf16 tensor on a
    16-byte boundary (its TMA map needs one)."""
    do = do.to(torch.bfloat16).contiguous()
    return do.clone() if do.data_ptr() % 16 else do


def _bwd_inputs(q, k, v, do):
    """K2's inputs: (q, k, v, strides, do) as ``_kernel_args`` and
    ``_grad_input`` return them."""
    return (*_kernel_args(q, k, v), _grad_input(do))


def _launch_dq(q, k, v, strides, do, o, lse, scale, boundary):
    B, N, H, D = q.shape
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    err = _build.library().dinomc_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, N, H, D, *strides,
        float(scale), int(boundary), _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "attention backward, dQ")
    return dq, delta


def _launch_dkv(q, k, v, strides, do, lse, delta, scale, boundary):
    B, N, H, D = q.shape
    dk, dv = (torch.empty((B, N, H, D), dtype=q.dtype, device=q.device) for _ in range(2))
    err = _build.library().dinomc_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, H, D, *strides,
        float(scale), int(boundary), _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "attention backward, dK/dV")
    return dk, dv


def attention_bwd_dq(q, k, v, o, lse, do, scale: float, boundary: int):
    """K2's first launch alone: returns (dq, delta (B, h, N) f32)."""
    return _launch_dq(*_bwd_inputs(q, k, v, do), o, lse, scale, boundary)


def attention_bwd_dkv(q, k, v, lse, delta, do, scale: float, boundary: int):
    """K2's second launch alone: returns (dk, dv); reads the first's delta."""
    return _launch_dkv(*_bwd_inputs(q, k, v, do), lse, delta, scale, boundary)


def attention_bwd(q, k, v, o, lse, do, scale: float, boundary: int):
    """K2, its two launches (dQ and delta, then dK/dV): returns (dq, dk,
    dv), each (B, N, h, d) bf16 contiguous."""
    args = _bwd_inputs(q, k, v, do)
    dq, delta = _launch_dq(*args, o, lse, scale, boundary)
    dk, dv = _launch_dkv(*args, lse, delta, scale, boundary)
    _build.LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class FusedMHA(torch.autograd.Function):
    """Autograd wrapper: K1 forward, K2 backward. Saves q, k, v, o and the
    (B, h, N) log-sum-exp; P is recomputed in the backward. A remat replay
    that keeps the attention output gets o and the log-sum-exp back from
    ``ops/remat.kept`` instead of launching K1 again."""

    @staticmethod
    def forward(ctx, q, k, v, scale, boundary):
        o, lse = kept(attention_fwd, q, k, v, scale, boundary)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.boundary = scale, boundary
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.scale, ctx.boundary)
        return dq, dk, dv, None, None


def fused_mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    boundary: int = 0,
) -> torch.Tensor:
    """Attention over (B, N, h, d). ``boundary`` (optional) splits the
    sequence into two packed crops with block-diagonal attention. CUDA
    tensors go through the kernels (bf16 only); CPU tensors through
    ``fused_mha_reference``."""
    if q.device.type == "cpu":
        return fused_mha_reference(q, k, v, scale, boundary)
    return FusedMHA.apply(q, k, v, float(scale), int(boundary))
