"""Long-sequence multi-head attention: the CUDA kernels K4 (forward), K5
(dQ) and K6 (dK/dV) in ``csrc/attention_long.cu``, and their plain PyTorch
version.

Counterpart of ``dinomc_tpu/ops/pallas/attention_long.py``, which serves
padded lengths past the short kernel's 1024 (4097 tokens for a 512 px input
at patch 8). The TPU kernel padded h*d to 128 lanes and N to 128 rows and
saved nothing for its backward; these kernels take (B, N, h, d) bf16 tensors
in place (the strided q/k/v views of a ViT's qkv tensor), mask the ragged
edge themselves, save the per-row log-sum-exp, and compute delta =
rowsum(dO * O) in the dQ kernel for the dK/dV kernel. The function is the
same: an exact softmax over the N live keys, with no packing and no length
cap. ``long_mha`` launches them for CUDA tensors and runs
``long_mha_reference`` for CPU tensors; there is no fallback between the
two on a CUDA tensor.
"""

from __future__ import annotations

import torch

from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.remat import kept
from dinomc_tpu_torch.ops.hopper.attention import _grad_input, _kernel_args

NAME = "long_mha"


def long_mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
) -> torch.Tensor:
    """Plain version of the kernels: f32 scores and softmax over the N keys,
    probabilities rounded to the input dtype before the PV product, output
    in the input dtype. (B, N, h, d) -> (B, N, h, d)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


def long_attention_fwd(q, k, v, scale: float):
    """K4: returns (o (B, N, h, d) bf16 contiguous, lse (B, h, N) f32)."""
    q, k, v, (sb, sn, sh) = _kernel_args(q, k, v, NAME)
    B, N, H, D = q.shape
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    err = _build.library().dinomc_long_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, N, H, D, sb, sn, sh, float(scale), _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "long attention forward")
    _build.LAUNCHES["long_attention_fwd"] += 1
    return o, lse


def long_attention_dq(q, k, v, o, lse, do, scale: float):
    """K5: returns (dq (B, N, h, d) bf16 contiguous, delta (B, h, N) f32);
    ``do`` is a contiguous bf16 (B, N, h, d) tensor."""
    q, k, v, (sb, sn, sh) = _kernel_args(q, k, v, NAME)
    B, N, H, D = q.shape
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    err = _build.library().dinomc_long_attn_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, N, H, D, sb, sn, sh,
        float(scale), _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "long attention dQ")
    _build.LAUNCHES["long_attention_dq"] += 1
    return dq, delta


def long_attention_dkv(q, k, v, lse, delta, do, scale: float):
    """K6: returns (dk, dv), each (B, N, h, d) bf16 contiguous."""
    q, k, v, (sb, sn, sh) = _kernel_args(q, k, v, NAME)
    do = _grad_input(do)
    B, N, H, D = q.shape
    dk, dv = (torch.empty((B, N, H, D), dtype=q.dtype, device=q.device) for _ in range(2))
    err = _build.library().dinomc_long_attn_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, H, D, sb, sn, sh,
        float(scale), _build.stream_handle(q), q.device.index,
    )
    _build.check(err, "long attention dK/dV")
    _build.LAUNCHES["long_attention_dkv"] += 1
    return dk, dv


def long_attention_bwd(q, k, v, o, lse, do, scale: float):
    """K5 then K6: returns (dq, dk, dv)."""
    do = _grad_input(do)
    dq, delta = long_attention_dq(q, k, v, o, lse, do, scale)
    dk, dv = long_attention_dkv(q, k, v, lse, delta, do, scale)
    return dq, dk, dv


class LongMHA(torch.autograd.Function):
    """Autograd wrapper: K4 forward, K5 + K6 backward. Saves q, k, v, o and
    the (B, h, N) log-sum-exp; P is recomputed in the backward. Kept across a
    remat replay as K1 is (``ops/remat.kept``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = kept(long_attention_fwd, q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = long_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def long_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over (B, N, h, d) for long N, any length. CUDA tensors go
    through the kernels (bf16 only); CPU tensors through
    ``long_mha_reference``."""
    if q.device.type == "cpu":
        return long_mha_reference(q, k, v, scale)
    return LongMHA.apply(q, k, v, float(scale))
