"""Fused transformer MLP: the CUDA kernel K11 (forward) in
``csrc/fused_mlp.cu``, its plain PyTorch version, and the plain backward.

Counterpart of ``dinomc_tpu/ops/pallas/fused_mlp.py``: out = GELU(x W1^T +
b1) W2^T + b2 with the hidden activation accumulated, biased and GELU'd in
f32 and rounded to the compute dtype only as the second product's operand.
That is not the dense path's rounding (``models/vit._mlp`` rounds x W1^T + b1
to the compute dtype before GELU). The weights come in the port's Linear
layout, W1 (F, D) and W2 (D, F), with no transposed copy. The TPU wrapper
padded M to its 512-row grid; the CUDA kernel masks a ragged M itself.

The backward mirrors the JAX package's ``_fused_bwd`` exactly and is plain
PyTorch, as the TPU kernel's is plain XLA: it recomputes u from the saved
(x, W1, b1) and reads neither the forward's output nor anything the kernel
computed, so the kernel's route and the plain route give the same
gradients for the same dO. ``fused_mlp`` launches the kernel for CUDA
tensors (bf16 only) and runs ``fused_mlp_reference`` for CPU tensors; there
is no fallback between the two on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dinomc_tpu_torch.ops.hopper import _build

# Embedding width -> the hidden chunk the kernel walks F in (csrc/fused_mlp.cu
# ``Cfg``): the ViT-Ti/S/B widths.
HIDDEN_CHUNK = {192: 64, 384: 32, 768: 32}


def _gelu_form(approx: bool) -> str:
    return "tanh" if approx else "none"


def fused_mlp_reference(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, approx: bool = True,
) -> torch.Tensor:
    """Plain version of the kernel: u = x W1^T + b1 in f32, GELU in f32,
    rounded to x's dtype, then h W2^T + b2 in f32, rounded once.
    x (M, D), W1 (F, D), b1 (F,), W2 (D, F), b2 (D,) -> (M, D)."""
    u = torch.matmul(x.float(), w1.float().t()) + b1.float()
    h = F.gelu(u, approximate=_gelu_form(approx)).to(x.dtype)
    return (torch.matmul(h.float(), w2.float().t()) + b2.float()).to(x.dtype)


def fused_mlp_fwd(x, w1, b1, w2, b2, approx: bool) -> torch.Tensor:
    """K11: returns (M, D) in bf16, contiguous."""
    name = "fused_mlp"
    _build.require_cuda(name, x, w1, b1, w2, b2)
    if not all(t.dtype == torch.bfloat16 for t in (x, w1, b1, w2, b2)):
        raise TypeError(f"{name} kernel takes bf16 x, weights and biases")
    M, D = x.shape
    hidden = w1.shape[0]
    if D not in HIDDEN_CHUNK or hidden % HIDDEN_CHUNK[D]:
        raise ValueError(f"{name} kernel tiles D in {sorted(HIDDEN_CHUNK)} with F a multiple "
                         f"of {HIDDEN_CHUNK.get(D, 64)}, got D={D}, F={hidden}")
    if (w1.shape, b1.shape, w2.shape, b2.shape) != ((hidden, D), (hidden,), (D, hidden), (D,)):
        raise ValueError(f"{name}: want W1 (F, D), b1 (F,), W2 (D, F), b2 (D,) for D={D}, "
                         f"F={hidden}; got {[tuple(t.shape) for t in (w1, b1, w2, b2)]}")
    # TMA reads rows from 16-byte aligned bases
    x, w1, b1, w2, b2 = (t.contiguous() if t.data_ptr() % 16 == 0
                         else t.clone(memory_format=torch.contiguous_format)
                         for t in (x, w1, b1, w2, b2))
    out = torch.empty_like(x)
    if M == 0:
        return out
    err = _build.library().dinomc_fused_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), M, D, hidden, int(approx), _build.stream_handle(x), x.device.index,
    )
    _build.check(err, "fused MLP")
    _build.LAUNCHES["fused_mlp"] += 1
    return out


def fused_mlp_bwd(x, w1, b1, w2, do, approx: bool):
    """Plain-PyTorch mirror of the JAX package's ``_fused_bwd``: u = x W1^T
    + b1 in x's dtype, then f32; the GELU derivative in f32; products in x's
    dtype. Returns (dx, dW1, db1, dW2, db2) in the inputs' shapes."""
    u = (torch.matmul(x, w1.t()) + b1).float()
    h = F.gelu(u, approximate=_gelu_form(approx))
    dh = torch.matmul(do, w2).float()
    du = torch.ops.aten.gelu_backward(dh, u, approximate=_gelu_form(approx)).to(x.dtype)
    hb = h.to(x.dtype)
    return du @ w1, du.t() @ x, du.sum(0), do.t() @ hb, do.sum(0)


class FusedMLP(torch.autograd.Function):
    """``forward`` (K11's launcher or the plain version) forward, the plain
    ``fused_mlp_bwd`` backward. Saves x, W1, b1 and W2; the hidden
    activation is recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, approx, forward):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.approx = approx
        return forward(x, w1, b1, w2, b2, approx)

    @staticmethod
    def backward(ctx, do):
        x, w1, b1, w2 = ctx.saved_tensors
        return (*fused_mlp_bwd(x, w1, b1, w2, do, ctx.approx), None, None)


def fused_mlp(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, approx: bool = True,
) -> torch.Tensor:
    """GELU(x W1^T + b1) W2^T + b2 over x (M, D), weights in the Linear
    layout. CUDA tensors go through K11 (bf16 only); CPU tensors through
    ``fused_mlp_reference``. Both take the same backward."""
    forward = fused_mlp_reference if x.device.type == "cpu" else fused_mlp_fwd
    return FusedMLP.apply(x, w1, b1, w2, b2, bool(approx), forward)
