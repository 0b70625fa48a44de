"""Multi-head attention dispatch.

Counterpart of ``dinomc_tpu/ops/attention.py``. ``mha`` sends CUDA tensors
to the hand-written kernels (``ops/hopper/attention.py``) and CPU tensors to
their plain version; ``dense_attention`` is the reference formulation, held
against the JAX package's by the tests and called by nothing on the main
path. The JAX package's ``ring``, ``flash`` and ``fused_long`` routes are
not ported yet (ROADMAP.md, TPU kernels to port, #3 and multi-device #17).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dinomc_tpu_torch.ops.hopper.attention import MAX_FUSED_LEN, _pad_len, fused_mha


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    boundary: int = 0,
) -> torch.Tensor:
    """(B, N, h, d) reference attention; f32 softmax. ``boundary``: two
    packed crops, tokens [0, boundary) and [boundary, N), attend only within
    their own crop."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
    if boundary:
        n = q.shape[1]
        idx = torch.arange(n, device=q.device)
        same = (idx[:, None] < boundary) == (idx[None, :] < boundary)
        logits = logits.masked_fill(~same, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", probs.to(q.dtype), v)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    boundary: int = 0,
) -> torch.Tensor:
    """Multi-head attention over (B, N, heads, head_dim): the fused kernel
    for CUDA tensors, its plain version for CPU tensors (``fused_mha``).

    Sequences past ``MAX_FUSED_LEN`` padded tokens take the JAX package's
    long-sequence kernel (K4-K6), which is not ported yet: they raise on
    every device."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _pad_len(q.shape[1]) > MAX_FUSED_LEN:
        raise NotImplementedError(
            f"sequence of {q.shape[1]} tokens: the long-sequence attention "
            "(K4-K6) is not ported yet (ROADMAP.md, TPU kernels to port #3)"
        )
    return fused_mha(q, k, v, scale, boundary)
