"""Multi-head attention dispatch.

Counterpart of ``dinomc_tpu/ops/attention.py``. ``mha`` sends CUDA tensors
to the hand-written kernels and CPU tensors to their plain versions: padded
lengths up to ``MAX_FUSED_LEN`` take the fused kernel
(``ops/hopper/attention.py``), longer ones the long-sequence kernel
(``ops/hopper/attention_long.py``), with no upper cap. That kernel also
stands in for the stock TPU flash kernel the JAX package calls past 5120
tokens, so its three length tiers become two. ``dense_attention`` is the
reference formulation, held against the JAX package's by the tests and
called by nothing on the main path. ``impl='ring'`` takes the sequence-
parallel route, as in JAX: q, k and v are this rank's token blocks and
``ops/ring_attention.ring_attention`` runs over the ring's process group,
``n_valid`` masking a padded tail.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dinomc_tpu_torch.ops.hopper.attention import MAX_FUSED_LEN, _pad_len, fused_mha
from dinomc_tpu_torch.ops.hopper.attention_long import long_mha
from dinomc_tpu_torch.ops.ring_attention import ring_attention


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
    impl: str = "auto",
    group=None,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention over (B, N, heads, head_dim): the fused kernel
    (``fused_mha``) for padded N <= ``MAX_FUSED_LEN``, the long-sequence
    kernel (``long_mha``) above it; each runs its plain version on CPU
    tensors. Crop packing (``boundary``) exists only on the fused route.
    ``impl='ring'``: ring attention over ``group`` (``n_valid`` real
    tokens), no crop packing."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "ring":
        if boundary:
            raise ValueError("crop packing (boundary) is not supported with ring attention")
        return ring_attention(q, k, v, scale, group, n_valid)
    if n_valid is not None:
        raise ValueError(f"n_valid (={n_valid}) masking exists only for impl='ring' "
                         f"(got impl={impl!r})")
    if _pad_len(q.shape[1]) <= MAX_FUSED_LEN:
        return fused_mha(q, k, v, scale, boundary)
    if boundary:
        raise ValueError(
            f"crop packing (boundary={boundary}) is not supported for a sequence "
            f"of {q.shape[1]} tokens (long-sequence attention)"
        )
    return long_mha(q, k, v, scale)
