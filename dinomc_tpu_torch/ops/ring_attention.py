"""Ring attention: exact attention over a token axis split across ranks.

Counterpart of ``dinomc_tpu/ops/ring_attention.py``. Each rank of the ring's
process group holds one contiguous block of the tokens. Its queries stay;
the keys and values travel one hop around the ring a step
(``torch.distributed.batch_isend_irecv``: send to the next rank, receive from
the previous), and each block a rank sees adds to an online softmax in f32
(running max, normalizer and unnormalized output), cast back to the input
dtype at the end: the accumulation of the single-card attention kernels.
Keys at global positions >= ``n_valid`` are masked, for a sequence padded to
a multiple of the ring's length.

JAX differentiates through ``ppermute``; here the hop is an
``autograd.Function`` whose backward sends the gradient the other way, so
autograd differentiates the plain body as JAX does. Like the JAX ring, the
body is plain tensor algebra outside any hand-written kernel (the JAX ring
is ``jnp`` outside Pallas). Memory: one (B, heads, N_local, N_local) f32
logit block a step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` places along the ring; return what arrives."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingHop(torch.autograd.Function):
    """Forward: to the next rank, from the previous; backward: the reverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_attention(
    q: torch.Tensor,  # (B, Nl, h, d): this rank's query block
    k: torch.Tensor,  # (B, Nl, h, d): this rank's key block
    v: torch.Tensor,  # (B, Nl, h, d): this rank's value block
    scale: Optional[float] = None,
    group=None,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Exact multi-head attention of this rank's queries over the whole
    ring's keys. ``group``: the ring's process group, rank r holding tokens
    [r * Nl, (r + 1) * Nl); None runs the ring alone. ``n_valid``: the count
    of real tokens in the global sequence (None: all are)."""
    B, Nl, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n_ring = 1 if group is None else dist.get_world_size(group)
    my_idx = 0 if group is None else dist.get_rank(group)

    q32 = q.float() * scale
    m = torch.full((B, h, Nl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, h, Nl), dtype=torch.float32, device=q.device)  # noqa: E741
    o = torch.zeros((B, Nl, h, d), dtype=torch.float32, device=q.device)
    # after s hops this rank holds the block that started at ring place
    # (my_idx - s) mod n_ring; every rank sees every block once
    for s in range(n_ring):
        src = (my_idx - s) % n_ring
        logits = torch.einsum("bnhd,bmhd->bhnm", q32, k.float())
        if n_valid is not None:
            kpos = src * Nl + torch.arange(Nl, device=q.device)
            logits = torch.where((kpos < n_valid)[None, None, None, :], logits,
                                 torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)  # noqa: E741
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhnm,bmhd->bnhd", p, v.float())
        m = m_new
        if s + 1 < n_ring:
            k = _RingHop.apply(k, group)
            v = _RingHop.apply(v, group)
    denom = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)
