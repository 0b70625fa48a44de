"""DINO projection head.

Counterpart of ``dinomc_tpu/models/dino_head.py``; parity target the
reference ``DINOHead`` (``utils/vision_transformer.py:260-294``): a 3-layer
MLP in_dim -> 2048 -> 2048 -> 256 with exact-erf GELU, L2 normalization of
the bottleneck, then a weight-normed linear layer 256 -> out_dim stored as
``last_layer.weight_v`` (out, in) and ``last_layer.weight_g`` (out, 1), the
layout ``dino_head_state_dict`` writes. ``g`` is frozen by the optimizer's
mask when ``norm_last_layer``. The MLP runs in the compute dtype; the
normalization, the weight-norm and the logits stay f32.

With ``use_bn`` (the reference's convnet recipe) a BatchNorm follows each
hidden linear layer, and the reference's Sequential indices shift: Linear
at ``mlp.0``, ``mlp.3``, ``mlp.6``, BatchNorm at ``mlp.1``, ``mlp.4``. As in
the JAX head, it always normalizes by the statistics of the rows of one
head pass (the teacher's too), in f32 with the biased variance and eps
1e-5, and keeps no running statistics. In a distributed step
(``parallel/distributed.batch_shard``) those statistics are the global
batch's: the mean, then the variance, all-reduced over the ranks that split
the batch (SyncBN).

Under head tensor parallelism (a mesh whose model axis is > 1) the
bottleneck features of the model group's ranks are all-gathered (the
gather's backward reduce-scatters), and each rank multiplies them by its
out_dim block of the weight-normed layer. Weight norm is per output unit, so
a block needs no communication.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dinomc_tpu_torch.models.vit import Linear, linear, trunc_normal
from dinomc_tpu_torch.parallel import distributed as pd


@dataclasses.dataclass(frozen=True)
class DINOHeadConfig:
    in_dim: int = 384
    out_dim: int = 65536
    hidden_dim: int = 2048
    bottleneck_dim: int = 256
    nlayers: int = 3
    use_bn: bool = False
    norm_last_layer: bool = True
    compute_dtype: torch.dtype = torch.bfloat16


class WeightNormLinear(nn.Module):
    """W = g * v / ||v||_row, no bias."""

    def __init__(self, d_in: int, d_out: int, gen):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(d_out, 1))
        self.weight_v = trunc_normal((d_out, d_in), gen)


class BatchNorm(nn.Module):
    """The head's BatchNorm: scale and bias only (batch statistics always)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class DINOHead(nn.Module):
    def __init__(self, cfg: DINOHeadConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        n = max(cfg.nlayers, 1)
        dims_in = [cfg.in_dim] + [cfg.hidden_dim] * (n - 1)
        dims_out = [cfg.hidden_dim] * (n - 1) + [cfg.bottleneck_dim]
        layers = []
        for i, (di, do) in enumerate(zip(dims_in, dims_out)):
            layers.append(Linear(di, do, gen))
            if i < n - 1:
                if cfg.use_bn:
                    layers.append(BatchNorm(do))
                layers.append(nn.GELU())
        self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormLinear(cfg.bottleneck_dim, cfg.out_dim, gen)

    def forward(self, x):
        return dino_head_forward(self, x)


def dino_head_forward(head: DINOHead, x: torch.Tensor, mesh=None, n_crops: int = 1) -> torch.Tensor:
    """x (B, in_dim) f32 -> logits (B, out_dim) f32. On a ``mesh`` with a
    model axis of M > 1, x holds this rank's ``n_crops`` crops of b rows,
    crop-major, and the result is (n_crops * M * b, out_dim / M): the model
    group's rows of each crop (rank-major) at this rank's out_dim block."""
    dt = head.cfg.compute_dtype
    y = x.to(dt)
    for m in head.mlp:
        if isinstance(m, Linear):
            y = linear(y, m)
        elif isinstance(m, BatchNorm):
            y32 = y.float()
            mean = pd.batch_mean(y32.mean(dim=0, keepdim=True))
            var = pd.batch_mean((y32 - mean).square().mean(dim=0, keepdim=True))
            y = ((y32 - mean) * torch.rsqrt(var + 1e-5) * m.weight + m.bias).to(dt)
        else:
            y = F.gelu(y, approximate="none")
    y = y.float()
    y = y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    v, g = head.last_layer.weight_v, head.last_layer.weight_g
    if mesh is not None and mesh.size("model") > 1:
        M, rank = mesh.size("model"), mesh.index("model")
        y = pd.all_gather(y, 0, mesh.group("model"))  # (M * n_crops * b, bottleneck)
        y = y.reshape(M, n_crops, -1, y.shape[-1]).transpose(0, 1).reshape(-1, y.shape[-1])
        k = v.shape[0] // M
        v, g = v.narrow(0, rank * k, k), g.narrow(0, rank * k, k)
    w = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12) * g
    return (y.to(dt) @ w.to(dt).t()).float()
