"""Convolution and normalization building blocks of the segmentation head
and the ResNets.

Counterpart of ``dinomc_tpu/models/layers.py``, which replaces the mmcv
``ConvModule`` layers of the reference's mmseg heads. Modules hold
parameters and buffers under torch names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), the layout
``dinomc_tpu.ckpt.torch_export`` writes; the forward is functional. Tensors
are NCHW here (the JAX package is NHWC); callers permute at the model's
edges. Weights are cast to the activation dtype at use, as in the ViT.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dinomc_tpu_torch.ops.augment import resize_weights
from dinomc_tpu_torch.parallel import distributed as pd


def _he_normal(shape, gen: Optional[torch.Generator]) -> nn.Parameter:
    """He (Kaiming) normal init over fan_in = in * k * k."""
    fan_in = shape[1] * shape[2] * shape[3]
    return nn.Parameter(torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5)


class Conv2d(nn.Module):
    """Convolution weight (out, in, k, k) and optional bias; applied by
    ``conv_apply``."""

    def __init__(self, k: int, c_in: int, c_out: int, gen=None, bias: bool = True):
        super().__init__()
        self.weight = _he_normal((c_out, c_in, k, k), gen)
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))


class ConvBNReLU(nn.Module):
    """mmcv ``ConvModule``: bias-free conv, BatchNorm, ReLU."""

    def __init__(self, k: int, c_in: int, c_out: int, gen=None):
        super().__init__()
        self.conv = Conv2d(k, c_in, c_out, gen, bias=False)
        self.bn = BatchNorm(c_out)


def conv_apply(conv: Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(B, C, H, W) -> (B, C', H / stride, W / stride); odd kernels padded
    k // 2 on each side. At stride 1 that is the JAX package's "SAME"; at
    stride 2 it is the torch-style integer padding the JAX ResNet passes
    (7x7 pad 3, 3x3 pad 1), and for a 1x1 kernel pad 0, which is what "SAME"
    comes to there."""
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x, conv.weight.to(dt), bias, stride=stride,
                    padding=conv.weight.shape[-1] // 2)


def bn_apply(
    bn: BatchNorm, x: torch.Tensor, train: bool, momentum: float = 0.9, eps: float = 1e-5,
) -> torch.Tensor:
    """BatchNorm over all but the channel axis, in the JAX package's
    one-pass form: E[x] and E[x^2] in f32, variance clamped at 0, and
    y = x * a + b with per-channel a, b folded in f32 and applied in x's
    dtype. In training the running statistics move in place, with the
    unbiased variance and ``momentum`` in JAX's convention (0.9 keeps 90%
    of the old value, torch's momentum 0.1). In a distributed step
    (``parallel/distributed.batch_shard``) E[x] and E[x^2] are the global
    batch's, all-reduced differentiably (SyncBN), so the running statistics
    move alike on every rank."""
    if train:
        x32 = x.float()
        dims = (0, 2, 3)
        mean = pd.batch_mean(x32.mean(dim=dims))
        var = (pd.batch_mean(x32.square().mean(dim=dims)) - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            n = x.numel() // x.shape[1] * pd.batch_count()
            bn.running_mean.mul_(momentum).add_((1 - momentum) * mean)
            bn.running_var.mul_(momentum).add_((1 - momentum) * var * (n / max(n - 1, 1)))
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    a = bn.weight * torch.rsqrt(var + eps)
    b = bn.bias - mean * a
    shape = (1, -1, 1, 1)
    return x * a.to(x.dtype).view(shape) + b.to(x.dtype).view(shape)


def conv_bn_relu_apply(m: ConvBNReLU, x: torch.Tensor, train: bool) -> torch.Tensor:
    return F.relu(bn_apply(m.bn, conv_apply(m.conv, x), train))


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype):
    """(out, in) weights of ``jax.image.resize(..., "bilinear")`` along one
    axis: ``scale_and_translate`` with scale out/in and the triangle kernel,
    widened and renormalized when shrinking (antialias). Built once per
    size, device and dtype, so a step uploads nothing."""
    scale = torch.tensor([out_size / in_size], dtype=torch.float32)
    w = resize_weights(in_size, out_size, scale, torch.zeros(1), "bilinear")[0]
    return w.to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` over (B, C, H, W): not
    ``F.interpolate``, which neither antialiases nor renormalizes. Axes whose
    size does not change are skipped, as JAX skips them."""
    H, W = x.shape[-2:]
    if H != hw[0]:
        x = _resize_matrix(H, hw[0], x.device, x.dtype) @ x
    if W != hw[1]:
        x = x @ _resize_matrix(W, hw[1], x.device, x.dtype).t()
    return x


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d(out)`` over (B, C, H, W): bins
    [floor(i*H/out), ceil((i+1)*H/out)), as the JAX package computes them."""
    return F.adaptive_avg_pool2d(x, out)


def dropout_mask(
    gen: Optional[torch.Generator], shape, rate: float, device=None,
) -> torch.Tensor:
    """Keep-decisions of ``dropout``: bool, True with probability 1 - rate."""
    keep = torch.full(shape, 1.0 - rate, device=device)
    return torch.bernoulli(keep, generator=gen).bool()


def dropout(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Kept elements scaled by 1 / (1 - rate), dropped ones zeroed."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))
