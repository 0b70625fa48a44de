"""The forward kernels an eval path reaches, as ``torch.library`` custom ops.

``torch.export`` traces with fake tensors, which have no ``data_ptr()`` to
hand to the C entries that the autograd Functions (``FusedMHA``,
``LongMHA``, ``WindowAttention``, ``FusedMLP``) call through ``ctypes``. So
each forward kernel is also registered as an op in the ``dinomc_torch``
namespace, with a fake implementation that gives its output's shape and
dtype: K1 ``attention_fwd``, K4 ``long_attention_fwd``, K7
``window_attention_fwd``, K9 ``window_attention_stacked_fwd`` and K11
``fused_mlp``. On a CUDA tensor an op's body calls the same launcher as the
Function, which counts the launch in ``_build.LAUNCHES``; on a CPU tensor it
runs the kernel's plain version. The dispatchers call the ops only inside
``_build.route_ops()`` (``ckpt/export.py`` traces under it); the training
path calls the Functions as before. Importing this module registers the
ops, so a saved program that names them loads (``ckpt/export.load_exported``).
"""

from __future__ import annotations

from typing import Optional

import torch

from dinomc_tpu_torch.ops.hopper import attention as ha
from dinomc_tpu_torch.ops.hopper import attention_long as hl
from dinomc_tpu_torch.ops.hopper import fused_mlp as hm
from dinomc_tpu_torch.ops.hopper import window_attention as hw

NAMESPACE = "dinomc_torch"


@torch.library.custom_op(f"{NAMESPACE}::attention_fwd", mutates_args=())
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  boundary: int) -> torch.Tensor:
    """K1: (B, N, h, d) -> (B, N, h, d), contiguous."""
    if q.device.type == "cpu":
        return ha.fused_mha_reference(q, k, v, scale, boundary).contiguous()
    return ha.attention_fwd(q, k, v, scale, boundary)[0]


@torch.library.custom_op(f"{NAMESPACE}::long_attention_fwd", mutates_args=())
def long_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """K4: (B, N, h, d) -> (B, N, h, d), contiguous."""
    if q.device.type == "cpu":
        return hl.long_mha_reference(q, k, v, scale).contiguous()
    return hl.long_attention_fwd(q, k, v, scale)[0]


def _window(launch):
    def body(q, k, v, bias, mask, heads):
        if q.device.type == "cpu":
            return hw.window_attention_reference(q, k, v, bias, mask, heads).contiguous()
        return launch(q, k, v, bias, mask, heads)
    return body


@torch.library.custom_op(f"{NAMESPACE}::window_attention_fwd", mutates_args=())
def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """K7: (nB, 49, C) -> (nB, 49, C), contiguous."""
    return _window(hw.window_attention_fwd)(q, k, v, bias, mask, heads)


@torch.library.custom_op(f"{NAMESPACE}::window_attention_stacked_fwd", mutates_args=())
def window_attention_stacked_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor, mask: Optional[torch.Tensor],
                                 heads: int) -> torch.Tensor:
    """K9: as K7."""
    return _window(hw.window_attention_stacked_fwd)(q, k, v, bias, mask, heads)


@torch.library.custom_op(f"{NAMESPACE}::fused_mlp", mutates_args=())
def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, approx: bool) -> torch.Tensor:
    """K11: x (M, D) -> (M, D), contiguous."""
    if x.device.type == "cpu":
        return hm.fused_mlp_reference(x, w1, b1, w2, b2, approx).contiguous()
    return hm.fused_mlp_fwd(x, w1, b1, w2, b2, approx)


def _like(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of ``t``'s shape, dtype and device."""
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


attention_fwd.register_fake(lambda q, k, v, scale, boundary: _like(q))
long_attention_fwd.register_fake(lambda q, k, v, scale: _like(q))
window_attention_fwd.register_fake(lambda q, k, v, bias, mask, heads: _like(q))
window_attention_stacked_fwd.register_fake(lambda q, k, v, bias, mask, heads: _like(q))
fused_mlp.register_fake(lambda x, w1, b1, w2, b2, approx: _like(x))
