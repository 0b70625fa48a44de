"""XCiT (Cross-Covariance Image Transformer) backbone in PyTorch.

Counterpart of ``dinomc_tpu/models/xcit.py``, the JAX package's own XCiT
(XCiT-S12 defaults; the reference loads the hub's, ``main_dino_mc.py:
217-220``): a stride-2 conv stem (3 convs at patch 8, 4 at patch 16, GELU
between them, a bias and no BatchNorm), fixed Fourier positional features
with a learned projection, XCA blocks (channel attention with a learned
temperature per head, Local Patch Interaction depthwise convs, an MLP, each
branch scaled by a LayerScale ``gamma``), then class-attention layers that
update the CLS token alone, a final LayerNorm and the CLS output in f32.

The JAX model is not the hub's, and no ``.pth`` mapping exists for it in
either package, so parameters carry the JAX tree's names, one module a
block: ``stem.{i}``, ``pos_proj``, ``cls_token``, ``blocks.{l}.{norm1, qkv,
temp, proj, gamma1, norm3, lpi_conv1, lpi_bn, lpi_conv2, gamma3, norm2,
fc1, fc2, gamma2}``, ``cls_blocks.{i}.{norm1, qkv, proj, gamma1, norm2,
fc1, fc2, gamma2}`` and ``norm``, with torch's ``weight``/``bias`` leaves
(a LayerNorm's or BatchNorm's ``scale`` is ``weight``), Linear weights
(out, in) and conv weights (out, in / groups, 3, 3).
``ckpt/from_jax.xcit_state_dict`` maps a JAX tree onto them, unstacking the
layer axis.

The LPI BatchNorm normalizes by the batch in training and in eval alike and
keeps no running statistics (the JAX model returns no state), so features
depend on the batch they are computed with. The stem pads as XLA's "SAME"
does, computed per input size: (0, 1) at stride 2 for an even side, (1, 1)
for an odd one (``_same_pad``). XCiT reaches no Pallas kernel in the JAX
package, so its GEMMs, convolutions and einsums are PyTorch calls here.

Remat (``XCiTConfig.remat``, ``remat_policy``) covers the XCA blocks as in
JAX: ``full`` replays each block from its input (``torch.utils.checkpoint``),
``branches`` keeps the XCA and LPI branch outputs (``xca_out``,
``lpi_out``) through the ViT's selective-checkpoint scopes
(``models/vit.remat_contexts``). DropPath runs at one constant rate on every
residual branch, its keep-decisions drawn once, outside the replayed blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dinomc_tpu_torch.models.layers import Conv2d
from dinomc_tpu_torch.models.vit import LayerNorm, Linear, _named, layer_norm, linear, remat_contexts, trunc_normal
from dinomc_tpu_torch.parallel import distributed as pd

REMAT_POLICIES = {"full": (), "branches": ("xca_out", "lpi_out")}


@dataclasses.dataclass(frozen=True)
class XCiTConfig:
    patch_size: int = 16  # 16: a 4-conv stem, 8: 3 convs
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 8
    mlp_ratio: float = 4.0
    cls_attn_layers: int = 2
    layer_scale_init: float = 1.0
    layernorm_eps: float = 1e-6
    pos_hidden: int = 32
    compute_dtype: torch.dtype = torch.bfloat16
    # Replay each XCA block in the backward, keeping what ``remat_policy``
    # names (REMAT_POLICIES; module docstring). Every policy computes the
    # same numbers.
    remat: bool = True
    remat_policy: str = "full"
    # tanh GELU (True, the JAX package's default) or exact erf (False).
    gelu_approx: bool = True
    # Stochastic depth at one constant rate on every residual branch (the
    # official XCiT's dpr = [rate] * depth), not the ViT's linear ramp.
    drop_path_rate: float = 0.0

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                             f"got {self.remat_policy!r}")

    @property
    def stem_widths(self) -> Tuple[int, ...]:
        n = 4 if self.patch_size == 16 else 3
        return tuple(self.embed_dim // 2 ** (n - 1 - i) for i in range(n))

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def xcit_small_12(patch_size: int = 16, **kw) -> XCiTConfig:
    return XCiTConfig(patch_size=patch_size, embed_dim=384, depth=12, num_heads=8, **kw)


def xcit_medium_24(patch_size: int = 16, **kw) -> XCiTConfig:
    return XCiTConfig(patch_size=patch_size, embed_dim=512, depth=24, num_heads=8, **kw)


XCIT_FACTORIES = {"xcit_small_12": xcit_small_12, "xcit_medium_24": xcit_medium_24}


# ---------------------------------------------------------------------------
# parameters (the JAX tree's names)
# ---------------------------------------------------------------------------


def _full(d: int, value: float) -> nn.Parameter:
    return nn.Parameter(torch.full((d,), float(value)))


class XCABlock(nn.Module):
    def __init__(self, cfg: XCiTConfig, gen):
        super().__init__()
        D, ls = cfg.embed_dim, cfg.layer_scale_init
        self.norm1 = LayerNorm(D)
        self.qkv = Linear(D, 3 * D, gen)
        self.temp = nn.Parameter(torch.ones(cfg.num_heads))
        self.proj = Linear(D, D, gen)
        self.gamma1 = _full(D, ls)
        self.norm3 = LayerNorm(D)
        self.lpi_conv1 = Conv2d(3, 1, D, gen)  # depthwise: (D, 1, 3, 3)
        self.lpi_bn = LayerNorm(D)  # the BatchNorm's scale and bias; no running statistics
        self.lpi_conv2 = Conv2d(3, 1, D, gen)
        self.gamma3 = _full(D, ls)
        self.norm2 = LayerNorm(D)
        self.fc1 = Linear(D, cfg.mlp_dim, gen)
        self.fc2 = Linear(cfg.mlp_dim, D, gen)
        self.gamma2 = _full(D, ls)


class ClassAttentionBlock(nn.Module):
    def __init__(self, cfg: XCiTConfig, gen):
        super().__init__()
        D, ls = cfg.embed_dim, cfg.layer_scale_init
        self.norm1 = LayerNorm(D)
        self.qkv = Linear(D, 3 * D, gen)
        self.proj = Linear(D, D, gen)
        self.gamma1 = _full(D, ls)
        self.norm2 = LayerNorm(D)
        self.fc1 = Linear(D, cfg.mlp_dim, gen)
        self.fc2 = Linear(cfg.mlp_dim, D, gen)
        self.gamma2 = _full(D, ls)


class XCiT(nn.Module):
    """Parameters of one XCiT; the forward is ``xcit_forward``."""

    def __init__(self, cfg: XCiTConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        widths = (3,) + cfg.stem_widths
        self.stem = nn.ModuleList([Conv2d(3, ci, co, gen) for ci, co in zip(widths, widths[1:])])
        # sin and cos halves per axis: 2 axes x pos_hidden features
        self.pos_proj = Linear(2 * cfg.pos_hidden, D, gen)
        self.cls_token = trunc_normal((1, 1, D), gen)
        self.blocks = nn.ModuleList([XCABlock(cfg, gen) for _ in range(cfg.depth)])
        self.cls_blocks = nn.ModuleList(
            [ClassAttentionBlock(cfg, gen) for _ in range(cfg.cls_attn_layers)])
        self.norm = LayerNorm(D)

    def forward(self, x, generator=None, deterministic=True, dp_masks=None):
        return xcit_forward(self, x, generator, deterministic, dp_masks)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one side of length ``n``: ceil(n / stride)
    outputs, the odd pixel of the total padding at the end."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: Conv2d, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """(B, C, H, W) convolution with "SAME" padding, weight and bias cast to
    x's dtype."""
    k = conv.weight.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    dt = x.dtype
    return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=stride, groups=groups)


def _gelu(x: torch.Tensor, approx: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approx else "none")


def fourier_pos(gh: int, gw: int, hidden: int) -> torch.Tensor:
    """Fixed 2-D sine/cosine features (XCiT's PositionalEncodingFourier), f32
    on the CPU: per position, hidden/2 sines and hidden/2 cosines of x, then
    of y, at (i + 1) / (g + 1e-6) * 2 pi over 10000^(2 (j // 2) / hidden):
    (gh * gw, 2 * hidden)."""
    scale, eps = 2 * math.pi, 1e-6
    y = ((torch.arange(gh, dtype=torch.float32) + 1.0)[:, None].expand(gh, gw)
         / (gh + eps) * scale)
    x = ((torch.arange(gw, dtype=torch.float32) + 1.0)[None, :].expand(gh, gw)
         / (gw + eps) * scale)
    dim_t = 10000 ** (2 * (torch.arange(hidden) // 2) / hidden)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    feats = torch.cat([px[..., 0::2].sin(), px[..., 1::2].cos(),
                       py[..., 0::2].sin(), py[..., 1::2].cos()], dim=-1)
    return feats.reshape(gh * gw, 2 * hidden)


@functools.lru_cache(maxsize=64)
def _pos_features(gh: int, gw: int, hidden: int, device: torch.device) -> torch.Tensor:
    """``fourier_pos`` on ``device``: built and uploaded once per grid."""
    return fourier_pos(gh, gw, hidden).to(device)


def _xca(t: torch.Tensor, blk: XCABlock, heads: int) -> torch.Tensor:
    """Cross-covariance attention over channels, (B, N, D) -> (B, N, D): q
    and k L2-normalized over the tokens (the norm in f32, clamped at 1e-12,
    the division in t's dtype), the (dh x dh) product scaled by each head's
    temperature and softmaxed in f32."""
    B, N, D = t.shape
    dt = t.dtype
    qkv = linear(t, blk.qkv).reshape(B, N, 3, heads, D // heads)
    q, k, v = qkv.unbind(2)  # (B, N, h, dh)

    def normalized(a):
        norm = a.float().square().sum(dim=1, keepdim=True).sqrt()
        return a / norm.clamp_min(1e-12).to(dt)

    attn = torch.einsum("bnhd,bnhe->bhde", normalized(q), normalized(k)).float()
    attn = (attn * blk.temp[None, :, None, None]).softmax(dim=-1).to(dt)
    out = torch.einsum("bhde,bnhe->bnhd", attn, v).reshape(B, N, D)
    return linear(out, blk.proj)


def _lpi(t: torch.Tensor, blk: XCABlock, gh: int, gw: int, gelu_approx: bool) -> torch.Tensor:
    """Local patch interaction on the (gh, gw) token grid: depthwise 3x3
    conv, GELU, BatchNorm by the batch's statistics (one-pass f32 moments,
    variance clamped at 0, folded to x * a + b in t's dtype), depthwise 3x3
    conv. (B, N, D) -> (B, N, D). The moments are the global batch's in a
    distributed step (``parallel/distributed.batch_mean``)."""
    B, N, D = t.shape
    x = t.reshape(B, gh, gw, D).permute(0, 3, 1, 2)  # NCHW, channels-last strides
    x = _gelu(conv_same(x, blk.lpi_conv1, groups=D), gelu_approx)
    x32 = x.float()
    mean = pd.batch_mean(x32.mean(dim=(0, 2, 3)))
    var = (pd.batch_mean(x32.square().mean(dim=(0, 2, 3))) - mean.square()).clamp_min(0.0)
    a = blk.lpi_bn.weight * torch.rsqrt(var + 1e-5)
    b = blk.lpi_bn.bias - mean * a
    x = x * a.to(x.dtype).view(1, D, 1, 1) + b.to(x.dtype).view(1, D, 1, 1)
    x = conv_same(x, blk.lpi_conv2, groups=D)
    return x.permute(0, 2, 3, 1).reshape(B, N, D)


def _drop(y: torch.Tensor, mask: Optional[torch.Tensor], keep: float) -> torch.Tensor:
    """Per-sample stochastic depth: kept samples scale by 1/keep; no mask,
    no DropPath."""
    if mask is None:
        return y
    m = mask.reshape((y.shape[0],) + (1,) * (y.ndim - 1))
    return torch.where(m, y * (1.0 / keep), torch.zeros_like(y))


def _block(t, blk: XCABlock, cfg: XCiTConfig, gh: int, gw: int, masks):
    """One XCA block; ``masks`` (3, B) keep-decisions of its branches, or
    None (no DropPath)."""
    eps, keep = cfg.layernorm_eps, 1.0 - cfg.drop_path_rate
    m = [None] * 3 if masks is None else masks
    dt = t.dtype
    y = _xca(layer_norm(t, blk.norm1, eps), blk, cfg.num_heads)
    with _named("xca_out"):
        y = blk.gamma1.to(dt) * y
    t = t + _drop(y, m[0], keep)
    y = _lpi(layer_norm(t, blk.norm3, eps), blk, gh, gw, cfg.gelu_approx)
    with _named("lpi_out"):
        y = blk.gamma3.to(dt) * y
    t = t + _drop(y, m[1], keep)
    y = linear(_gelu(linear(layer_norm(t, blk.norm2, eps), blk.fc1), cfg.gelu_approx), blk.fc2)
    return t + _drop(blk.gamma2.to(dt) * y, m[2], keep)


def _remat(cfg: XCiTConfig, fn, *args):
    """``fn(*args)``, replayed in the backward under ``cfg``'s policy when
    ``cfg.remat`` and autograd records."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    keep = REMAT_POLICIES[cfg.remat_policy]
    if not keep:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=remat_contexts(keep))


def _class_attention(cls, tokens, cb: ClassAttentionBlock, cfg: XCiTConfig, masks):
    """One class-attention layer: the CLS token's query over CLS and every
    token (logits scaled by 1/sqrt(dh) in f32), then its MLP; only CLS is
    updated. ``masks`` (2, B) or None."""
    B, _, D = cls.shape
    h, eps, keep = cfg.num_heads, cfg.layernorm_eps, 1.0 - cfg.drop_path_rate
    m = [None] * 2 if masks is None else masks
    dh = D // h
    qkv = linear(layer_norm(torch.cat([cls, tokens], dim=1), cb.norm1, eps), cb.qkv)
    qkv = qkv.reshape(B, -1, 3, h, dh)
    q, k, v = qkv[:, :1, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / math.sqrt(dh)
    attn = logits.softmax(dim=-1).to(cls.dtype)
    out = linear(torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, 1, D), cb.proj)
    cls = cls + _drop(cb.gamma1.to(cls.dtype) * out, m[0], keep)
    y = linear(_gelu(linear(layer_norm(cls, cb.norm2, eps), cb.fc1), cfg.gelu_approx), cb.fc2)
    return cls + _drop(cb.gamma2.to(cls.dtype) * y, m[1], keep)


def drop_path_masks(
    cfg: XCiTConfig, batch: int, generator: torch.Generator, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every keep-decision in one draw each: (depth, 3, B) for the XCA
    blocks' branches and (cls_attn_layers, 2, B) for the class-attention
    layers', bool."""
    keep = 1.0 - cfg.drop_path_rate
    blk = torch.full((cfg.depth, 3, batch), keep, device=device)
    cls = torch.full((cfg.cls_attn_layers, 2, batch), keep, device=device)
    return (pd.global_bernoulli(blk, generator, 2).bool(),
            pd.global_bernoulli(cls, generator, 2).bool())


def xcit_forward(
    model: XCiT,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """(B, H, W, 3) -> final-LN CLS embedding (B, D) f32. DropPath runs when
    ``deterministic`` is False and the rate is positive: keep-decisions come
    from ``dp_masks`` ((depth, 3, B), (cls_attn_layers, 2, B) bool) if
    given, else from one draw on ``generator``."""
    cfg = model.cfg
    dt, B, D = cfg.compute_dtype, x.shape[0], cfg.embed_dim
    if deterministic or cfg.drop_path_rate <= 0 or (dp_masks is None and generator is None):
        blk_masks = cls_masks = None
    else:
        blk_masks, cls_masks = dp_masks or drop_path_masks(cfg, B, generator, x.device)

    y = x.to(dt).permute(0, 3, 1, 2)
    for i, conv in enumerate(model.stem):
        y = conv_same(y, conv, stride=2)
        if i < len(model.stem) - 1:
            y = _gelu(y, cfg.gelu_approx)
    gh, gw = y.shape[2], y.shape[3]
    tokens = y.permute(0, 2, 3, 1).reshape(B, gh * gw, D)
    pos = _pos_features(gh, gw, cfg.pos_hidden, x.device)
    tokens = tokens + linear(pos.to(dt), model.pos_proj)[None]

    for i, blk in enumerate(model.blocks):
        masks = None if blk_masks is None else blk_masks[i]
        tokens = _remat(cfg, _block, tokens, blk, cfg, gh, gw, masks)

    cls = model.cls_token.to(dt).expand(B, 1, D)
    for i, cb in enumerate(model.cls_blocks):
        cls = _class_attention(cls, tokens, cb, cfg, None if cls_masks is None else cls_masks[i])
    return layer_norm(cls, model.norm, cfg.layernorm_eps)[:, 0].float()
