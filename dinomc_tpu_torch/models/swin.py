"""Swin-T backbone in PyTorch.

Counterpart of ``dinomc_tpu/models/swin.py`` (the reference's torchvision
``swin_t`` encoder, ``main_dino_mc.py:226-229``): a 4x4 patch embed to 96
channels, stages of depth (2, 2, 6, 2) with (3, 6, 12, 24) heads of 32,
7x7 window attention with a relative-position bias, shifted windows on odd
blocks, patch merging between stages, a final LayerNorm and a global mean
pool to 768 channels. Maps that are not window multiples are padded at the
bottom and right, and the padded tokens are masked as keys (torchvision
semantics).

Parameters carry torchvision's names, the ones
``ckpt/state_dicts.swin_state_dict`` emits: ``features.0.0`` is the patch
conv and ``features.0.2`` its LayerNorm, ``features.{2s+1}.{b}`` block b of
stage s (``norm1``, ``attn.qkv``, ``attn.proj``,
``attn.relative_position_bias_table``, ``norm2``, ``mlp.0``, ``mlp.3``),
``features.{2s+2}`` the patch merge after stage s (``norm``, ``reduction``,
no bias), and ``norm`` the final LayerNorm. ``relative_position_index`` is
a non-persistent buffer, so a state dict without it loads with
``strict=True``. As in the ViT, LayerNorm statistics are f32, every matmul
weight and bias is cast to ``compute_dtype`` at use, and the pooled mean is
f32. Window attention goes through ``ops/hopper/window_attention.py`` (K7/K8
on the card, on every stage); DropPath follows the JAX package (a linear
ramp over all blocks, two independent per-sample masks a block).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dinomc_tpu_torch.models.vit import LayerNorm, Linear, _drop_path, layer_norm, linear, patchify, trunc_normal
from dinomc_tpu_torch.ops.hopper.window_attention import window_attention
from dinomc_tpu_torch.parallel import distributed as pd


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    layernorm_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.bfloat16
    # Linear ramp over all blocks; torchvision's swin_t fixes 0.2, here it
    # follows --drop_path_rate as in the JAX package.
    drop_path_rate: float = 0.0
    # tanh GELU (the JAX package's default) or exact erf (False, torchvision).
    gelu_approx: bool = True

    @property
    def out_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)

    @property
    def num_blocks(self) -> int:
        return sum(self.depths)


def swin_t(**kw) -> SwinConfig:
    return SwinConfig(**kw)


# ---------------------------------------------------------------------------
# parameters (torchvision names)
# ---------------------------------------------------------------------------


def _rel_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, ww, ww)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


class WindowAttentionParams(nn.Module):
    def __init__(self, dim: int, heads: int, w: int, gen):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, gen)
        self.proj = Linear(dim, dim, gen)
        self.relative_position_bias_table = trunc_normal(((2 * w - 1) ** 2, heads), gen)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_index(w)), persistent=False)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cfg: SwinConfig, gen):
        super().__init__()
        hidden = int(dim * cfg.mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttentionParams(dim, heads, cfg.window, gen)
        self.norm2 = LayerNorm(dim)
        # torchvision's MLP is Sequential(Linear, GELU, Dropout, Linear, Dropout)
        self.mlp = nn.ModuleList([Linear(dim, hidden, gen), nn.Identity(), nn.Identity(),
                                  Linear(hidden, dim, gen)])


class PatchMerging(nn.Module):
    def __init__(self, dim: int, gen):
        super().__init__()
        self.reduction = nn.Module()
        self.reduction.weight = trunc_normal((2 * dim, 4 * dim), gen)
        self.norm = LayerNorm(4 * dim)


class SwinTransformer(nn.Module):
    """Parameters of one Swin; the forward is ``swin_forward``."""

    def __init__(self, cfg: SwinConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.embed_dim
        stem = nn.Module()
        stem.weight = trunc_normal((d, 3, p, p), gen)
        stem.bias = nn.Parameter(torch.zeros(d))
        # torchvision: Sequential(Conv2d, Permute, LayerNorm)
        features = [nn.ModuleList([stem, nn.Identity(), LayerNorm(d)])]
        for s, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            features.append(nn.ModuleList([SwinBlock(d, heads, cfg, gen) for _ in range(depth)]))
            if s < len(cfg.depths) - 1:
                features.append(PatchMerging(d, gen))
                d *= 2
        self.features = nn.ModuleList(features)
        self.norm = LayerNorm(d)

    def forward(self, x, generator=None, deterministic=True, dp_masks=None):
        return swin_forward(self, x, generator, deterministic, dp_masks)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def _window_reverse(win: torch.Tensor, w: int, B: int, H: int, W: int) -> torch.Tensor:
    C = win.shape[-1]
    x = win.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """(nW, ww, ww) additive mask, -100 on pairs from different regions of
    the cyclically shifted map."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def _pad_mask(H: int, W: int, Hp: int, Wp: int, w: int) -> Optional[np.ndarray]:
    """(nW, 1, ww) additive mask hiding the bottom/right padding as keys, or
    None when nothing is padded."""
    if (H, W) == (Hp, Wp):
        return None
    valid = np.zeros((Hp, Wp), np.float32)
    valid[H:, :] = 1.0
    valid[:, W:] = 1.0
    win = valid.reshape(Hp // w, w, Wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return (win[:, None, :] * -100.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _attn_mask(H: int, W: int, w: int, shift: int, device: torch.device) -> Optional[torch.Tensor]:
    """The block's window mask on ``device``: shift (+ pad) (nW, ww, ww),
    pad only (nW, 1, ww), or None. Built and uploaded once per map size,
    shift and device."""
    Hp, Wp = -(-H // w) * w, -(-W // w) * w
    mask = _pad_mask(H, W, Hp, Wp, w)
    if shift:
        shifted = _shift_mask(Hp, Wp, w, shift)
        mask = shifted if mask is None else shifted + mask
    return None if mask is None else torch.from_numpy(mask).to(device)


def _window_attention(x, attn: WindowAttentionParams, heads: int, mask):
    """x (nB, ww, C) -> (nB, ww, C): qkv, attention with the gathered
    (heads, ww, ww) relative bias, proj. Every stage takes
    ``window_attention``: K7/K8 on the card, the plain version on the CPU.
    (The JAX package gates its TPU kernel to heads <= 6, a threshold
    measured on a TPU; the CUDA kernel has no head limit.)"""
    C = x.shape[-1]
    qkv = linear(x, attn.qkv)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]  # strided views
    table = attn.relative_position_bias_table
    bias = table[attn.relative_position_index].permute(2, 0, 1).contiguous()
    return linear(window_attention(q, k, v, bias, mask, heads), attn.proj)


def _swin_block(x, blk: SwinBlock, heads: int, cfg: SwinConfig, shift: int, keep, masks):
    """One block; ``masks`` (2, B) keep-decisions of the two residual
    branches, or None (no DropPath)."""
    B, H, W, C = x.shape
    w, eps = cfg.window, cfg.layernorm_eps
    Hp, Wp = -(-H // w) * w, -(-W // w) * w
    y = layer_norm(x, blk.norm1, eps)
    if (Hp, Wp) != (H, W):
        y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    win = _window_attention(_window_partition(y, w), blk.attn, heads,
                            _attn_mask(H, W, w, shift, x.device))
    y = _window_reverse(win, w, B, Hp, Wp)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    y = y[:, :H, :W]
    if masks is not None:
        y = _drop_path(y, keep, masks[0])
    x = x + y
    y = layer_norm(x, blk.norm2, eps)
    y = F.gelu(linear(y, blk.mlp[0]), approximate="tanh" if cfg.gelu_approx else "none")
    y = linear(y, blk.mlp[3])
    if masks is not None:
        y = _drop_path(y, keep, masks[1])
    return x + y


def _patch_merge(x: torch.Tensor, merge: PatchMerging, eps: float) -> torch.Tensor:
    """2x2 neighbours -> 4C channels -> LayerNorm -> 2C (no bias); odd
    sides are padded by one at the bottom/right."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    x = layer_norm(x, merge.norm, eps)
    return F.linear(x, merge.reduction.weight.to(x.dtype))


def drop_path_masks(cfg: SwinConfig, batch: int, generator: torch.Generator, device) -> torch.Tensor:
    """Every (block, branch, sample) keep-decision in one draw: (blocks, 2, B) bool."""
    keeps = 1.0 - torch.linspace(0.0, cfg.drop_path_rate, cfg.num_blocks, device=device)
    keep_p = keeps.reshape(-1, 1, 1).expand(cfg.num_blocks, 2, batch)
    return pd.global_bernoulli(keep_p, generator, 2).bool()


def swin_forward(
    model: SwinTransformer,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, 3) -> pooled embedding (B, out_dim) f32. DropPath runs when
    ``deterministic`` is False and the rate is positive: keep-decisions come
    from ``dp_masks`` ((blocks, 2, B) bool) if given, else from one draw on
    ``generator``."""
    cfg = model.cfg
    B, H, W, C = x.shape
    p, dt, eps = cfg.patch_size, cfg.compute_dtype, cfg.layernorm_eps
    stem, _, stem_norm = model.features[0]
    kernel = stem.weight.permute(2, 3, 1, 0).reshape(p * p * C, cfg.embed_dim)
    t = patchify(x.to(dt), p) @ kernel.to(dt) + stem.bias.to(dt)
    t = layer_norm(t.reshape(B, H // p, W // p, cfg.embed_dim), stem_norm, eps)

    keeps = 1.0 - torch.linspace(0.0, cfg.drop_path_rate, cfg.num_blocks, device=x.device)
    if deterministic or cfg.drop_path_rate <= 0 or (dp_masks is None and generator is None):
        dp_masks = None
    elif dp_masks is None:
        dp_masks = drop_path_masks(cfg, B, generator, x.device)

    i = 0
    for s, heads in enumerate(cfg.num_heads):
        for b, blk in enumerate(model.features[2 * s + 1]):
            # odd blocks shift, when the map is larger than one window
            shift = cfg.window // 2 if b % 2 and min(t.shape[1], t.shape[2]) > cfg.window else 0
            t = _swin_block(t, blk, heads, cfg, shift, keeps[i],
                            None if dp_masks is None else dp_masks[i])
            i += 1
        if 2 * s + 2 < len(model.features):
            t = _patch_merge(t, model.features[2 * s + 2], eps)
    t = layer_norm(t, model.norm, eps)
    return t.float().mean(dim=(1, 2))
