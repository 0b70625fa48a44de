"""Vision Transformer (DINO flavor) in PyTorch.

Counterpart of ``dinomc_tpu/models/vit.py``. Parameters carry the
reference's timm/DINO names (``patch_embed.proj.weight`` (D, 3, p, p),
``blocks.{i}.attn.qkv.weight`` (out, in), ...), so the state dict that
``dinomc_tpu_torch.ckpt.state_dicts.vit_state_dict`` writes loads with
``strict=True``. The forward mirrors the JAX one: patchify + one matmul for
the stride-p patch embed, bicubic position-embedding interpolation with the
reference's ``+0.1`` scale fudge, pre-norm blocks with f32 LayerNorm
statistics, per-sample DropPath (one keep-decision per packed segment), and
every matmul weight cast to ``compute_dtype`` at use. Casts are explicit;
no autocast. ``mlp_impl='fused'`` sends the MLP to K11
(``ops/hopper/fused_mlp.py``) with the same ``fc1``/``fc2`` tensors.

Remat (``ViTConfig.remat``, ``remat_policy``; the JAX package's
``_remat_block``): each block runs under ``torch.utils.checkpoint`` (not
reentrant) wherever autograd records, so its backward replays the block from
its input, keeping only what the policy names. The JAX package names ``qkv``
(the qkv projection), ``attn_out`` (the attention output) and ``mlp_h`` (the
GELU'd hidden activation of the dense MLP; the fused MLP has none), and
``dots`` keeps every matmul output. Two mechanisms, because a kernel launch
is not a dispatched op:

- ``attn_out``: the attention kernels' forward launches (K1, K4) go through
  ``ops/remat.kept``, which records their output and log-sum-exp (all that
  K2 and K5/K6 read) in the forward and hands them back in the replay, so
  the replay launches no attention forward.
- ``qkv``, ``mlp_h``, ``dots``: a selective-checkpoint policy
  (``create_selective_checkpoint_contexts``) keeps every dispatched op run
  inside a scope of that name (``dots``: every ``mm``/``addmm``). It
  intercepts every op of the block in Python, a host cost that ``full`` and
  ``attn`` do not pay.

K11's launch is kept by neither: no policy names it, and torch's replay runs
the block up to the last tensor the backward reads (DropPath's keep mask
after the MLP, or the fused MLP's saved inputs, which autograd packs after
its forward ran), so under remat the student's backward launches K11 once
more a block (the JAX package's recompute drops it as dead code). DropPath
keep-decisions are drawn once, outside the checkpointed blocks, so a replay
sees the same masks. Every policy computes the same numbers as no remat.

Not ported yet (ROADMAP.md queue 1 #3): ``vit_forward_multi``,
``vit_forward_sp`` and ``vit_last_selfattention``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dinomc_tpu_torch.ops import remat
from dinomc_tpu_torch.ops.attention import mha
from dinomc_tpu_torch.ops.hopper.fused_mlp import fused_mlp

# What each remat policy keeps (the JAX package's ``_remat_block``).
REMAT_POLICIES = {
    "full": (),
    "dots": ("dots",),
    "dots+attn": ("dots", "attn_out"),
    "attn": ("attn_out",),
    "attn+mlp": ("attn_out", "mlp_h"),
    "qkv+attn": ("qkv", "attn_out"),
    "qkv+attn+mlp": ("qkv", "attn_out", "mlp_h"),
}
MLP_IMPLS = ("dense", "fused")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    img_size: int = 224
    in_chans: int = 3
    drop_path_rate: float = 0.0
    layernorm_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16
    # tanh-approximate GELU (True, the JAX package's training default) vs
    # exact erf (False, the reference's nn.GELU).
    gelu_approx: bool = True
    # 'dense': fc1, GELU, fc2 as three ops; 'fused': K11 (ops/hopper/fused_mlp.py).
    mlp_impl: str = "dense"
    # Recompute each block in the backward, keeping what ``remat_policy``
    # names (REMAT_POLICIES; module docstring).
    remat: bool = True
    remat_policy: str = "attn"

    def __post_init__(self):
        if self.mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got {self.mlp_impl!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                             f"got {self.remat_policy!r}")

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


def vit_tiny(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=192, depth=12, num_heads=3, **kw)


def vit_small(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> ViTConfig:
    return ViTConfig(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kw)


def vit_test(patch_size: int = 4, **kw) -> ViTConfig:
    """Micro ViT for cross-framework parity tests."""
    kw.setdefault("img_size", 16)
    return ViTConfig(patch_size=patch_size, embed_dim=32, depth=3, num_heads=2, **kw)


VIT_FACTORIES = {
    "vit_tiny": vit_tiny,
    "vit_small": vit_small,
    "vit_base": vit_base,
    "vit_test": vit_test,
}


# ---------------------------------------------------------------------------
# parameters (timm/DINO names)
# ---------------------------------------------------------------------------


def trunc_normal(shape, gen: Optional[torch.Generator], std: float = 0.02) -> nn.Parameter:
    """Truncated normal at +-2 sigma (reference ``trunc_normal_``)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)
    return nn.Parameter(t)


class Linear(nn.Module):
    """Weight (out, in) and bias (out,); applied by ``linear`` in the
    compute dtype."""

    def __init__(self, d_in: int, d_out: int, gen: Optional[torch.Generator]):
        super().__init__()
        self.weight = trunc_normal((d_out, d_in), gen)
        self.bias = nn.Parameter(torch.zeros(d_out))


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, gen):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Module()
        self.proj.weight = trunc_normal((cfg.embed_dim, cfg.in_chans, p, p), gen)
        self.proj.bias = nn.Parameter(torch.zeros(cfg.embed_dim))


class Attention(nn.Module):
    def __init__(self, d: int, gen):
        super().__init__()
        self.qkv = Linear(d, 3 * d, gen)
        self.proj = Linear(d, d, gen)


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, gen):
        super().__init__()
        self.fc1 = Linear(d, hidden, gen)
        self.fc2 = Linear(hidden, d, gen)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, gen):
        super().__init__()
        self.norm1 = LayerNorm(cfg.embed_dim)
        self.attn = Attention(cfg.embed_dim, gen)
        self.norm2 = LayerNorm(cfg.embed_dim)
        self.mlp = Mlp(cfg.embed_dim, cfg.mlp_dim, gen)


class VisionTransformer(nn.Module):
    """Parameters of one ViT; the forward is ``vit_forward``."""

    def __init__(self, cfg: ViTConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg, gen)
        self.cls_token = trunc_normal((1, 1, D), gen)
        self.pos_embed = trunc_normal((1, cfg.num_patches + 1, D), gen)
        self.blocks = nn.ModuleList([Block(cfg, gen) for _ in range(cfg.depth)])
        self.norm = LayerNorm(D)

    def forward(self, x, generator=None, deterministic=True, dp_masks=None):
        return vit_forward(self, x, generator, deterministic, dp_masks)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, lin: Linear) -> torch.Tensor:
    """x @ W^T + b with W and b cast to x's dtype."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def layer_norm(x: torch.Tensor, ln: LayerNorm, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics; returns x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * ln.weight + ln.bias).to(x.dtype)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H//p * W//p, p*p*C) with (ph, pw, c) inner order;
    remainder pixels are dropped, like the reference's stride-p conv."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x[:, : gh * patch, : gw * patch, :]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


@functools.lru_cache(maxsize=64)
def _torch_bicubic_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """1-D (out, in) weights of torch ``F.interpolate(mode='bicubic',
    align_corners=False)`` with a given ``scale_factor``: source coordinate
    (i + 0.5)/scale - 0.5, cubic convolution with A = -0.75, edge-clamped
    taps, no renormalization, no antialias. Cached: the crop sizes are few."""
    a = -0.75
    xs = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    i0 = np.floor(xs)
    t = xs - i0

    def k_inner(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k_outer(x):  # 1 < |x| < 2
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a

    taps = np.stack([k_outer(t + 1.0), k_inner(t), k_inner(1.0 - t), k_outer(2.0 - t)], 0)
    W = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    for j in range(4):
        idx = np.clip(i0.astype(np.int64) - 1 + j, 0, in_size - 1)
        np.add.at(W, (rows, idx), taps[j])
    return W.astype(np.float32)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize the patch position embeddings to a (gh, gw) grid with the
    reference's bicubic ``scale_factor=(g_new + 0.1)/g_old``; the CLS
    position is kept. (1, 1 + g0*g0, D) -> (1, 1 + gh*gw, D)."""
    gh, gw = grid_hw
    _, n_plus_1, dim = pos_embed.shape
    g0 = int(math.sqrt(n_plus_1 - 1))
    if (gh, gw) == (g0, g0):
        return pos_embed
    dev = pos_embed.device
    patch_pos = pos_embed[0, 1:].reshape(g0, g0, dim).float()
    wh = torch.from_numpy(_torch_bicubic_matrix(g0, gh, (gh + 0.1) / g0)).to(dev)
    ww = torch.from_numpy(_torch_bicubic_matrix(g0, gw, (gw + 0.1) / g0)).to(dev)
    patch_pos = torch.einsum("hi,ijd->hjd", wh, patch_pos)
    patch_pos = torch.einsum("wj,hjd->hwd", ww, patch_pos)
    patch_pos = patch_pos.reshape(1, gh * gw, dim).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], patch_pos], dim=1)


# The op-level remat names whose scope is open, per thread (autograd may
# replay a block on its own device thread): the selective-checkpoint policy
# reads the innermost. Forward and replay run the same code, so they see the
# same scopes, as the policy requires.
class _Scopes(threading.local):
    def __init__(self):
        self.names: list = []


_SCOPES = _Scopes()


@contextlib.contextmanager
def _named(name: str):
    """Scope of the ops producing the tensor a remat policy may keep by
    ``name`` (the JAX package's ``checkpoint_name``)."""
    _SCOPES.names.append(name)
    try:
        yield
    finally:
        _SCOPES.names.pop()


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _Contexts:
    """Context managers entered and left together."""

    def __init__(self, *managers):
        self.managers = managers

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        for m in self.managers:
            self.stack.enter_context(m)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def _remat_contexts(policy: str):
    """``checkpoint``'s ``context_fn`` for a policy that keeps something:
    the kernel record for ``attn_out``, the selective-checkpoint policy for
    the op-level names."""
    keep = REMAT_POLICIES[policy]
    op_names = tuple(k for k in keep if k != "attn_out")

    def decide(ctx, op, *args, **kwargs):
        scopes = _SCOPES.names
        if (scopes and scopes[-1] in op_names) or ("dots" in op_names and op in _MATMULS):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn():
        pairs = ([remat.contexts()] if "attn_out" in keep else []) + (
            [create_selective_checkpoint_contexts(decide)] if op_names else [])
        return _Contexts(*(f for f, _ in pairs)), _Contexts(*(r for _, r in pairs))

    return context_fn


def _remat(cfg: ViTConfig, fn, *args):
    """``fn(*args)``, replayed in the backward under ``cfg``'s policy when
    ``cfg.remat`` and autograd records (the JAX package's ``_remat_block``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if not REMAT_POLICIES[cfg.remat_policy]:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_remat_contexts(cfg.remat_policy))


def _attention(x: torch.Tensor, attn: Attention, num_heads: int, boundary: int):
    B, N, D = x.shape
    hd = D // num_heads
    w, b = attn.qkv.weight.to(x.dtype), attn.qkv.bias.to(x.dtype)
    with _named("qkv"):
        qkv = F.linear(x, w, b)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).unbind(2)  # strided (B, N, h, hd) views
    out = mha(q, k, v, 1.0 / math.sqrt(hd), boundary=boundary)
    return linear(out.reshape(B, N, D), attn.proj)


def _mlp(x: torch.Tensor, mlp: Mlp, gelu_approx: bool, impl: str = "dense") -> torch.Tensor:
    if impl == "fused":
        B, N, D = x.shape
        dt = x.dtype
        y = fused_mlp(x.reshape(B * N, D), mlp.fc1.weight.to(dt), mlp.fc1.bias.to(dt),
                      mlp.fc2.weight.to(dt), mlp.fc2.bias.to(dt), gelu_approx)
        return y.reshape(B, N, D)
    y = linear(x, mlp.fc1)
    with _named("mlp_h"):
        y = F.gelu(y, approximate="tanh" if gelu_approx else "none")
    return linear(y, mlp.fc2)


def _drop_path(x: torch.Tensor, keep: torch.Tensor, mask: torch.Tensor, boundary: int = 0):
    """Per-sample stochastic depth. ``mask``: (B,) keep-decisions, or (B, 2)
    with one decision per packed segment when ``boundary`` is nonzero;
    kept samples scale by 1/keep."""
    if boundary:
        tok = torch.arange(x.shape[1], device=x.device)[None, :]
        m = torch.where(tok < boundary, mask[:, :1], mask[:, 1:])[..., None]
    else:
        m = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    scale = (1.0 / keep).to(x.dtype)
    return torch.where(m, x * scale, torch.zeros_like(x))


def _block(x, blk: Block, cfg: ViTConfig, keep, masks, boundary: int):
    """One pre-norm block; ``masks`` (2, B[, 2]) or None (no DropPath)."""
    eps = cfg.layernorm_eps
    y = _attention(layer_norm(x, blk.norm1, eps), blk.attn, cfg.num_heads, boundary)
    if masks is not None:
        y = _drop_path(y, keep, masks[0], boundary)
    x = x + y
    y = _mlp(layer_norm(x, blk.norm2, eps), blk.mlp, cfg.gelu_approx, cfg.mlp_impl)
    if masks is not None:
        y = _drop_path(y, keep, masks[1], boundary)
    return x + y


def prepare_tokens(vit: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """Patchify + project + CLS + interpolated position embedding.
    x: (B, H, W, C) -> (B, 1 + gh*gw, D) in the compute dtype."""
    cfg = vit.cfg
    B, H, W, C = x.shape
    p = cfg.patch_size
    dt = cfg.compute_dtype
    w = vit.patch_embed.proj.weight  # (D, C, p, p) -> (p*p*C, D)
    kernel = w.permute(2, 3, 1, 0).reshape(p * p * C, cfg.embed_dim)
    tokens = patchify(x.to(dt), p) @ kernel.to(dt) + vit.patch_embed.proj.bias.to(dt)
    cls = vit.cls_token.to(dt).expand(B, 1, cfg.embed_dim)
    tokens = torch.cat([cls, tokens], dim=1)
    pos = interpolate_pos_embed(vit.pos_embed, (H // p, W // p))
    return tokens + pos.to(dt)


def drop_path_masks(
    cfg: ViTConfig, batch: int, packed: bool, generator: torch.Generator, device,
) -> torch.Tensor:
    """Every (layer, branch, sample[, segment]) keep-decision in one draw:
    (L, 2, B) or (L, 2, B, 2) bool."""
    keeps = 1.0 - torch.linspace(0.0, cfg.drop_path_rate, cfg.depth, device=device)
    shape = (cfg.depth, 2, batch) + ((2,) if packed else ())
    keep_p = keeps.reshape((cfg.depth, 1, 1) + ((1,) if packed else ())).expand(shape)
    return torch.bernoulli(keep_p, generator=generator).bool()


def _run_blocks(vit, tokens, generator, deterministic, dp_masks, boundary=0):
    cfg = vit.cfg
    keeps = 1.0 - torch.linspace(0.0, cfg.drop_path_rate, cfg.depth, device=tokens.device)
    if deterministic or (dp_masks is None and generator is None):
        dp_masks = None
    elif dp_masks is None:
        dp_masks = drop_path_masks(cfg, tokens.shape[0], bool(boundary), generator, tokens.device)
    x = tokens
    for i, blk in enumerate(vit.blocks):
        masks = None if dp_masks is None else dp_masks[i]
        x = _remat(cfg, _block, x, blk, cfg, keeps[i], masks, boundary)
    return x


def _cls_out(vit: VisionTransformer, x: torch.Tensor, index: int) -> torch.Tensor:
    """Final LayerNorm of one token position (the norm is per token, so
    this equals normalizing every token and slicing), as f32."""
    return layer_norm(x[:, index], vit.norm, vit.cfg.layernorm_eps).float()


def vit_forward(
    vit: VisionTransformer,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, C) -> final-LN CLS token (B, D) f32. DropPath runs when
    ``deterministic`` is False: keep-decisions come from ``dp_masks``
    ((L, 2, B) bool) if given, else from one draw on ``generator``."""
    out = _run_blocks(vit, prepare_tokens(vit, x), generator, deterministic, dp_masks)
    return _cls_out(vit, out, 0)


def vit_forward_packed(
    vit: VisionTransformer,
    xa: torch.Tensor,
    xb: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    dp_masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two crop batches packed into one token sequence; exactly
    ``vit_forward(xa)``, ``vit_forward(xb)``: attention is block-diagonal at
    the boundary and DropPath draws one decision per segment
    (``dp_masks`` (L, 2, B, 2)). Returns (cls_a, cls_b), each (B, D) f32."""
    ta = prepare_tokens(vit, xa)
    tb = prepare_tokens(vit, xb)
    boundary = ta.shape[1]
    out = _run_blocks(vit, torch.cat([ta, tb], dim=1), generator, deterministic, dp_masks, boundary)
    return _cls_out(vit, out, 0), _cls_out(vit, out, boundary)


def vit_intermediate_layers(
    vit: VisionTransformer,
    x: torch.Tensor,
    out_indices: Sequence[int] = (3, 5, 7, 11),
    apply_norm: bool = True,
) -> torch.Tensor:
    """Token maps of the blocks in ``out_indices``, without DropPath:
    (len(out_indices), B, N+1, D) f32. ``apply_norm`` applies the final
    LayerNorm to each (the reference's ``get_intermediate_layers``);
    ``apply_norm=False`` taps the raw block outputs, as the segmentation
    backbone does (``DinoMCBackbone.forward``)."""
    cfg = vit.cfg
    x = prepare_tokens(vit, x)
    taps = {}
    for i, blk in enumerate(vit.blocks[: max(out_indices) + 1]):
        x = _remat(cfg, _block, x, blk, cfg, None, None, 0)
        taps[i] = x
    out = [taps[i] for i in out_indices]
    if apply_norm:
        out = [layer_norm(t, vit.norm, cfg.layernorm_eps) for t in out]
    return torch.stack([t.float() for t in out])
