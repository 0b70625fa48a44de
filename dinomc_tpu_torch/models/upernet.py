"""UPerNet segmentation model on DINO ViT features, in PyTorch.

Counterpart of ``dinomc_tpu/models/upernet.py`` (reference mmseg stack,
``models/networks.py:17-317``): ViT token taps at ``out_indices``, CLS
stripped, reshaped to feature maps and resized to a pseudo-pyramid
[2·Hf, Hf, Hf/2, Hf/4]; the UPerHead (PSP over the coarsest level, FPN
top-down fusion, a fusing conv and a 1x1 classifier); the auxiliary
FCNHead on pyramid level ``aux_in_index``; an optional FPN neck.

Parameters carry mmseg's names (``backbone.vit.*``,
``decode_head.psp_modules.{i}.1.*``, ``decode_head.bottleneck``,
``decode_head.{lateral_convs,fpn_convs}.{i}``, ``decode_head.fpn_bottleneck``,
``decode_head.conv_seg``, ``auxiliary_head.*``, ``neck.*``), so the state
dict that ``dinomc_tpu.ckpt.torch_export.upernet_state_dict`` writes loads
with ``strict=True``. Images and logits are NHWC at ``upernet_forward``, as
in the JAX package; the decoder runs NCHW.
BatchNorm running statistics move in place during a training forward.

With a ``mesh`` whose ``seq`` axis is > 1 (``core/mesh.py``) the backbone
runs sequence-parallel (``models/vit.vit_forward_sp``: ring attention over
token blocks, the batch also split over ``data`` where it divides), as JAX
``dino_pyramid`` does (``dinomc_tpu/models/upernet.py:162-173``); its taps
are gathered back, so the decoder sees the whole batch on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from dinomc_tpu_torch.models import layers
from dinomc_tpu_torch.models.vit import (
    VIT_FACTORIES,
    VisionTransformer,
    ViTConfig,
    vit_forward_sp,
    vit_intermediate_layers,
)

@dataclasses.dataclass(frozen=True)
class UPerNetConfig:
    num_classes: int = 8
    arch: str = "vit_small"
    patch_size: int = 8
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)
    channels: int = 512
    pool_scales: Tuple[int, ...] = (1, 2, 3, 6)
    aux_channels: int = 256
    aux_in_index: int = 2
    dropout_rate: float = 0.1
    use_fpn_neck: bool = False
    aux_loss_weight: float = 0.4  # mmseg default for the auxiliary FCNHead
    # The ViT and the 512-channel decoder convs run in this dtype; BN
    # statistics and the final logits are f32. float32 for strict parity.
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def embed_dim(self) -> int:
        return VIT_FACTORIES[self.arch]().embed_dim

    def vit_config(self, img_size: int = 224) -> ViTConfig:
        cfg = VIT_FACTORIES[self.arch](patch_size=self.patch_size, img_size=img_size)
        return dataclasses.replace(cfg, compute_dtype=self.compute_dtype)


def _neck_conv(k: int, c: int, gen) -> nn.Module:
    """mmseg's bias-carrying ``ConvModule`` without norm: ``{i}.conv.*``."""
    m = nn.Module()
    m.conv = layers.Conv2d(k, c, c, gen)
    return m


class UPerNet(nn.Module):
    """Parameters of the model; the forward is ``upernet_forward``."""

    def __init__(self, cfg: UPerNetConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D, C, L = cfg.embed_dim, cfg.channels, len(cfg.out_indices)
        self.backbone = nn.Module()
        self.backbone.vit = VisionTransformer(cfg.vit_config(), gen)
        if cfg.use_fpn_neck:  # 1x1 lateral + 3x3 out conv per level, D -> D
            self.neck = nn.Module()
            self.neck.lateral_convs = nn.ModuleList(_neck_conv(1, D, gen) for _ in range(L))
            self.neck.fpn_convs = nn.ModuleList(_neck_conv(3, D, gen) for _ in range(L))
        head = nn.Module()
        # index 0 of each PSP branch is mmseg's parameter-free pooling
        head.psp_modules = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s), layers.ConvBNReLU(1, D, C, gen))
            for s in cfg.pool_scales
        )
        head.bottleneck = layers.ConvBNReLU(3, D + len(cfg.pool_scales) * C, C, gen)
        head.lateral_convs = nn.ModuleList(layers.ConvBNReLU(1, D, C, gen) for _ in range(L - 1))
        head.fpn_convs = nn.ModuleList(layers.ConvBNReLU(3, C, C, gen) for _ in range(L - 1))
        head.fpn_bottleneck = layers.ConvBNReLU(3, L * C, C, gen)
        head.conv_seg = layers.Conv2d(1, C, cfg.num_classes, gen)
        self.decode_head = head
        aux = nn.Module()
        aux.convs = nn.ModuleList([layers.ConvBNReLU(3, D, cfg.aux_channels, gen)])
        aux.conv_seg = layers.Conv2d(1, cfg.aux_channels, cfg.num_classes, gen)
        self.auxiliary_head = aux


def dino_pyramid(model: UPerNet, x: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, ...]:
    """(B, H, W, 3) images -> four (B, D, h, w) maps at strides {4, 8, 16, 32}
    of the patch grid, in the compute dtype (reference
    ``DinoMCBackbone.forward``, ``networks.py:208-241``). The taps are the
    raw block outputs, not final-LayerNormed. ``mesh`` with seq > 1: the
    sequence-parallel backbone."""
    cfg = model.cfg
    B, H, W, _ = x.shape
    if mesh is not None and mesh.size("seq") > 1:
        taps = vit_forward_sp(model.backbone.vit, x, mesh, out_indices=cfg.out_indices,
                              apply_norm=False)
    else:
        taps = vit_intermediate_layers(model.backbone.vit, x, cfg.out_indices, apply_norm=False)
    Hf, Wf = H // cfg.patch_size, W // cfg.patch_size
    sizes = [(2 * Hf, 2 * Wf), (Hf, Wf), (Hf // 2, Wf // 2), (Hf // 4, Wf // 4)]
    pyramid = []
    for t, hw in zip(taps, sizes):
        f = t[:, 1:].to(cfg.compute_dtype).reshape(B, Hf, Wf, cfg.embed_dim)
        f = f.permute(0, 3, 1, 2)
        if f.shape[2:] != hw:
            f = layers.resize_bilinear(f, hw)
        pyramid.append(f)
    return tuple(pyramid)


def _psp_forward(model: UPerNet, x: torch.Tensor, train: bool) -> torch.Tensor:
    """PSP: adaptive pools at ``pool_scales`` + the input, concatenated, then
    the 3x3 bottleneck."""
    head = model.decode_head
    outs = [x]
    for branch, scale in zip(head.psp_modules, model.cfg.pool_scales):
        y = layers.conv_bn_relu_apply(branch[1], layers.adaptive_avg_pool(x, scale), train)
        outs.append(layers.resize_bilinear(y, x.shape[2:]))
    return layers.conv_bn_relu_apply(head.bottleneck, torch.cat(outs, dim=1), train)


def _dropout(y, train, rate, key, generator, drop_masks: Optional[Dict]):
    """Dropout with the keep-mask ``drop_masks[key]`` if given, else drawn
    from ``generator``; none without either, or outside training."""
    if not train or rate <= 0.0:
        return y
    if drop_masks is not None:
        mask = drop_masks[key]
    elif generator is not None:
        mask = layers.dropout_mask(generator, y.shape, rate, y.device)
    else:
        return y
    return layers.dropout(y, mask, rate)


def _logits(y: torch.Tensor, hw) -> torch.Tensor:
    """(B, C, h, w) -> f32 NHWC logits at the input size."""
    return layers.resize_bilinear(y.float(), hw).permute(0, 2, 3, 1)


def upernet_forward(
    model: UPerNet,
    x: torch.Tensor,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    with_aux: bool = False,
    stop_backbone_grad: bool = False,
    drop_masks: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
):
    """'whole'-mode forward of (B, H, W, 3) images. Returns logits
    (B, H, W, num_classes) f32, and the auxiliary logits as well with
    ``with_aux``. In training, dropout (before each classifier) takes its
    keep-masks from ``drop_masks`` ({'decode', 'aux'}, NCHW bool) or draws
    them from ``generator``.

    ``stop_backbone_grad`` runs the backbone without autograd, so the
    backward stops at the pyramid and skips the whole ViT (decoder-only
    fine-tuning, the reference's ``train_backbone=False``). ``mesh``: see
    ``dino_pyramid``."""
    cfg = model.cfg
    hw_in = x.shape[1:3]
    if stop_backbone_grad:
        with torch.no_grad():
            pyramid = dino_pyramid(model, x, mesh)
    else:
        pyramid = dino_pyramid(model, x, mesh)

    if cfg.use_fpn_neck:
        pyramid = tuple(
            layers.conv_apply(o.conv, layers.conv_apply(lat.conv, f))
            for f, lat, o in zip(pyramid, model.neck.lateral_convs, model.neck.fpn_convs)
        )

    head = model.decode_head
    laterals = [
        layers.conv_bn_relu_apply(m, f, train) for m, f in zip(head.lateral_convs, pyramid[:-1])
    ]
    laterals.append(_psp_forward(model, pyramid[-1], train))
    for i in range(len(laterals) - 1, 0, -1):  # top-down pathway
        laterals[i - 1] = laterals[i - 1] + layers.resize_bilinear(
            laterals[i], laterals[i - 1].shape[2:])
    # per-level fpn convs; the top level passes through (mmseg semantics)
    outs = [layers.conv_bn_relu_apply(m, f, train) for m, f in zip(head.fpn_convs, laterals)]
    outs.append(laterals[-1])
    hw0 = outs[0].shape[2:]
    outs = [outs[0]] + [layers.resize_bilinear(f, hw0) for f in outs[1:]]
    y = layers.conv_bn_relu_apply(head.fpn_bottleneck, torch.cat(outs, dim=1), train)
    y = _dropout(y, train, cfg.dropout_rate, "decode", generator, drop_masks)
    logits = _logits(layers.conv_apply(head.conv_seg, y), hw_in)
    if not with_aux:
        return logits

    aux = model.auxiliary_head
    ay = layers.conv_bn_relu_apply(aux.convs[0], pyramid[cfg.aux_in_index], train)
    ay = _dropout(ay, train, cfg.dropout_rate, "aux", generator, drop_masks)
    return logits, _logits(layers.conv_apply(aux.conv_seg, ay), hw_in)
