"""ResNet-50 / Wide-ResNet-50-2 backbones with BatchNorm, in PyTorch.

Counterpart of ``dinomc_tpu/models/resnet.py``. The reference builds these
from torchvision by name for the convnet DINO runs, the EuroSAT and
BigEarthNet fine-tunes and the OSCD siamese encoder
(``main_dino_mc.py:223-229``, ``main_eurosat.py:40-48``,
``main_oscd.py:145-157``). The modules carry torchvision's names
(``conv1``, ``bn1``, ``layer{1..4}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``,
``downsample.0`` / ``.1``), the layout
``dinomc_tpu.ckpt.torch_export.resnet_state_dict`` writes, so a
torchvision ``.pth``'s backbone loads with ``strict=True``. The module is
the backbone alone: a classifier on it is ``train/cls_trainer``'s
``fc``, which ``ckpt/torch_import`` maps to torchvision's ``fc.*``. BatchNorm's running
statistics are the modules' buffers: a forward with ``train=True``
normalizes by the batch and moves them in place (``models/layers.bn_apply``),
where the JAX function returns a new state tree.

Inputs are (B, H, W, 3) as in the JAX package; inside, tensors are NCHW
(an NHWC input permuted, so cuDNN sees channels-last strides), and the
feature taps come back as NHWC views.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dinomc_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width_per_group: int = 64  # 128: wide_resnet50_2
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def out_dim(self) -> int:
        return 2048


def resnet50(**kw) -> ResNetConfig:
    return ResNetConfig(**kw)


def wide_resnet50_2(**kw) -> ResNetConfig:
    return ResNetConfig(width_per_group=128, **kw)


def resnet_test(**kw) -> ResNetConfig:
    """Micro ResNet, one bottleneck a stage, for the parity tests."""
    return ResNetConfig(stage_sizes=(1, 1, 1, 1), **kw)


RESNET_FACTORIES = {
    "resnet50": resnet50,
    "wide_resnet50_2": wide_resnet50_2,
    "resnet_test": resnet_test,
}


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, width: int, c_out: int, down: bool, gen):
        super().__init__()
        self.conv1 = layers.Conv2d(1, c_in, width, gen, bias=False)
        self.bn1 = layers.BatchNorm(width)
        self.conv2 = layers.Conv2d(3, width, width, gen, bias=False)
        self.bn2 = layers.BatchNorm(width)
        self.conv3 = layers.Conv2d(1, width, c_out, gen, bias=False)
        self.bn3 = layers.BatchNorm(c_out)
        if down:
            self.downsample = nn.Sequential(
                layers.Conv2d(1, c_in, c_out, gen, bias=False), layers.BatchNorm(c_out))


class ResNet(nn.Module):
    """Parameters and BatchNorm buffers of one ResNet; the forward is
    ``resnet_forward``."""

    def __init__(self, cfg: ResNetConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = layers.Conv2d(7, 3, 64, gen, bias=False)
        self.bn1 = layers.BatchNorm(64)
        c_in = 64
        for stage, blocks in enumerate(cfg.stage_sizes):
            planes = 64 * 2**stage
            width = planes * cfg.width_per_group // 64
            stage_blocks = []
            for b in range(blocks):
                stage_blocks.append(Bottleneck(c_in, width, planes * 4, b == 0, gen))
                c_in = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stage_blocks))

    def forward(self, x, train: bool = False):
        return resnet_forward(self, x, train)


def _conv_bn(conv, bn, x, train, stride=1, relu=True):
    y = layers.bn_apply(bn, layers.conv_apply(conv, x, stride), train)
    return F.relu(y) if relu else y


def _bottleneck(blk: Bottleneck, x: torch.Tensor, train: bool, stride: int) -> torch.Tensor:
    y = _conv_bn(blk.conv1, blk.bn1, x, train)
    y = _conv_bn(blk.conv2, blk.bn2, y, train, stride)
    y = _conv_bn(blk.conv3, blk.bn3, y, train, relu=False)
    if hasattr(blk, "downsample"):
        x = _conv_bn(blk.downsample[0], blk.downsample[1], x, train, stride, relu=False)
    return F.relu(y + x)


def resnet_features(
    model: ResNet, x: torch.Tensor, train: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """x (B, H, W, 3) -> (5 NHWC feature maps of 64/256/512/1024/2048
    channels at strides 2/4/8/16/32, pooled (B, 2048) f32). With ``train``
    every BatchNorm normalizes by the batch and moves its running
    statistics once."""
    y = x.to(model.cfg.compute_dtype).permute(0, 3, 1, 2)
    y = _conv_bn(model.conv1, model.bn1, y, train, stride=2)
    feats = [y]
    y = F.max_pool2d(y, 3, 2, 1)  # pads with -inf, as the JAX reduce_window
    for stage in range(len(model.cfg.stage_sizes)):
        for b, blk in enumerate(getattr(model, f"layer{stage + 1}")):
            y = _bottleneck(blk, y, train, 2 if (b == 0 and stage > 0) else 1)
        feats.append(y)
    pooled = y.float().mean(dim=(2, 3))
    return tuple(f.permute(0, 2, 3, 1) for f in feats), pooled


def resnet_forward(model: ResNet, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """Backbone embedding (B, 2048) f32."""
    return resnet_features(model, x, train)[1]
