"""Siamese change-detection model (OSCD), in PyTorch.

Counterpart of ``dinomc_tpu/models/siamese.py``; parity target the
reference's ``SiamSegment`` (``main_oscd.py:28-104``) around the
missing-upstream ``models.segmentation.get_segmentation_model`` (SeCo's
semantics, reconstructed in the JAX package): one shared ResNet / WRN
encoder (``models/resnet.py``) runs both timestamps; the per-level
differences |f_t1 - f_t2| of its five taps (64 / 256 / 512 / 1024 / 2048
channels at strides 2-32, ``main_oscd.py:167-168``), in f32, feed an FPN
decoder that fuses top-down (``layers.resize_bilinear``, JAX's antialiased
bilinear) to the finest level, a 3x3 smooth conv with ReLU, a resize to the
input and a 3x3 classifier to one change logit a pixel.

The encoder carries torchvision's names (``encoder.conv1.weight``, ...); the
decoder's follow the JAX tree (``lateral.{i}``, ``smooth``, ``classifier``),
since the reference's decoder module is missing upstream. Inputs are NHWC.

A frozen encoder (the reference trains the decoder only, ``:100-104``) runs
with its running statistics, which do not move, and without autograd, so
the backward skips both encoder passes (the JAX package's
``stop_gradient``). An encoder in training moves its BatchNorm statistics
twice a forward, t1 then t2, in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dinomc_tpu_torch.models import layers
from dinomc_tpu_torch.models.resnet import RESNET_FACTORIES, ResNet, ResNetConfig, resnet_features

FEATURE_CHANNELS = (64, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class SiameseConfig:
    arch: str = "resnet50"  # resnet50 | wide_resnet50_2 | resnet_test
    decoder_channels: int = 128
    freeze_encoder: bool = True  # the reference trains the decoder only

    def rn_cfg(self) -> ResNetConfig:
        """The encoder's config: its convolutions in bf16, the ResNet's
        default, as in the JAX package; the differences and the decoder
        run in f32."""
        return RESNET_FACTORIES[self.arch]()


class Siamese(nn.Module):
    """Parameters and BatchNorm buffers; the forward is ``siamese_forward``."""

    def __init__(self, cfg: SiameseConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        C = cfg.decoder_channels
        self.encoder = ResNet(cfg.rn_cfg(), gen)
        self.lateral = nn.ModuleList(layers.Conv2d(1, c, C, gen) for c in FEATURE_CHANNELS)
        self.smooth = layers.Conv2d(3, C, C, gen)
        self.classifier = layers.Conv2d(3, C, 1, gen)


def _taps(model: Siamese, x1: torch.Tensor, x2: torch.Tensor, train: bool):
    """The encoder's five NCHW taps for each timestamp."""
    f1 = resnet_features(model.encoder, x1, train)[0]
    f2 = resnet_features(model.encoder, x2, train)[0]
    return ([f.permute(0, 3, 1, 2) for f in f1], [f.permute(0, 3, 1, 2) for f in f2])


def siamese_forward(
    model: Siamese,
    x1: torch.Tensor,  # (B, H, W, 3) timestamp 1
    x2: torch.Tensor,  # (B, H, W, 3) timestamp 2
    train: bool = False,
) -> torch.Tensor:
    """Change logits (B, H, W) f32. With ``train`` and an unfrozen encoder,
    its BatchNorms normalize by the batch and move their statistics, once for
    each timestamp."""
    _, H, W, _ = x1.shape
    if model.cfg.freeze_encoder:
        with torch.no_grad():
            f1, f2 = _taps(model, x1, x2, False)
    else:
        f1, f2 = _taps(model, x1, x2, train)
    diffs = [(a.float() - b.float()).abs() for a, b in zip(f1, f2)]

    # FPN top-down over the |diff| levels; y ends at the finest (stride 2)
    lat = [layers.conv_apply(conv, d) for conv, d in zip(model.lateral, diffs)]
    y = lat[-1]
    for i in range(len(lat) - 2, -1, -1):
        y = lat[i] + layers.resize_bilinear(y, lat[i].shape[2:])
    y = F.relu(layers.conv_apply(model.smooth, y))
    y = layers.resize_bilinear(y, (H, W))
    return layers.conv_apply(model.classifier, y)[:, 0].float()
