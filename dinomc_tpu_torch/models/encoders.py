"""Encoder registry: the ViTs, Swin-T, the ResNets and XCiT.

Counterpart of ``dinomc_tpu/models/encoders.py``: one interface the DINO
and classification trainers call without knowing the architecture. The
ResNets' BatchNorm state lives in the modules' buffers: ``apply`` with
``train`` normalizes by the batch and moves them in place, where the JAX
``apply`` returns a new state tree, so ``apply`` returns the embeddings
alone. XCiT's LPI BatchNorm keeps no state: it normalizes by the batch
whether ``train`` or not. Only the ViTs pack two crop batches into one
forward: Swin's shifted windows, XCiT's LPI and the convolutions would mix
them. XCiT's remat follows its own ``XCiTConfig`` (``full``), not
``remat_policy``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from dinomc_tpu_torch.models import resnet as rn
from dinomc_tpu_torch.models import swin as sw
from dinomc_tpu_torch.models import vit as vt
from dinomc_tpu_torch.models import xcit as xc

Encoder = Union[vt.VisionTransformer, sw.SwinTransformer, rn.ResNet, xc.XCiT]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # vit_tiny | vit_small | vit_base | vit_test | swin_t | resnet50 |
    # wide_resnet50_2 | resnet_test | xcit_small_12 | xcit_medium_24
    arch: str
    patch_size: int = 16  # ViT and XCiT: Swin-T's patch is 4, as in the JAX package
    img_size: int = 224
    drop_path_rate: float = 0.0  # student only
    remat_policy: str = "attn"  # ViT only; see models/vit.ViTConfig
    compute_dtype: torch.dtype = torch.bfloat16
    gelu_approx: bool = True

    def __post_init__(self):
        if not (self.is_vit or self.has_bn or self.is_xcit or self.arch == "swin_t"):
            raise ValueError(f"unknown encoder {self.arch!r}")

    @property
    def is_vit(self) -> bool:
        return self.arch in vt.VIT_FACTORIES

    @property
    def is_xcit(self) -> bool:
        return self.arch in xc.XCIT_FACTORIES

    @property
    def has_bn(self) -> bool:
        """The convnets: BatchNorm with running statistics."""
        return self.arch in rn.RESNET_FACTORIES

    @property
    def supports_packing(self) -> bool:
        """Plain global attention packs two crops losslessly with a
        block-diagonal mask."""
        return self.is_vit

    def vit_config(self) -> vt.ViTConfig:
        return vt.VIT_FACTORIES[self.arch](
            patch_size=self.patch_size,
            img_size=self.img_size,
            drop_path_rate=self.drop_path_rate,
            remat_policy=self.remat_policy,
            compute_dtype=self.compute_dtype,
            gelu_approx=self.gelu_approx,
        )

    def swin_config(self) -> sw.SwinConfig:
        return sw.swin_t(
            compute_dtype=self.compute_dtype,
            drop_path_rate=self.drop_path_rate,
            gelu_approx=self.gelu_approx,
        )

    def resnet_config(self) -> rn.ResNetConfig:
        return rn.RESNET_FACTORIES[self.arch](compute_dtype=self.compute_dtype)

    def xcit_config(self) -> xc.XCiTConfig:
        return xc.XCIT_FACTORIES[self.arch](
            patch_size=self.patch_size,
            compute_dtype=self.compute_dtype,
            drop_path_rate=self.drop_path_rate,
            gelu_approx=self.gelu_approx,
        )

    @property
    def embed_dim(self) -> int:
        if self.is_vit:
            return self.vit_config().embed_dim
        if self.has_bn:
            return self.resnet_config().out_dim
        if self.is_xcit:
            return self.xcit_config().embed_dim
        return self.swin_config().out_dim

    def build(self, gen: Optional[torch.Generator] = None) -> Encoder:
        """A freshly initialized encoder (parameters on the CPU)."""
        if self.is_vit:
            return vt.VisionTransformer(self.vit_config(), gen)
        if self.has_bn:
            return rn.ResNet(self.resnet_config(), gen)
        if self.is_xcit:
            return xc.XCiT(self.xcit_config(), gen)
        return sw.SwinTransformer(self.swin_config(), gen)

    def apply(
        self, model: Encoder, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, embed_dim) f32 embeddings. A convnet with
        ``train`` moves its BatchNorm buffers, once a BatchNorm a call."""
        if self.is_vit:
            return vt.vit_forward(model, x, generator, not train)
        if self.has_bn:
            return rn.resnet_forward(model, x, train)
        if self.is_xcit:
            return xc.xcit_forward(model, x, generator, not train)
        return sw.swin_forward(model, x, generator, not train)

    def apply_packed(
        self, model: vt.VisionTransformer, xa: torch.Tensor, xb: torch.Tensor,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two crop batches in one packed forward: exactly ``apply(xa)`` and
        ``apply(xb)`` with half the attention launches."""
        return vt.vit_forward_packed(model, xa, xb, generator, not train)
