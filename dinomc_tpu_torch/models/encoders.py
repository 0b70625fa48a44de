"""Encoder registry: the ViTs and Swin-T.

Counterpart of ``dinomc_tpu/models/encoders.py``: one interface the DINO
trainer calls without knowing the architecture. The ViTs and Swin-T are
ported; every other architecture raises ``NotImplementedError`` naming its
ROADMAP.md item. Neither has BatchNorm state, so ``apply`` returns the
embeddings alone. Only the ViTs pack two crop batches into one forward:
Swin's shifted windows would mix them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from dinomc_tpu_torch.models import swin as sw
from dinomc_tpu_torch.models import vit as vt

Encoder = Union[vt.VisionTransformer, sw.SwinTransformer]

_NOT_PORTED = {
    "resnet50": "queue 1 #13 (convnets)",
    "wide_resnet50_2": "queue 1 #13 (convnets)",
    "xcit_small_12": "queue 1 #15 (models/xcit.py)",
    "xcit_medium_24": "queue 1 #15 (models/xcit.py)",
}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    arch: str  # vit_tiny | vit_small | vit_base | vit_test | swin_t
    patch_size: int = 16  # ViT only: Swin-T's patch is 4, as in the JAX package
    img_size: int = 224
    drop_path_rate: float = 0.0  # student only
    compute_dtype: torch.dtype = torch.bfloat16
    gelu_approx: bool = True

    def __post_init__(self):
        if not (self.is_vit or self.arch == "swin_t"):
            item = _NOT_PORTED.get(self.arch, "the encoder queue")
            raise NotImplementedError(
                f"encoder {self.arch!r} is not ported to PyTorch yet (ROADMAP.md {item})"
            )

    @property
    def is_vit(self) -> bool:
        return self.arch in vt.VIT_FACTORIES

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
            compute_dtype=self.compute_dtype,
            gelu_approx=self.gelu_approx,
        )

    def swin_config(self) -> sw.SwinConfig:
        return sw.swin_t(
            compute_dtype=self.compute_dtype,
            drop_path_rate=self.drop_path_rate,
            gelu_approx=self.gelu_approx,
        )

    @property
    def embed_dim(self) -> int:
        return self.vit_config().embed_dim if self.is_vit else self.swin_config().out_dim

    def build(self, gen: Optional[torch.Generator] = None) -> Encoder:
        """A freshly initialized encoder (parameters on the CPU)."""
        if self.is_vit:
            return vt.VisionTransformer(self.vit_config(), gen)
        return sw.SwinTransformer(self.swin_config(), gen)

    def apply(
        self, model: Encoder, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, embed_dim) f32 embeddings."""
        if self.is_vit:
            return vt.vit_forward(model, x, generator, not train)
        return sw.swin_forward(model, x, generator, not train)

    def apply_packed(
        self, model: vt.VisionTransformer, xa: torch.Tensor, xb: torch.Tensor,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two crop batches in one packed forward: exactly ``apply(xa)`` and
        ``apply(xb)`` with half the attention launches."""
        return vt.vit_forward_packed(model, xa, xb, generator, not train)
