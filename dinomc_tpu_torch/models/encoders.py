"""Encoder registry, ViT branch.

Counterpart of ``dinomc_tpu/models/encoders.py``: one interface the DINO
trainer calls without knowing the architecture. Only the ViTs are ported;
every other architecture raises ``NotImplementedError`` naming its
ROADMAP.md item. BatchNorm state does not exist for a ViT, so ``apply``
returns the embeddings alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dinomc_tpu_torch.models import vit as vt

_NOT_PORTED = {
    "resnet50": "queue 1 #13 (convnets)",
    "wide_resnet50_2": "queue 1 #13 (convnets)",
    "swin_t": "queue 1 #14 (models/swin.py) and TPU kernels #4",
    "xcit_small_12": "queue 1 #15 (models/xcit.py)",
    "xcit_medium_24": "queue 1 #15 (models/xcit.py)",
}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    arch: str  # vit_tiny | vit_small | vit_base | vit_test
    patch_size: int = 16
    img_size: int = 224
    drop_path_rate: float = 0.0  # student only
    compute_dtype: torch.dtype = torch.bfloat16
    gelu_approx: bool = True

    def __post_init__(self):
        if not self.is_vit:
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

    @property
    def embed_dim(self) -> int:
        return self.vit_config().embed_dim

    def build(self, gen: Optional[torch.Generator] = None) -> vt.VisionTransformer:
        """A freshly initialized encoder (parameters on the CPU)."""
        return vt.VisionTransformer(self.vit_config(), gen)

    def apply(
        self, model: vt.VisionTransformer, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, embed_dim) f32 embeddings."""
        return vt.vit_forward(model, x, generator, not train)

    def apply_packed(
        self, model: vt.VisionTransformer, xa: torch.Tensor, xb: torch.Tensor,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two crop batches in one packed forward: exactly ``apply(xa)`` and
        ``apply(xb)`` with half the attention launches."""
        return vt.vit_forward_packed(model, xa, xb, generator, not train)
