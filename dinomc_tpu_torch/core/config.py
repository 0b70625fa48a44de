"""Workspace configuration: dataset roots, checkpoint paths, model presets.

The port's copy of ``dinomc_tpu/core/config.py`` (jax-free there too; nothing
in either package imports it), held to the original by
``tests/test_torch_copies.py``.

Parity target: the reference ``CONFIG`` god-object (``config.py:27-346``) —
a path registry for UAVid/UDD6/Potsdam/LoveDA (original + patched
variants), checkpoint locations, ViT arch presets (embed_dim,
out_indices), and the segmentation training hyperparameters
(``train_configs``, ``config.py:317-329``). Re-designed as typed
dataclasses with environment-variable overrides instead of hard-coded
user paths; per-trainer hyperparameters live with their trainers — this
module only centralizes what is genuinely global.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchPreset:
    embed_dim: int
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)
    depth: int = 12


# reference ``vit_configs`` (config.py:182-201)
VIT_PRESETS: Dict[str, ArchPreset] = {
    "vit_tiny": ArchPreset(192),
    "vit_small": ArchPreset(384),
    "vit_base": ArchPreset(768),
}


@dataclasses.dataclass(frozen=True)
class SegTrainPreset:
    """Reference ``train_configs`` (config.py:317-329)."""

    lr: float = 3e-4
    weight_decay: float = 1e-4
    epochs: int = 100
    batch_size: int = 4
    image_size: int = 224
    big_image_size: int = 512
    patch_count: int = 4
    patch_size: int = 8


SEG_TRAIN_PRESET = SegTrainPreset()


@dataclasses.dataclass
class Workspace:
    """Filesystem layout. Every path can be overridden by env var
    ``DINOMC_<FIELD>`` (uppercased)."""

    data_root: str = "data"
    output_root: str = "outputs"
    weights_root: str = "model_weights"

    def __post_init__(self):
        for f in dataclasses.fields(self):
            env = os.environ.get(f"DINOMC_{f.name.upper()}")
            if env:
                setattr(self, f.name, env)

    # -- dataset roots (original + patched variants, config.py path registry)
    def dataset_dir(self, name: str, patched: Optional[int] = None) -> str:
        sub = name if patched is None else f"{name}_patched_{patched}"
        return os.path.join(self.data_root, sub)

    def split_dir(self, name: str, split: str, patched: Optional[int] = None) -> str:
        return os.path.join(self.dataset_dir(name, patched), split)

    # -- checkpoints
    def pretrain_dir(self, run: str) -> str:
        return os.path.join(self.output_root, "pretrain", run)

    def seg_dir(self, run: str) -> str:
        return os.path.join(self.output_root, "seg", run)

    def reference_weights(self, rel: str) -> str:
        """e.g. reference_weights('dino_mc/vit_mc_checkpoint300.pth')."""
        return os.path.join(self.weights_root, rel)


DEFAULT_WORKSPACE = Workspace()
