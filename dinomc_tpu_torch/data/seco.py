"""SeCo-style pretraining datasets: host readers of raw RGB images.

The port's copy of the part of ``dinomc_tpu/data/seco.py`` that
``cli/train_dino.py`` reads (parity targets in the reference's
``data_process/dino_dataset.py``):

  * ``MCBase`` (``:32-66``): each subdirectory of the root is one location,
    and ONE random image per location is chosen at construction;
  * ``FlatImageFolder``: every image under a directory tree;
  * ``read_image``: float32 [0, 1] RGB, through the native C++ decoder with
    a fused resize when it is available, else PIL.

Only raw batches are made here; every random augmentation runs on the
device (``ops/augment.py``). The multispectral band readers and
``MCTemporal`` are not ported yet (ROADMAP.md queue 1 #10).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from dinomc_tpu_torch.data import native_loader

_IMG_EXTS = (".tif", ".tiff", ".png", ".jpg", ".jpeg")


def read_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """Read one RGB image -> float32 [0, 1] (H, W, 3), resized (bicubic) to
    (size, size) when ``size`` is given."""
    p = str(path)
    img = None
    if size is not None and native_loader.available():
        img = native_loader.decode(p, size, size)
    if img is None:
        from PIL import Image

        img = np.asarray(Image.open(p).convert("RGB"))
    if size is not None and img.shape[:2] != (size, size):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))
    return img.astype(np.float32) / 255.0


class MCBase:
    """One-random-image-per-location dataset (``MCBase``,
    ``dino_dataset.py:32-66``)."""

    def __init__(self, root: str, image_size: int = 256, seed: int = 0):
        self.root = root
        self.image_size = image_size
        rng = np.random.RandomState(seed)
        self.samples: List[str] = []
        for loc in sorted(Path(root).iterdir()):
            if not loc.is_dir():
                continue
            files = sorted(str(f) for f in loc.iterdir() if f.suffix.lower() in _IMG_EXTS)
            if files:
                # one random timestamp per location, fixed at construction
                self.samples.append(files[rng.randint(len(files))])

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> np.ndarray:
        return read_image(self.samples[i], size=self.image_size)


class FlatImageFolder:
    """All images under a directory tree (non-SeCo corpora, e.g. patched
    aerial tiles used as a pretraining pool)."""

    def __init__(self, root: str, image_size: int = 256):
        self.image_size = image_size
        self.samples = sorted(str(p) for p in Path(root).rglob("*") if p.suffix.lower() in _IMG_EXTS)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> np.ndarray:
        return read_image(self.samples[i], size=self.image_size)
