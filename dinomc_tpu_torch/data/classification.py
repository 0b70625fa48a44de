"""Classification datasets: EuroSAT (ImageFolder).

Counterpart of the EuroSAT half of ``dinomc_tpu/data/classification.py``:
the torchvision ``ImageFolder`` layout (a subdirectory per class), decoded
on the host with PIL and resized bicubic to ``image_size``, and the val
transform's centre crop (``main_eurosat.py:57-98``). Crops, flips and the
normalization of the train transform run on the device
(``ops/augment``). The BigEarthNet-19 and LMDB half is not ported yet
(ROADMAP.md queue 1 #16).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np


class ImageFolderDataset:
    """Class-per-subdir image dataset (torchvision ImageFolder layout)."""

    def __init__(self, root: str, image_size: int = 256):
        self.image_size = image_size
        self.classes = sorted(
            d.name for d in Path(root).iterdir() if d.is_dir()
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            for f in sorted((Path(root) / c).iterdir()):
                if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
                    self.samples.append((str(f), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        if self.image_size:
            img = img.resize((self.image_size, self.image_size), Image.BICUBIC)
        return np.asarray(img, np.float32) / 255.0, label


def center_crop(images: np.ndarray, size: int) -> np.ndarray:
    """(B, H, W, C) -> centered (B, size, size, C) (val transform)."""
    H, W = images.shape[1:3]
    y0 = (H - size) // 2
    x0 = (W - size) // 2
    return images[:, y0 : y0 + size, x0 : x0 + size]
