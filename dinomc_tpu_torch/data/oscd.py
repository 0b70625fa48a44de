"""OSCD (Onera Satellite Change Detection) tiles.

Counterpart of ``dinomc_tpu/data/oscd.py``. The reference imports
``data_process.oscd_datamodule``, which is missing from it; the JAX package
reconstructs SeCo's ``ChangeDetectionDataModule`` from the call sites
(``main_oscd.py:107-185``): city directories with two Sentinel-2
acquisitions (``imgs_1`` / ``imgs_2`` RGB composites, or pre-rendered
``t1.png`` / ``t2.png``) and a binary change mask (``cm``), cut into
non-overlapping 96 px tiles for training and evaluation. Host-side numpy,
decoded by the port's ``data/seco.read_image``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from dinomc_tpu_torch.data.patching import custom_grid_coords
from dinomc_tpu_torch.data.seco import read_image

# The official OSCD train / test city split (14 / 10), the protocol behind
# the reference's README OSCD tables; SeCo's ChangeDetectionDataModule
# hard-codes it.
TRAIN_CITIES = [
    "abudhabi", "aguasclaras", "beihai", "beirut", "bercy", "bordeaux",
    "cupertino", "hongkong", "mumbai", "nantes", "paris", "pisa",
    "rennes", "saclay_e",
]
TEST_CITIES = [
    "brasilia", "chongqing", "dubai", "lasvegas", "milano", "montpellier",
    "norcia", "rio", "saclay_w", "valencia",
]


class OSCDTiles:
    """Tiled OSCD samples: (img1, img2, change mask) triplets of ``tile`` px.

    Expects ``root/<city>/{imgs_1,imgs_2,cm}`` with matching file stems, or
    ``root/<city>/{t1.png,t2.png,cm.png}``.
    """

    def __init__(self, root: str, tile: int = 96, cities: Optional[List[str]] = None):
        self.tile = tile
        self.samples: List[Tuple[str, str, str, Tuple[int, int, int, int]]] = []
        for city in sorted(Path(root).iterdir()):
            if not city.is_dir():
                continue
            if cities is not None and city.name not in cities:
                continue
            t1, t2, cm = self._find_triplet(city)
            if t1 is None:
                continue
            h, w = read_image(t1).shape[:2]
            rows, cols = max(h // tile, 1), max(w // tile, 1)
            for coords in custom_grid_coords(rows * tile, cols * tile, rows, cols):
                self.samples.append((t1, t2, cm, coords))
        self._cache: dict = {}

    @staticmethod
    def _find_triplet(city: Path):
        def first_img(d: Path):
            if not d.exists():
                return None
            files = sorted(str(f) for f in d.iterdir()
                           if f.suffix.lower() in (".png", ".jpg", ".tif", ".tiff"))
            return files[0] if files else None

        def single(name: str):
            return str(city / name) if (city / name).exists() else None

        t1 = first_img(city / "imgs_1") or single("t1.png")
        t2 = first_img(city / "imgs_2") or single("t2.png")
        cm = first_img(city / "cm") or single("cm.png")
        if t1 and t2 and cm:
            return t1, t2, cm
        return None, None, None

    def _load(self, path: str) -> np.ndarray:
        if path not in self._cache:
            self._cache[path] = read_image(path)
        return self._cache[path]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        t1, t2, cm, (y0, y1, x0, x1) = self.samples[i]
        img1 = self._load(t1)[y0:y1, x0:x1]
        img2 = self._load(t2)[y0:y1, x0:x1]
        mask = self._load(cm)[y0:y1, x0:x1]
        # change masks are {0, 1} (white = change); collapse the RGB
        return img1, img2, (mask.mean(-1) > 0.5).astype(np.float32)


def collate_pairs(items):
    """A list of triplets -> stacked (x1, x2, mask) arrays."""
    x1 = np.stack([it[0] for it in items])
    x2 = np.stack([it[1] for it in items])
    m = np.stack([it[2] for it in items])
    return x1, x2, m
