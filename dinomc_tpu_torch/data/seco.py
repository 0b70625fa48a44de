"""SeCo-style pretraining datasets: host readers of raw RGB and multispectral
images.

The port's copy of ``dinomc_tpu/data/seco.py`` (parity targets in the
reference's ``data_process/dino_dataset.py``):

  * ``MCBase`` (``:32-66``): each subdirectory of the root is one location,
    and ONE random image per location is chosen at construction;
  * ``MCTemporal`` (``:89-128``): per item, 3 random timestamps t0, t1, t2
    of the location, returned as ``[t0, t1, t2, t0]`` for the
    temporal-positive augmentation (``ops/augment.multicrop_augment_tp``),
    re-drawn each epoch by ``set_epoch``;
  * ``FlatImageFolder``: every image under a directory tree;
  * ``read_image``: float32 [0, 1] RGB, through the native C++ decoder with
    a fused resize when it is available, else PIL; with ``bands``, the
    multispectral Sentinel-2 read (``read_bands``: per-band quantile
    normalization to uint8 with the B2/B3/B4 quantiles below; rasterio when
    installed, else the native TIFF band reader, else PIL).

Only raw batches are made here; every random augmentation runs on the
device (``ops/augment.py``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from dinomc_tpu_torch.data import native_loader

RGB_BANDS = ["B4", "B3", "B2"]
# Sentinel-2 per-band (1%, 99%) quantiles (dino_dataset.py:19-24)
QUANTILES = {"B2": (3.0, 88.0), "B3": (2.0, 103.0), "B4": (0.0, 129.0)}

_IMG_EXTS = (".tif", ".tiff", ".png", ".jpg", ".jpeg")


def _normalize_band(band: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Quantile-normalize a raw band to uint8 (``dino_dataset.py:26-30``)."""
    band = (band - lo) / max(hi - lo, 1e-12) * 255.0
    return np.clip(band, 0, 255).astype(np.uint8)


def _read_raw_band(path: str, band: int = 1) -> np.ndarray:
    """One band of a TIFF as raw float32 DN values (H, W): rasterio when
    installed, else the native libtiff reader (``native_loader.read_band``),
    else PIL. Raises on total failure."""
    try:
        import rasterio  # optional

        with rasterio.open(path) as src:
            return src.read(band).astype(np.float32)
    except ImportError:
        pass
    out = native_loader.read_band(path, band)
    if out is not None:
        return out
    from PIL import Image

    arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        arr = arr[:, :, band - 1]
    return arr.astype(np.float32)


def read_bands(path: str, bands: Sequence[str]) -> np.ndarray:
    """Multispectral read -> (H, W, len(bands)) uint8 by per-band quantile
    normalization (reference ``read_image``/``normalize``,
    ``dino_dataset.py:69-87``). ``path`` is one multi-band file (bands
    indexed by their position in ``bands``) or a directory holding one
    ``{B}.tif`` per band (SeCo's layout)."""
    chans = []
    for i, b in enumerate(bands):
        if os.path.isdir(path):
            raw = _read_raw_band(os.path.join(path, f"{b}.tif"), 1)
        else:
            raw = _read_raw_band(path, i + 1)
        lo, hi = QUANTILES.get(b, (float(raw.min()), float(raw.max())))
        chans.append(_normalize_band(raw, lo, hi))
    return np.stack(chans, axis=-1)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bicubic PIL resize of a uint8 (H, W, C) image to (size, size), one
    channel at a time when C is not 3."""
    from PIL import Image

    if img.shape[-1] == 3:
        return np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))
    return np.stack([np.asarray(Image.fromarray(img[:, :, c]).resize((size, size), Image.BICUBIC))
                     for c in range(img.shape[-1])], axis=-1)


def read_image(
    path: str, bands: Optional[Sequence[str]] = None, size: Optional[int] = None,
) -> np.ndarray:
    """Read one image -> float32 [0, 1] (H, W, len(bands) or 3), resized
    (bicubic) to (size, size) when ``size`` is given. ``bands=None`` reads
    plain RGB; a band list reads through ``read_bands``."""
    p = str(path)
    if bands is not None:
        img = read_bands(p, bands)
    else:
        img = None
        if size is not None and native_loader.available():
            img = native_loader.decode(p, size, size)
        if img is None:
            from PIL import Image

            img = np.asarray(Image.open(p).convert("RGB"))
    if size is not None and img.shape[:2] != (size, size):
        img = _resize(img, size)
    return img.astype(np.float32) / 255.0


def _locations(root: str, bands: Optional[Sequence[str]]) -> List[List[str]]:
    """The sorted image files of each location directory under ``root``
    (with ``bands``, per-timestamp directories count too); locations with
    none are left out."""
    out = []
    for loc in sorted(Path(root).iterdir()):
        if not loc.is_dir():
            continue
        files = sorted(str(f) for f in loc.iterdir()
                       if f.suffix.lower() in _IMG_EXTS or (bands is not None and f.is_dir()))
        if files:
            out.append(files)
    return out


class MCBase:
    """One-random-image-per-location dataset (``MCBase``,
    ``dino_dataset.py:32-66``)."""

    def __init__(self, root: str, image_size: int = 256, seed: int = 0,
                 bands: Optional[Sequence[str]] = None):
        self.root = root
        self.image_size = image_size
        self.bands = bands
        rng = np.random.RandomState(seed)
        # one random timestamp per location, fixed at construction
        self.samples: List[str] = [files[rng.randint(len(files))]
                                   for files in _locations(root, bands)]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> np.ndarray:
        return read_image(self.samples[i], bands=self.bands, size=self.image_size)


class MCTemporal:
    """Temporal-positives dataset (``MCTemporal``, ``dino_dataset.py:89-128``):
    each item is (4, H, W, 3) = [t0, t1, t2, t0], the three timestamps
    drawn with replacement from the location's, by a generator that
    ``set_epoch`` reseeds with the epoch."""

    def __init__(self, root: str, image_size: int = 256, seed: int = 0,
                 bands: Optional[Sequence[str]] = None):
        self.image_size = image_size
        self.bands = bands
        self.locations: List[List[str]] = _locations(root, bands)
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.locations)

    def set_epoch(self, epoch: int) -> None:
        self._rng = np.random.RandomState(epoch)

    def __getitem__(self, i: int) -> np.ndarray:
        files = self.locations[i]
        picks = self._rng.randint(len(files), size=3)
        t0, t1, t2 = (read_image(files[j], bands=self.bands, size=self.image_size)
                      for j in picks)
        return np.stack([t0, t1, t2, t0], axis=0)


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
