"""Downstream segmentation datasets: UAVid, UDD6, Potsdam, LoveDA.

Counterpart of ``dinomc_tpu/data/seg_datasets.py`` (reference
``data_process/{uavid,udd6,potsdam,loveda}_dataset.py``). The dataset facts
(classes, palettes, normalization, augmentation policy) are copied from it,
since that module imports jax. The host side lists, decodes (PIL) and
resizes; flips, the affine OneOf, ColorJitter and normalize run batched on
the device. Draws are apart from compute: ``draw_seg_augment`` makes a
batch's draws, ``augment_batch`` applies them.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from dinomc_tpu_torch.ops import augment as aug
from dinomc_tpu_torch.ops import spatial


@dataclasses.dataclass(frozen=True)
class SegDatasetSpec:
    name: str
    classes: Tuple[str, ...]
    palette: Tuple[Tuple[int, int, int], ...]
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    img_suffix: str = ".png"
    mask_suffix: str = ".png"
    mask_is_rgb: bool = True  # palette-coded masks need rgb->class
    affine: Optional[spatial.AffineConfig] = spatial.UAVID_AFFINE
    hflip_p: float = 0.5
    vflip_p: float = 0.2
    jitter: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.05)
    ignore_index: Optional[int] = None

    @property
    def num_classes(self) -> int:
        return len(self.classes)


_MMSEG_MEAN = (123.675 / 255.0, 116.28 / 255.0, 103.53 / 255.0)
_MMSEG_STD = (58.395 / 255.0, 57.12 / 255.0, 57.375 / 255.0)

UAVID = SegDatasetSpec(
    name="uavid",
    # uavid_dataset.py:18-39
    classes=("Clutter", "Building", "Road", "Tree", "LowVeg", "Moving_Car",
             "Static_Car", "Human"),
    palette=((0, 0, 0), (128, 0, 0), (128, 64, 128), (0, 128, 0),
             (128, 128, 0), (64, 0, 128), (192, 0, 192), (64, 64, 0)),
    mean=_MMSEG_MEAN,
    std=_MMSEG_STD,
    affine=spatial.UAVID_AFFINE,
)

UDD6 = SegDatasetSpec(
    name="udd6",
    # udd6_dataset.py:21-37
    classes=("Other", "Facade", "Road", "Vegetation", "Vehicle", "Roof"),
    palette=((0, 0, 0), (102, 102, 156), (128, 64, 128), (107, 142, 35),
             (0, 0, 142), (70, 70, 70)),
    mean=(0.3918, 0.4114, 0.3726),
    std=(0.1553, 0.1528, 0.1456),
    img_suffix=".JPG",
    mask_suffix=".png",
    affine=spatial.UDD6_AFFINE,
    vflip_p=0.5,  # udd6_dataset.py:157
)

POTSDAM = SegDatasetSpec(
    name="potsdam",
    # potsdam_dataset.py:16-41
    classes=("ImSurf", "Building", "LowVeg", "Tree", "Car", "Clutter"),
    palette=((255, 255, 255), (0, 0, 255), (0, 255, 255), (0, 255, 0),
             (255, 255, 0), (255, 0, 0)),
    mean=_MMSEG_MEAN,
    std=_MMSEG_STD,
    img_suffix=".tif",
    mask_suffix=".tif",
    affine=None,  # reference Potsdam pipeline has no affine aug
)

LOVEDA = SegDatasetSpec(
    name="loveda",
    # loveda_dataset.py: class 0 = NoData; masks already class-indexed
    classes=("NoData", "Background", "Building", "Road", "Water", "Barren",
             "Forest", "Agricultural"),
    palette=((0, 0, 0), (255, 255, 255), (255, 0, 0), (255, 255, 0),
             (0, 0, 255), (159, 129, 183), (0, 255, 0), (255, 195, 128)),
    mean=_MMSEG_MEAN,
    std=_MMSEG_STD,
    mask_is_rgb=False,  # loveda_dataset.py:160-162
    affine=None,
    ignore_index=0,
)

SPECS = {s.name: s for s in (UAVID, UDD6, POTSDAM, LOVEDA)}


def rgb_to_class(mask_rgb: np.ndarray, spec: SegDatasetSpec) -> np.ndarray:
    """(H, W, 3) uint8 palette mask -> (H, W) class indices; unknown colors
    map to 0 (reference ``rgb_to_class``, ``uavid_dataset.py:103-110``)."""
    palette = np.asarray(spec.palette, np.int32)
    flat = mask_rgb.reshape(-1, 3).astype(np.int32)
    code = flat[:, 0] * 65536 + flat[:, 1] * 256 + flat[:, 2]
    pcode = palette[:, 0] * 65536 + palette[:, 1] * 256 + palette[:, 2]
    eq = code[:, None] == pcode[None, :]
    cls = np.where(eq.any(1), eq.argmax(1), 0).astype(np.uint8)
    return cls.reshape(mask_rgb.shape[:2])


def class_to_rgb(mask: np.ndarray, spec: SegDatasetSpec) -> np.ndarray:
    """(H, W) class indices -> (H, W, 3) uint8 palette colours (reference
    ``class_to_rgb``)."""
    palette = np.asarray(spec.palette, np.uint8)
    return palette[np.clip(mask, 0, spec.num_classes - 1)]


class SegSampleIndex:
    """(image, mask) pairs listed by shared stem from two directories: the
    original and 'patched' layouts of all four datasets. ``image_size=None``
    loads every sample at its native resolution (the stitched evaluation's
    full-resolution frames)."""

    def __init__(self, img_dir: str, mask_dir: str, spec: SegDatasetSpec,
                 image_size: Optional[int] = 224):
        self.spec = spec
        self.image_size = image_size
        self.img_dir, self.mask_dir = img_dir, mask_dir
        stems = sorted(
            p.stem for p in Path(img_dir).iterdir()
            if p.suffix.lower() in (spec.img_suffix.lower(), ".png", ".jpg", ".jpeg", ".tif")
        )
        self.stems = [s for s in stems if self._find_mask(s) is not None]

    def _mask_stem(self, stem: str) -> str:
        return "Label_" + stem[len("Image_"):] if stem.startswith("Image_") else stem

    def _find_mask(self, stem: str) -> Optional[str]:
        stem = self._mask_stem(stem)
        for suf in (self.spec.mask_suffix, ".png", ".tif"):
            p = os.path.join(self.mask_dir, stem + suf)
            if os.path.exists(p):
                return p
        return None

    def _find_img(self, stem: str) -> str:
        for suf in (self.spec.img_suffix, ".png", ".jpg", ".JPG", ".tif"):
            p = os.path.join(self.img_dir, stem + suf)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(stem)

    @classmethod
    def potsdam_pairs(cls, root: str, spec: SegDatasetSpec, split: str = "train",
                      val_frac: float = 0.1, seed: int = 42,
                      image_size: Optional[int] = 224) -> "SegSampleIndex":
        """Potsdam layout: one directory of ``Image_*.tif`` / ``Label_*.tif``
        pairs with a seeded 90/10 train/val split in memory (reference
        ``potsdam_dataset.py:185-189``)."""
        self = cls.__new__(cls)
        self.spec = spec
        self.image_size = image_size
        self.img_dir = self.mask_dir = root
        stems = sorted(p.stem for p in Path(root).iterdir() if p.stem.startswith("Image_"))
        order = np.random.RandomState(seed).permutation(len(stems))
        n_val = max(int(round(len(stems) * val_frac)), 1) if stems else 0
        pick = order[n_val:] if split == "train" else order[:n_val]
        self.stems = [stems[i] for i in sorted(pick)]
        return self

    def __len__(self) -> int:
        return len(self.stems)

    def load(self, i: int, size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(image f32 [0, 1] (S, S, 3), mask int32 (S, S)) at ``size``, else
        at ``image_size``, else native; image bicubic, mask nearest
        (``uavid_dataset.py:237-238``)."""
        from PIL import Image

        stem, size = self.stems[i], size or self.image_size
        img = Image.open(self._find_img(stem)).convert("RGB")
        mask_img = Image.open(self._find_mask(stem))
        if size is not None:
            img = img.resize((size, size), Image.BICUBIC)
            mask_img = mask_img.resize((size, size), Image.NEAREST)
        img_np = np.asarray(img, np.float32) / 255.0
        if self.spec.mask_is_rgb:
            mask_np = rgb_to_class(np.asarray(mask_img.convert("RGB")), self.spec)
        else:
            mask_np = np.asarray(mask_img.convert("L"))
        return img_np, mask_np.astype(np.int32)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True):
        """Yield (images (B, S, S, 3) f32 in [0, 1], masks (B, S, S) int32)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        end = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, end, batch_size):
            pairs = [self.load(int(i)) for i in order[s:s + batch_size]]
            yield np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@dataclasses.dataclass
class SegAugDraw:
    """One batch's train-transform draws: flips (B,) bool, the affine
    OneOf (None when the dataset has none) and the ColorJitter."""

    flip_h: torch.Tensor
    flip_v: torch.Tensor
    affine: Optional[spatial.AffineDraw]
    jitter: aug.JitterDraw


def draw_seg_augment(gen: torch.Generator, B: int, spec: SegDatasetSpec, device=None) -> SegAugDraw:
    fh, fv = spatial.draw_flips(gen, B, spec.hflip_p, spec.vflip_p, device)
    affine = None if spec.affine is None else spatial.draw_affine(gen, B, spec.affine, device)
    jitter = aug.draw_color_jitter(gen, B, *spec.jitter, device=device)
    return SegAugDraw(fh, fv, affine, jitter)


def augment_batch(
    images: torch.Tensor,
    masks: torch.Tensor,
    spec: SegDatasetSpec,
    draws: Optional[SegAugDraw] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference seg datasets' transform on (B, S, S, 3) images in
    [0, 1] and (B, S, S) masks. With ``draws`` (training): joint flips, the
    affine OneOf, image-only ColorJitter, normalize. Without (evaluation):
    normalize only."""
    if draws is not None:
        images, masks = spatial.joint_flip(images, masks, draws.flip_h, draws.flip_v)
        if draws.affine is not None:
            mats = spatial.affine_matrices(draws.affine)
            images, masks = spatial.random_affine_pair(images, masks, mats)
        images = aug.color_jitter(images, draws.jitter)
    return aug.normalize(images, spec.mean, spec.std), masks
