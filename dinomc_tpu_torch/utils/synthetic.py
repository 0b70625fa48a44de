"""Synthetic texture worlds for dataset-free learning checks.

Counterpart of ``dinomc_tpu/utils/synthetic.py`` (the texture families,
``make_texture_dataset``, and the Voronoi scenes ``make_change_pair`` and
``make_seg_scene``), copied so that the port imports nothing of the
JAX package; ``tests/test_torch_copies.py`` holds it to the original, array
for array. Eight texture families (stripes / checker / dots / rings /
starburst / blobs / speckle / crosshatch) whose identity survives the DINO
augmentations while orientation, scale, phase, colour, brightness and noise
vary per sample. Everything is numpy, drawn from ``np.random.RandomState``.
Used by ``scripts/validate_learning_torch.py``, the OSCD and tiled-inference
tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NUM_CLASSES = 8


def texture(c: int, size: int, rng: np.random.RandomState) -> np.ndarray:
    """One (size, size) float grayscale texture of family ``c`` with random
    nuisance parameters (orientation/scale/phase/center)."""
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    f = 4 + 6 * rng.rand()
    a = rng.rand() * np.pi
    p = rng.rand() * 2 * np.pi
    rloc = 0.3 * (rng.rand(2) - 0.5)

    def stripes(f_, a_, p_):
        return 0.5 + 0.5 * np.sin(
            2 * np.pi * f_ * (np.cos(a_) * xx + np.sin(a_) * yy) + p_
        )

    u = np.cos(a) * xx + np.sin(a) * yy
    v = -np.sin(a) * xx + np.cos(a) * yy
    r = np.sqrt((xx - rloc[0]) ** 2 + (yy - rloc[1]) ** 2)
    if c == 0:  # stripes
        return stripes(f, a, p)
    if c == 1:  # checkerboard
        return (np.floor(u * f) + np.floor(v * f)) % 2
    if c == 2:  # dot grid
        return (np.sin(2 * np.pi * f * u + p) * np.sin(2 * np.pi * f * v + p) > 0.3) * 1.0
    if c == 3:  # concentric rings
        return 0.5 + 0.5 * np.sin(2 * np.pi * f * r + p)
    if c == 4:  # radial starburst
        theta = np.arctan2(yy - rloc[1], xx - rloc[0])
        return 0.5 + 0.5 * np.sin(int(f) * 2 * theta + p)
    if c == 5:  # smooth blobs (low-frequency noise)
        big = np.zeros((size, size))
        big[:8, :8] = rng.randn(8, 8)
        out = np.real(np.fft.ifft2(np.fft.fft2(big)))
        return (out - out.min()) / max(np.ptp(out), 1e-9)
    if c == 6:  # fine speckle
        return (rng.rand(size, size) > 0.5) * 1.0
    # crosshatch: two orthogonal stripe fields
    return np.maximum(stripes(f, a, p), stripes(f, a + np.pi / 2, p))


def colorize(tex: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Grayscale texture -> (H, W, 3) float32 [0,1] with random tint,
    brightness and additive noise."""
    color = 0.3 + 0.7 * rng.rand(3)
    img = tex[..., None] * color[None, None]
    img = img * (0.6 + 0.4 * rng.rand()) + 0.08 * rng.randn(*tex.shape, 3)
    return np.clip(img, 0, 1).astype(np.float32)


def make_texture_dataset(
    n_per_class: int = 64,
    size: int = 128,
    num_classes: int = NUM_CLASSES,
    seed: int = 0,
    family: str = "v1",
) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled texture images, shuffled: (N, size, size, 3) f32 + (N,) int."""
    gen = TEXTURES[family]
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for c in range(num_classes):
        for _ in range(n_per_class):
            xs.append(colorize(gen(c, size, rng), rng))
            ys.append(c)
    order = rng.permutation(len(xs))
    return np.stack(xs)[order], np.asarray(ys)[order]


def texture_v2(c: int, size: int, rng: np.random.RandomState) -> np.ndarray:
    """Family ``c`` mixed with a random other family at a subordinate
    amplitude a ~ U[0.35, 0.48]: the class is the dominant component, so
    a readout over random features must learn to weight it."""
    return _texture_mix(c, size, rng, 0.35, 0.48)


def texture_v2m(c: int, size: int, rng: np.random.RandomState) -> np.ndarray:
    """The milder mix, a ~ U[0.20, 0.35]."""
    return _texture_mix(c, size, rng, 0.20, 0.35)


def _texture_mix(c, size, rng, lo, hi):
    a = lo + (hi - lo) * rng.rand()
    d = (c + 1 + rng.randint(NUM_CLASSES - 1)) % NUM_CLASSES
    t = (1 - a) * texture(c, size, rng) + a * texture(d, size, rng)
    return np.clip(t, 0.0, 1.0)


TEXTURES = {"v1": texture, "v2": texture_v2, "v2m": texture_v2m}


def make_change_pair(
    size: int,
    rng: np.random.RandomState,
    num_classes: int = NUM_CLASSES,
    n_seeds: int = 6,
    n_change: int = 2,
    family: str = "v1",
    drift: str = "color",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A before / after scene pair with a known change mask (the OSCD
    learning world). Both images share one Voronoi layout; ``n_change``
    random cells take another texture class in the second, and every cell
    drifts between the two acquisitions: with ``drift='color'`` an unchanged
    cell keeps its texture's structure under a fresh colour, brightness and
    noise; with ``drift='full'`` it is drawn anew (the class alone is the
    change). Returns (img1, img2, change_mask): two (size, size, 3) f32
    images and a (size, size) f32 mask in {0, 1}."""
    gen = TEXTURES[family]
    pts = rng.rand(n_seeds, 2) * size
    cls1 = rng.randint(0, num_classes, n_seeds)
    cls2 = cls1.copy()
    changed = rng.choice(n_seeds, size=min(n_change, n_seeds), replace=False)
    for s in changed:
        cls2[s] = (cls1[s] + 1 + rng.randint(num_classes - 1)) % num_classes
    yy, xx = np.mgrid[0:size, 0:size]
    d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    cell = np.argmin(d2, axis=-1)
    mask = np.isin(cell, changed).astype(np.float32)
    img1 = np.zeros((size, size, 3), np.float32)
    img2 = np.zeros((size, size, 3), np.float32)
    for s in range(n_seeds):
        sel = cell == s
        if not sel.any():
            continue
        t1 = gen(int(cls1[s]), size, rng)
        img1[sel] = colorize(t1, rng)[sel]
        if s in changed or drift == "full":
            t2 = gen(int(cls2[s]), size, rng)
        else:
            t2 = t1  # same structure, fresh colorize below
        img2[sel] = colorize(t2, rng)[sel]
    return img1, img2, mask


def make_seg_scene(
    size: int,
    rng: np.random.RandomState,
    num_classes: int = NUM_CLASSES,
    n_seeds: int = 6,
    family: str = "v1",
) -> Tuple[np.ndarray, np.ndarray]:
    """One Voronoi segmentation scene: a (size, size, 3) f32 image and a
    (size, size) int32 mask. Each cell is cut from a full-size texture of a
    random class, so the class is carried by texture, not by colour or
    position."""
    gen = TEXTURES[family]
    pts = rng.rand(n_seeds, 2) * size
    cls = rng.randint(0, num_classes, n_seeds)
    yy, xx = np.mgrid[0:size, 0:size]
    d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    cell = np.argmin(d2, axis=-1)  # (H, W) -> seed index
    mask = cls[cell].astype(np.int32)
    img = np.zeros((size, size, 3), np.float32)
    for s in range(n_seeds):
        sel = cell == s
        if sel.any():
            img[sel] = colorize(gen(int(cls[s]), size, rng), rng)[sel]
    return img, mask
