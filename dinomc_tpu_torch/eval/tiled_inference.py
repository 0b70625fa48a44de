"""Tiled full-resolution segmentation inference and stitched evaluation.

Counterpart of ``dinomc_tpu/eval/tiled_inference.py``: one on-device path in
place of the reference's three scripts (patch export -> ``.npy`` logits ->
stitch + evaluate): cut a static grid of patches out of a 4K frame, run the
model on the whole batch of patches at the model resolution, resize the
logits back to the patch size, paste them into the full-resolution canvas,
and stream per-class IoU statistics (reference
``inference_dino_mc_patched_dataset.py:52-63``, ``UAVIDPatchStitch``
``uavid_dataset.py:279-397``, ``evaluate.py:30-54``).

Every resize is ``ops/augment.resize``, which reproduces ``jax.image.resize``:
Keys bicubic (a = -0.5), antialiased when shrinking. ``F.interpolate``'s
bicubic (a = -0.75, no antialias) would give another canvas.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from dinomc_tpu_torch.data import patching
from dinomc_tpu_torch.eval import metrics
from dinomc_tpu_torch.ops.augment import resize


def tiled_predict(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,  # (H, W, 3) normalized full-resolution image
    grid: Tuple[int, int] = (2, 2),
    model_size: Optional[int] = 224,
    overlap_ratio: float = 0.0,
    stitch_mode: str = "paste",
) -> torch.Tensor:
    """Full-resolution class logits (H, W, C), on the image's device.

    ``predict_fn``: batched (N, s, s, 3) -> (N, s, s, C) eval-mode logits.
    Patches are resized to ``model_size`` for inference (the reference
    resizes patches to 224 in the dataset, ``uavid_dataset.py:237-243``) and
    the logits bicubic-resized back to the patch size before stitching
    (``uavid_dataset.py:371-374``).
    """
    H, W, _ = image.shape
    if overlap_ratio > 0:
        coords = patching.grid_coords(H, W, grid, overlap_ratio)
    else:
        coords = patching.custom_grid_coords(H, W, grid[0], grid[1])
    patches = patching.extract_patches(image, coords)  # (N, ph, pw, 3)
    _, ph, pw, _ = patches.shape
    x = patches
    if model_size is not None and (ph, pw) != (model_size, model_size):
        x = resize(patches, (model_size, model_size), "bicubic")
    logits = predict_fn(x)  # (N, s, s, C)
    if logits.shape[1:3] != (ph, pw):
        logits = resize(logits, (ph, pw), "bicubic")
    return patching.stitch(logits, coords, (H, W), mode=stitch_mode)


def stitch_from_files(
    logits_dir: str,
    metadata_path: str,
    canvas_hw: Tuple[int, int],
    basename: Optional[str] = None,
    mode: str = "paste",
    device=None,
) -> torch.Tensor:
    """Rebuild a full-resolution logit canvas from per-patch ``.npy`` files
    and ``patches_metadata.json``, the reference stitcher's input format
    (``UAVIDPatchStitch``, ``uavid_dataset.py:279-397``; logits stored CHW).
    Entries whose stem starts with ``basename``, or every entry; logits whose
    size differs from their metadata box are bicubic-resized
    (``uavid_dataset.py:371-374``). The canvas is built on ``device``."""
    meta = patching.load_metadata(metadata_path)
    names = sorted(
        n for n in meta
        if basename is None or os.path.splitext(n)[0].startswith(basename)
    )
    coords, patches = [], []
    for n in names:
        m = meta[n]
        arr = np.load(os.path.join(logits_dir, os.path.splitext(n)[0] + ".npy"))  # (C, h, w)
        p = torch.from_numpy(arr).to(device).permute(1, 2, 0)  # (h, w, C)
        ph, pw = m["y_end"] - m["y_start"], m["x_end"] - m["x_start"]
        if p.shape[:2] != (ph, pw):
            p = resize(p[None], (ph, pw), "bicubic")[0]
        coords.append((m["y_start"], m["y_end"], m["x_start"], m["x_end"]))
        patches.append(p)
    return patching.stitch(torch.stack(patches), coords, canvas_hw, mode=mode)


def evaluate_tiled(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    samples: Iterable[Tuple[torch.Tensor, torch.Tensor]],  # (normalized (H, W, 3), mask (H, W))
    num_classes: int,
    grid: Tuple[int, int] = (2, 2),
    model_size: int = 224,
    overlap_ratio: float = 0.0,
) -> Dict:
    """Streaming stitched evaluation over full-resolution samples, as
    ``evaluate.py`` accumulates per-class intersection, union and correct
    counts; the statistics stay on the samples' device until the end."""
    stats, n = None, 0
    for image, mask in samples:
        if stats is None:
            stats = metrics.seg_stats_init(num_classes, image.device)
        logits = tiled_predict(predict_fn, image, grid, model_size, overlap_ratio)
        stats = metrics.seg_stats_update(stats, logits.argmax(-1), mask)
        n += 1
    out = metrics.seg_stats_finalize(stats if stats is not None
                                     else metrics.seg_stats_init(num_classes))
    out["n_images"] = n
    return out
