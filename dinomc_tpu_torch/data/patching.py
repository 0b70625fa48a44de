"""Patch tiling and logit stitching: the tiled full-resolution inference path.

Counterpart of ``dinomc_tpu/data/patching.py``. The reference does this as
three offline stages joined by files (``utils/patch_cropper.py`` writes
patch PNGs and ``patches_metadata.json``; ``inference_*_patched_dataset.py``
exports per-patch ``.npy`` logits; ``UAVIDPatchStitch`` + ``evaluate.py``
paste them back into a full-resolution canvas and score it). Here the same
geometry is a library: the coordinates follow the reference's formulas, so
its metadata files interoperate, and ``extract_patches`` / ``stitch`` run
on torch tensors on their device (``eval/tiled_inference.py``).

Geometry:
  * ``grid_coords(..., overlap)``: patch = stride * (1 + o), step =
    stride * (1 - o), clamped at the borders (``patch_cropper.py:107-121``);
  * ``custom_grid_coords``: an exact m x n grid (``patch_cropper.py:139-186``);
  * metadata entries ``{x_start, y_start, x_end, y_end}``
    (``patch_cropper.py:131-134``).

Patches and canvases are NHWC / HWC, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Coord = Tuple[int, int, int, int]  # (y0, y1, x0, x1)


def grid_from_arg(grid) -> Tuple[int, int]:
    """4 -> (2, 2), 9 -> (3, 3), (r, c) -> (r, c) (``patch_cropper.py`` helper)."""
    if isinstance(grid, (tuple, list)):
        return int(grid[0]), int(grid[1])
    n = int(grid)
    r = int(round(n**0.5))
    if r * r != n:
        raise ValueError(f"grid {n} is not a perfect square; pass (rows, cols)")
    return r, r


def grid_coords(h: int, w: int, grid, overlap_ratio: float = 0.0) -> List[Coord]:
    """Overlapping grid coords (reference ``split_and_save_image`` geometry)."""
    if not (0.0 <= overlap_ratio < 1.0):
        raise ValueError("overlap_ratio must be in [0, 1)")
    rows, cols = grid_from_arg(grid)
    stride_x, stride_y = w / cols, h / rows
    patch_w = int(round(stride_x * (1 + overlap_ratio)))
    patch_h = int(round(stride_y * (1 + overlap_ratio)))
    step_x = int(round(stride_x * (1 - overlap_ratio)))
    step_y = int(round(stride_y * (1 - overlap_ratio)))
    coords = []
    for r in range(rows):
        for c in range(cols):
            x0 = min(c * step_x, w - patch_w)
            y0 = min(r * step_y, h - patch_h)
            coords.append((y0, y0 + patch_h, x0, x0 + patch_w))
    return coords


def custom_grid_coords(h: int, w: int, rows: int, cols: int) -> List[Coord]:
    """Exact m x n grid (reference ``split_image_and_mask_custom_grid``)."""
    ph, pw = h // rows, w // cols
    return [
        (r * ph, (r + 1) * ph, c * pw, (c + 1) * pw)
        for r in range(rows)
        for c in range(cols)
    ]


def coords_to_metadata(
    coords: Sequence[Coord], base: str, fmt: str = "{base}_{row}_{col}.png", cols: int = None
) -> Dict[str, Dict[str, int]]:
    """Reference-compatible ``patches_metadata.json`` entries."""
    meta = {}
    n = len(coords)
    if cols is None:
        cols = int(round(n**0.5))
    for i, (y0, y1, x0, x1) in enumerate(coords):
        fname = fmt.format(base=base, row=i // cols, col=i % cols)
        meta[fname] = dict(x_start=x0, y_start=y0, x_end=x1, y_end=y1)
    return meta


def metadata_to_coords(meta: Dict[str, Dict[str, int]], names: Sequence[str]) -> List[Coord]:
    return [
        (meta[n]["y_start"], meta[n]["y_end"], meta[n]["x_start"], meta[n]["x_end"])
        for n in names
    ]


# ---------------------------------------------------------------------------
# device-side extract / stitch
# ---------------------------------------------------------------------------


def extract_patches(image: torch.Tensor, coords: Sequence[Coord]) -> torch.Tensor:
    """(H, W, C) + N same-size coords -> (N, ph, pw, C) stacked patches."""
    sizes = {(y1 - y0, x1 - x0) for y0, y1, x0, x1 in coords}
    assert len(sizes) == 1, f"patches must share one size, got {sizes}"
    return torch.stack([image[y0:y1, x0:x1] for y0, y1, x0, x1 in coords])


def stitch(
    patches: torch.Tensor,  # (N, ph, pw, C) logits (or probs)
    coords: Sequence[Coord],
    canvas_hw: Tuple[int, int],
    mode: str = "paste",
) -> torch.Tensor:
    """Reassemble patch tensors into an (H, W, C) canvas on their device.

    mode='paste' is the reference stitcher (later patches overwrite,
    ``uavid_dataset.py:355-397``); mode='mean' averages overlapping regions,
    dividing by max(weight, 1).
    """
    H, W = canvas_hw
    C = patches.shape[-1]
    canvas = torch.zeros((H, W, C), dtype=patches.dtype, device=patches.device)
    if mode == "paste":
        for p, (y0, y1, x0, x1) in zip(patches, coords):
            canvas[y0:y1, x0:x1] = p
        return canvas
    if mode == "mean":
        weight = torch.zeros((H, W, 1), dtype=patches.dtype, device=patches.device)
        for p, (y0, y1, x0, x1) in zip(patches, coords):
            canvas[y0:y1, x0:x1] += p
            weight[y0:y1, x0:x1] += 1.0
        return canvas / weight.clamp_min(1.0)
    raise ValueError(f"unknown stitch mode {mode}")


# ---------------------------------------------------------------------------
# host-side offline tiler (file-format compatible with the reference)
# ---------------------------------------------------------------------------


def split_and_save(
    image: np.ndarray,
    mask: Optional[np.ndarray],
    img_dir: str,
    msk_dir: Optional[str],
    base: str,
    grid=(2, 2),
    overlap_ratio: float = 0.0,
    meta: Optional[Dict] = None,
) -> List[str]:
    """Offline tiler writing patch PNGs + metadata (parity with
    ``patch_cropper.split_and_save_image`` / ``..._custom_grid``)."""
    from PIL import Image

    h, w = image.shape[:2]
    rows, cols = grid_from_arg(grid)
    if overlap_ratio > 0:
        coords = grid_coords(h, w, (rows, cols), overlap_ratio)
    else:
        coords = custom_grid_coords(h, w, rows, cols)
    Path(img_dir).mkdir(parents=True, exist_ok=True)
    if msk_dir:
        Path(msk_dir).mkdir(parents=True, exist_ok=True)
    written = []
    for i, (y0, y1, x0, x1) in enumerate(coords):
        fname = f"{base}_{i // cols}_{i % cols}.png"
        Image.fromarray(image[y0:y1, x0:x1]).save(os.path.join(img_dir, fname))
        if mask is not None and msk_dir:
            Image.fromarray(mask[y0:y1, x0:x1]).save(os.path.join(msk_dir, fname))
        written.append(fname)
        if meta is not None:
            meta[fname] = dict(x_start=x0, y_start=y0, x_end=x1, y_end=y1)
    return written


def save_metadata(meta: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)


def load_metadata(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
