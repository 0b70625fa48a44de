"""Visualization helpers: de-normalization, image grids, OSCD change panels
and the segmentation legend figure.

Counterpart of ``dinomc_tpu/utils/visualization.py`` (reference
``utils/visualization.py``: ``make_numpy_grid``, ``de_norm``,
``transform_convert``; the prediction overlay and legend of
``inference_segmentation.py:visualize_segmentation``, whose reference version
is broken, with an undefined ``save_path``). Host-side numpy and PIL;
matplotlib is optional: without it the figure is a PIL overlay.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from dinomc_tpu_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD


def de_norm(
    images: np.ndarray,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> np.ndarray:
    """Invert dataset normalization; (..., 3) float -> [0, 1] float."""
    return np.clip(np.asarray(images) * np.asarray(std) + np.asarray(mean), 0, 1)


def make_numpy_grid(images: np.ndarray, pad: int = 2, pad_value: float = 1.0) -> np.ndarray:
    """(N, H, W, C) -> one (GH, GW, C) tile grid (torchvision ``make_grid``
    for NHWC numpy)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    grid = np.full((rows * (h + pad) + pad, cols * (w + pad) + pad, c), pad_value, images.dtype)
    for i in range(n):
        r, cl = divmod(i, cols)
        y0 = pad + r * (h + pad)
        x0 = pad + cl * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    return grid


def transform_convert(
    image: np.ndarray,
    mean: Optional[Sequence[float]] = IMAGENET_MEAN,
    std: Optional[Sequence[float]] = IMAGENET_STD,
):
    """Normalized float array -> displayable uint8 PIL image (reference
    ``transform_convert``). Takes (H, W, 3), (H, W, 1) or (H, W), or CHW;
    ``mean=None`` skips the de-normalization of [0, 1] inputs."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3 and img.shape[-1] not in (1, 3) and img.shape[0] in (1, 3):
        img = np.moveaxis(img, 0, -1)  # accept CHW for torch-shaped inputs
    if mean is not None:
        img = de_norm(img, mean, std)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f"expected (H,W), (H,W,1) or (H,W,3); got {image.shape}")
    from PIL import Image

    return Image.fromarray(np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))


def save_change_panel(
    save_path: str,
    img1: np.ndarray,  # (H, W, 3) [0, 1]
    img2: np.ndarray,  # (H, W, 3) [0, 1]
    gt: np.ndarray,  # (H, W) {0, 1}
    pred: np.ndarray,  # (H, W) {0, 1}, already thresholded
    pad: int = 2,
) -> None:
    """One (img1 | img2 | gt | pred) strip as a PNG: the four views the
    reference logs to TensorBoard for each OSCD sample
    (``main_oscd.py:54-78``)."""

    def _rgb(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = np.repeat(x[..., None], 3, axis=-1)
        return np.clip(x, 0, 1)

    tiles = np.stack([_rgb(img1), _rgb(img2), _rgb(gt), _rgb(pred)])
    n, h, w, _ = tiles.shape
    strip = np.full((h + 2 * pad, n * (w + pad) + pad, 3), 1.0, np.float32)
    for i in range(n):
        x0 = pad + i * (w + pad)
        strip[pad : pad + h, x0 : x0 + w] = tiles[i]
    from PIL import Image

    Image.fromarray(np.clip(strip * 255.0 + 0.5, 0, 255).astype(np.uint8)).save(save_path)


def save_segmentation_figure(
    image: np.ndarray,  # (H, W, 3) [0, 1]
    pred_mask: np.ndarray,  # (H, W) class ids
    class_names: Sequence[str],
    palette: Sequence[Sequence[int]],
    save_path: str,
    gt_mask: Optional[np.ndarray] = None,
    alpha: float = 0.5,
) -> None:
    """Side-by-side image / prediction (/ ground truth) figure with a class
    legend; a PIL overlay of the prediction where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt
    except ImportError:
        _save_overlay_png(image, pred_mask, palette, save_path, alpha)
        return

    pal = np.asarray(palette, np.float32) / 255.0
    panels = 2 + (gt_mask is not None)
    fig, axes = plt.subplots(1, panels, figsize=(5 * panels, 5))
    axes[0].imshow(image)
    axes[0].set_title("image")
    axes[1].imshow(pal[np.clip(pred_mask, 0, len(pal) - 1)])
    axes[1].set_title("prediction")
    if gt_mask is not None:
        axes[2].imshow(pal[np.clip(gt_mask, 0, len(pal) - 1)])
        axes[2].set_title("ground truth")
    for ax in axes:
        ax.axis("off")
    handles = [mpatches.Patch(color=pal[i], label=name) for i, name in enumerate(class_names)]
    fig.legend(handles=handles, loc="lower center", ncol=min(len(class_names), 8))
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def _save_overlay_png(image, pred_mask, palette, save_path, alpha):
    from PIL import Image

    pal = np.asarray(palette, np.uint8)
    color = pal[np.clip(pred_mask, 0, len(pal) - 1)]
    overlay = ((1 - alpha) * image * 255 + alpha * color).astype(np.uint8)
    Image.fromarray(overlay).save(save_path)
