"""On-device multi-crop augmentation, main path (DINO-MC).

Counterpart of ``dinomc_tpu/ops/augment.py``'s ``multicrop_augment``. Random
draws are made first (``draw_multicrop``) and applied second
(``multicrop_augment``), so tests can feed the JAX package's own draws.
Per crop: RandomResizedCrop through explicit resampling matrices that
reproduce ``jax.image.scale_and_translate`` (Keys cubic a = -0.5 for the
globals, triangle for the locals, antialiased, weights renormalized,
samples outside the input zeroed), clip to [0, 1], then the horizontal
flip and the photometric chain in one call
(``ops/hopper/augment.fused_photometric(..., flip=True)``). Images
are NHWC at the public functions, as in the JAX package.

The unfused ``color_jitter`` and ``normalize`` serve the segmentation
transform (``data/seg_datasets.augment_batch``), with their draws apart
(``draw_color_jitter``). ``multicrop_augment_tp`` (DINO-TP) is not ported
yet (ROADMAP.md, queue 1 #10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from dinomc_tpu_torch.ops.hopper.augment import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _gray,
    draw_photometric_params,
    fused_photometric,
    hue_shift,
)

__all__ = [
    "IMAGENET_MEAN", "IMAGENET_STD", "MultiCropConfig", "CropDraw",
    "draw_crop_boxes", "draw_multicrop", "resize_weights",
    "random_resized_crop", "multicrop_augment", "JitterDraw",
    "draw_color_jitter", "color_jitter", "normalize",
]

_F32_EPS = float(torch.finfo(torch.float32).eps)


@dataclasses.dataclass(frozen=True)
class MultiCropConfig:
    """Defaults = reference argparse defaults (``main_dino_mc.py:95-132``)."""

    global_size: int = 224
    global_scale: Tuple[float, float] = (0.32, 1.0)
    local_sizes: Tuple[int, ...] = (184, 164, 144, 124, 104, 84)
    local_scale: Tuple[float, float] = (0.05, 0.32)


@dataclasses.dataclass
class CropDraw:
    """Random draws of one crop batch.

    ``boxes``: (B, 4) f32 crop boxes (w, h, x0, y0) in input pixels;
    ``params``: (B, 24) f32 photometric rows, the flip decision in P_FLIP."""

    boxes: torch.Tensor
    params: torch.Tensor


def draw_crop_boxes(
    gen: torch.Generator,
    B: int,
    H: int,
    W: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    device=None,
) -> torch.Tensor:
    """RandomResizedCrop boxes with the JAX package's distribution: area
    fraction U(scale), log-uniform aspect, clamped instead of the
    torchvision rejection loop. Returns (B, 4) = (w, h, x0, y0)."""
    dev = device if device is not None else gen.device

    def rand():
        return torch.rand(B, generator=gen, device=dev)

    target_area = (scale[0] + (scale[1] - scale[0]) * rand()) * (H * W)
    lr0, lr1 = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lr0 + (lr1 - lr0) * rand())
    w = torch.sqrt(target_area * aspect).clamp(1.0, W)
    h = torch.sqrt(target_area / aspect).clamp(1.0, H)
    x0 = rand() * (W - w)
    y0 = rand() * (H - h)
    return torch.stack([w, h, x0, y0], dim=1)


def draw_multicrop(
    gen: torch.Generator, B: int, H: int, W: int, cfg: MultiCropConfig, device=None,
) -> List[CropDraw]:
    """Draws for the two global crops (blur p=1.0; blur p=0.1 + solarize
    p=0.2) and each local crop (SimCLR color distortion, blur p=0.5),
    ``dino_augmentation.py:24-52,106-112``."""
    draws = []
    for variant in (0, 1):
        boxes = draw_crop_boxes(gen, B, H, W, cfg.global_scale, device=device)
        params = draw_photometric_params(
            gen, B, (0.4, 0.4, 0.2, 0.1), p_jit=0.8, p_gray=0.2,
            p_blur=(1.0 if variant == 0 else 0.1),
            p_sol=(0.2 if variant == 1 else 0.0), device=device,
        )
        draws.append(CropDraw(boxes, params))
    for _ in cfg.local_sizes:
        boxes = draw_crop_boxes(gen, B, H, W, cfg.local_scale, device=device)
        params = draw_photometric_params(
            gen, B, (0.8, 0.8, 0.8, 0.2), p_jit=0.8, p_gray=0.2, p_blur=0.5,
            p_sol=0.0, device=device,
        )
        draws.append(CropDraw(boxes, params))
    return draws


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def resize_weights(
    in_size: int, out_size: int, scale: torch.Tensor, translation: torch.Tensor,
    method: str,
) -> torch.Tensor:
    """Per-sample (B, out, in) f32 resampling matrices of
    ``jax.image.scale_and_translate`` (``jax/_src/image/scale.py``
    ``compute_weight_mat``, antialias on), for scale/translation (B,)."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None]  # (B, 1)
    kernel_scale = inv_scale.clamp_min(1.0)
    sample_f = (
        (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale
        - translation[:, None] * inv_scale - 0.5
    )  # (B, out)
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - src[None, :, None]).abs() / kernel_scale[:, :, None]
    w = _KERNELS[method](x)  # (B, in, out)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[:, None, :], w, torch.zeros_like(w))
    return w.transpose(1, 2)


def random_resized_crop(
    images: torch.Tensor, boxes: torch.Tensor, out_size: int, method: str = "bicubic",
) -> torch.Tensor:
    """Crop ``boxes`` (B, 4) out of planar (B, C, H, W) f32 images and resize
    to (B, C, out, out) as two batched products with the resampling
    matrices; clipped to [0, 1] like the JAX package."""
    _, _, H, W = images.shape
    w, h, x0, y0 = boxes.unbind(1)
    scale_y = out_size / h
    scale_x = out_size / w
    wh = resize_weights(H, out_size, scale_y, -y0 * scale_y, method)  # (B, S, H)
    ww = resize_weights(W, out_size, scale_x, -x0 * scale_x, method)  # (B, S, W)
    out = wh[:, None] @ images @ ww.transpose(1, 2)[:, None]
    return out.clamp(0.0, 1.0)


def _crop(images, draw: CropDraw, size: int, method: str) -> torch.Tensor:
    """Planar images -> resized crop -> flip and photometric (one K3 call)
    -> NHWC."""
    x = random_resized_crop(images, draw.boxes, size, method)
    return fused_photometric(x, draw.params, flip=True).permute(0, 2, 3, 1)


def multicrop_augment(
    images: torch.Tensor, draws: Sequence[CropDraw], cfg: MultiCropConfig = MultiCropConfig(),
):
    """images (B, H, W, 3) uint8 or f32 in [0, 1] -> (globals (2, B, S, S, 3),
    tuple of locals (B, s, s, 3)), all f32 on the images' device. uint8
    input (the packed-shard wire format) becomes f32/255 here."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    planar = images.permute(0, 3, 1, 2)
    g = [_crop(planar, draws[i], cfg.global_size, "bicubic") for i in range(2)]
    locals_ = tuple(
        _crop(planar, draws[2 + i], s, "bilinear") for i, s in enumerate(cfg.local_sizes)
    )
    return torch.stack(g, dim=0), locals_


@dataclasses.dataclass
class JitterDraw:
    """Per-sample ColorJitter draws, each (B,): brightness, contrast and
    saturation factors, and hue shift."""

    fb: torch.Tensor
    fc: torch.Tensor
    fs: torch.Tensor
    fh: torch.Tensor


def draw_color_jitter(
    gen: torch.Generator, B: int, brightness: float, contrast: float,
    saturation: float, hue: float, device=None,
) -> JitterDraw:
    dev = device if device is not None else gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=gen, device=dev)

    return JitterDraw(
        fb=uniform(1 - brightness, 1 + brightness),
        fc=uniform(1 - contrast, 1 + contrast),
        fs=uniform(1 - saturation, 1 + saturation),
        fh=uniform(-hue, hue),
    )


def color_jitter(images: torch.Tensor, d: JitterDraw) -> torch.Tensor:
    """torchvision ColorJitter over NHWC f32 images in [0, 1], in the JAX
    package's fixed brightness, contrast, saturation, hue order
    (``dinomc_tpu/ops/augment.color_jitter``), applied to every sample, as
    the segmentation transform calls it (``p=1``). The hue stage always
    runs: every segmentation dataset jitters hue (the JAX package skips the
    stage for a zero hue range)."""
    col = lambda f: f.view(-1, 1, 1, 1)  # noqa: E731

    def gray(x):
        return _gray(x[..., 0], x[..., 1], x[..., 2])[..., None]

    x = (images * col(d.fb)).clamp(0.0, 1.0)
    mean_gray = gray(x).mean(dim=(1, 2, 3), keepdim=True)
    x = (col(d.fc) * x + (1 - col(d.fc)) * mean_gray).clamp(0.0, 1.0)
    x = (col(d.fs) * x + (1 - col(d.fs)) * gray(x)).clamp(0.0, 1.0)
    x = torch.stack(hue_shift(x[..., 0], x[..., 1], x[..., 2], d.fh.view(-1, 1, 1)), dim=-1)
    return x.clamp(0.0, 1.0)


def normalize(
    images: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> torch.Tensor:
    """(x - mean) / std over the last (channel) axis."""
    m = torch.tensor(mean, dtype=torch.float32).to(images.device, non_blocking=True)
    s = torch.tensor(std, dtype=torch.float32).to(images.device, non_blocking=True)
    return (images - m) / s
