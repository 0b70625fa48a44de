"""Joint geometric augmentation for segmentation (image + mask).

Counterpart of ``dinomc_tpu/ops/spatial.py`` (reference albumentations
pipeline, ``uavid_dataset.py:47-53`` / ``udd6_dataset.py:39-46``): joint
horizontal/vertical flips and an ``OneOf`` over {rotate, translate, scale,
shear} with per-sample parameters, warped about the image centre with zero
fill, bilinear for the image and nearest for the mask. Draws are apart from
compute: ``draw_affine`` and ``draw_flips`` make the per-sample parameters,
``affine_matrices``, ``joint_flip``, ``random_affine_pair`` and ``_warp``
apply them. Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AffineConfig:
    """Per-dataset affine ranges. Defaults = UAVid (``uavid_dataset.py:47-53``);
    UDD6 uses rotate=(-90, 90), p=0.9 (``udd6_dataset.py:39-46``)."""

    rotate_deg: float = 10.0
    translate_frac: float = 0.05
    scale_range: Tuple[float, float] = (0.9, 1.1)
    shear_deg: float = 5.0
    # albumentations OneOf inner weights (rotate, translate, scale, shear)
    weights: Tuple[float, float, float, float] = (0.7, 0.5, 0.5, 0.5)
    p: float = 0.8


UAVID_AFFINE = AffineConfig()
UDD6_AFFINE = AffineConfig(rotate_deg=90.0, weights=(0.7, 0.2, 0.5, 0.5), p=0.9)


@dataclasses.dataclass
class AffineDraw:
    """Per-sample draws of the affine OneOf, each (B,): the transform chosen
    (0 rotate, 1 translate, 2 scale, 3 shear), whether any applies, and the
    candidate parameters (angles in radians)."""

    choice: torch.Tensor
    apply: torch.Tensor
    theta: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    sc: torch.Tensor
    sh: torch.Tensor


def draw_affine(gen: torch.Generator, B: int, cfg: AffineConfig, device=None) -> AffineDraw:
    dev = device if device is not None else gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=gen, device=dev)

    w = torch.tensor(cfg.weights, dtype=torch.float32, device=dev)
    rad = math.pi / 180.0
    return AffineDraw(
        choice=torch.multinomial(w, B, replacement=True, generator=gen),
        apply=torch.rand(B, generator=gen, device=dev) < cfg.p,
        theta=uniform(-cfg.rotate_deg, cfg.rotate_deg) * rad,
        tx=uniform(-cfg.translate_frac, cfg.translate_frac),
        ty=uniform(-cfg.translate_frac, cfg.translate_frac),
        sc=uniform(*cfg.scale_range),
        sh=uniform(-cfg.shear_deg, cfg.shear_deg) * rad,
    )


def draw_flips(gen: torch.Generator, B: int, p_h: float, p_v: float, device=None):
    """(flip_h, flip_v), each (B,) bool."""
    dev = device if device is not None else gen.device
    fh = torch.rand(B, generator=gen, device=dev) < p_h
    fv = torch.rand(B, generator=gen, device=dev) < p_v
    return fh, fv


def affine_matrices(d: AffineDraw) -> torch.Tensor:
    """(B, 6) inverse maps (output px -> input px, centre origin) of the
    one transform each sample applies: [a, b, tx, c, d, ty]."""

    def on(which, val, ident):
        return torch.where(d.apply & (d.choice == which), val, torch.full_like(val, ident))

    theta, sc, sh = on(0, d.theta, 0.0), on(2, d.sc, 1.0), on(3, d.sh, 0.0)
    tx, ty = on(1, d.tx, 0.0), on(1, d.ty, 0.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    inv_sc = 1.0 / sc
    # inverse rotation [cos sin; -sin cos] / scale, inverse shear-x [1 -tan; 0 1]
    return torch.stack(
        [cos * inv_sc, sin * inv_sc - torch.tan(sh), tx, -sin * inv_sc, cos * inv_sc, ty], dim=1
    )


def _warp(images: torch.Tensor, mats: torch.Tensor, method: str) -> torch.Tensor:
    """Inverse-mapped warp of (B, H, W, C) float images by (B, 6) maps
    (translation as a fraction of the size); outside samples are 0."""
    B, H, W, C = images.shape
    dev = images.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2.0
    xs = torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    a, b, tx, c, d, ty = (m.view(B, 1, 1) for m in mats.unbind(1))
    src_x = a * gx + b * gy - tx * W + (W - 1) / 2.0
    src_y = c * gx + d * gy - ty * H + (H - 1) / 2.0
    inside = (src_x >= 0) & (src_x <= W - 1) & (src_y >= 0) & (src_y <= H - 1)
    flat = images.reshape(B, H * W, C)

    def at(iy, ix):  # (B, H, W) indices -> (B, H, W, C) samples
        idx = (iy * W + ix).reshape(B, H * W, 1).expand(B, H * W, C)
        return flat.gather(1, idx).reshape(B, H, W, C)

    if method == "nearest":
        out = at(src_y.round().long().clamp(0, H - 1), src_x.round().long().clamp(0, W - 1))
    else:
        x0 = src_x.floor().long().clamp(0, W - 1)
        y0 = src_y.floor().long().clamp(0, H - 1)
        x1, y1 = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
        fx = (src_x - x0).clamp(0.0, 1.0)[..., None]
        fy = (src_y - y0).clamp(0.0, 1.0)[..., None]
        out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
               + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def random_affine_pair(
    images: torch.Tensor, masks: torch.Tensor, mats: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same per-sample affine on image (bilinear) and mask (nearest);
    fill 0 (albumentations' default cval)."""
    out_img = _warp(images, mats, "bilinear")
    out_mask = _warp(masks[..., None].float(), mats, "nearest")[..., 0].to(masks.dtype)
    return out_img, out_mask


def joint_flip(
    images: torch.Tensor, masks: torch.Tensor, flip_h: torch.Tensor, flip_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint horizontal then vertical flips, per-sample (B,) bool."""
    fh = flip_h.view(-1, 1, 1)
    images = torch.where(fh[..., None], images.flip(2), images)
    masks = torch.where(fh, masks.flip(2), masks)
    fv = flip_v.view(-1, 1, 1)
    images = torch.where(fv[..., None], images.flip(1), images)
    masks = torch.where(fv, masks.flip(1), masks)
    return images, masks
