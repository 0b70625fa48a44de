"""Fused photometric augmentation: the CUDA kernel K3 in
``csrc/photometric.cu``, its plain PyTorch version, and the per-sample
parameter rows both consume.

Counterpart of ``dinomc_tpu/ops/pallas/augment.py``: the same channel-planar
(B, 3, S, S) f32 layout and the same (B, 24) row layout, so rows drawn by the
JAX package's ``draw_photometric_params`` drive this module unchanged.
With ``flip=True`` the chain starts with each row's horizontal flip
(``P_FLIP``), inside the kernel; with ``flip=False`` ``P_FLIP`` is
informational, as it is in the JAX package, whose TPU kernel leaves the flip
to its caller.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from dinomc_tpu_torch.ops.hopper import _build

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
KERNEL_RADIUS = 6  # 13 taps
N_TAPS = 2 * KERNEL_RADIUS + 1
# params row: flip, jit_apply, fb, fc, fs, fh, gray_apply, blur_apply,
#             sol_apply, <pad>, taps[13], <pad> -> 24 floats
P_FLIP, P_JIT, P_FB, P_FC, P_FS, P_FH, P_GRAY, P_BLUR, P_SOL = range(9)
P_TAPS = 10
P_LEN = 24
SOLARIZE_THRESHOLD = 128.0 / 255.0


def _gray(r, g, b):
    """ITU-R 601-2 luma."""
    return 0.299 * r + 0.587 * g + 0.114 * b


def hue_shift(r, g, b, fh):
    """RGB -> HSV -> (h + fh) mod 1 -> RGB, in the branch-free continuous
    form of the TPU kernel's ``_hue_shift`` (which matches the sector-select
    form to 1e-5). ``fh`` broadcasts against the planes."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h0 = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = h0 * (1.0 / 6.0)
    h = torch.where(h < 0, h + 1.0, h)
    h = torch.where(delta > 0, h, torch.zeros_like(h))
    h = h + fh
    h = torch.where(h < 0, h + 1.0, h)
    h = torch.where(h >= 1.0, h - 1.0, h)
    h6 = h * 6.0
    vs = v * s

    def chan(n):
        k = h6 + n
        k = k - 6.0 * torch.floor(k * (1.0 / 6.0))
        return v - vs * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return chan(5.0), chan(3.0), chan(1.0)


def gaussian_taps(sigma: torch.Tensor, radius: int = KERNEL_RADIUS) -> torch.Tensor:
    """(B, 2r+1) normalized Gaussian taps for per-sample sigma."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)[None, :]
    k = torch.exp(-0.5 * (x / sigma[:, None]) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def draw_photometric_params(
    gen: torch.Generator,
    B: int,
    jitter: Tuple[float, float, float, float],
    p_jit: float,
    p_gray: float,
    p_blur: float,
    p_sol: float,
    blur_range: Tuple[float, float] = (0.1, 2.0),
    p_flip: float = 0.5,
    device=None,
) -> torch.Tensor:
    """Draw the (B, 24) rows from ``gen`` with the distributions of the JAX
    package's ``draw_photometric_params`` (the draws themselves differ: the
    generators are not the same)."""
    dev = device if device is not None else gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(B, generator=gen, device=dev)

    def bern(p):
        return (torch.rand(B, generator=gen, device=dev) < p).float()

    br, ct, sat, hue = jitter
    rows = torch.zeros((B, P_LEN), dtype=torch.float32, device=dev)
    rows[:, P_FLIP] = bern(p_flip)
    rows[:, P_FB] = uniform(1 - br, 1 + br)
    rows[:, P_FC] = uniform(1 - ct, 1 + ct)
    rows[:, P_FS] = uniform(1 - sat, 1 + sat)
    rows[:, P_FH] = uniform(-hue, hue)
    rows[:, P_JIT] = bern(p_jit)
    rows[:, P_GRAY] = bern(p_gray)
    sigma = uniform(*blur_range)
    rows[:, P_BLUR] = bern(p_blur)
    rows[:, P_SOL] = bern(p_sol) if p_sol > 0 else 0.0
    rows[:, P_TAPS:P_TAPS + N_TAPS] = gaussian_taps(sigma)
    return rows


def _blur_axis(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Replicate-padded 13-tap pass along H (axis=2) or W (axis=3) with
    per-sample taps (B, 13), accumulated tap by tap like the kernels."""
    r = KERNEL_RADIUS
    size = x.shape[axis]
    pad = (0, 0, r, r) if axis == 2 else (r, r, 0, 0)
    xp = F.pad(x, pad, mode="replicate")
    t = taps[:, :, None, None, None]  # (B, 13, 1, 1, 1)
    acc = t[:, 0] * xp.narrow(axis, 0, size)
    for i in range(1, N_TAPS):
        acc = acc + t[:, i] * xp.narrow(axis, i, size)
    return acc


def photometric_reference(
    images: torch.Tensor,
    params: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    flip: bool = False,
) -> torch.Tensor:
    """Plain version of K3 over (B, 3, S, S) f32 planar images; ``flip``
    first mirrors the rows whose ``P_FLIP`` is set."""
    x = images
    col = lambda i: params[:, i].view(-1, 1, 1, 1)  # noqa: E731
    on = lambda i: col(i) > 0.5  # noqa: E731
    if flip:
        x = torch.where(on(P_FLIP), x.flip(-1), x)
    fb, fc, fs = col(P_FB), col(P_FC), col(P_FS)
    y = (x * fb).clamp(0.0, 1.0)
    mean_gray = _gray(y[:, 0], y[:, 1], y[:, 2]).mean(dim=(1, 2)).view(-1, 1, 1, 1)
    y = (fc * y + (1.0 - fc) * mean_gray).clamp(0.0, 1.0)
    g3 = _gray(y[:, 0], y[:, 1], y[:, 2])[:, None]
    y = (fs * y + (1.0 - fs) * g3).clamp(0.0, 1.0)
    r2, g2, b2 = hue_shift(y[:, 0], y[:, 1], y[:, 2], params[:, P_FH].view(-1, 1, 1))
    y = torch.stack([r2, g2, b2], dim=1).clamp(0.0, 1.0)
    x = torch.where(on(P_JIT), y, x)
    gr = _gray(x[:, 0], x[:, 1], x[:, 2])[:, None].expand_as(x)
    x = torch.where(on(P_GRAY), gr, x)
    taps = params[:, P_TAPS:P_TAPS + N_TAPS]
    blurred = _blur_axis(_blur_axis(x, taps, 2), taps, 3)
    x = torch.where(on(P_BLUR), blurred, x)
    x = torch.where(on(P_SOL) & (x >= SOLARIZE_THRESHOLD), 1.0 - x, x)
    # per-channel scalars: no host-to-device copy, which would sync the stream
    return torch.stack([(x[:, c] - mean[c]) * (1.0 / std[c]) for c in range(3)], dim=1)


def photometric_kernel(images, params, mean=IMAGENET_MEAN, std=IMAGENET_STD, flip=False):
    """K3 on CUDA tensors: (B, 3, S, S) f32 -> (B, 3, S, S) f32, the rows'
    flips applied first when ``flip``."""
    _build.require_cuda("fused_photometric", images, params)
    if images.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("fused_photometric kernel takes f32 images and params")
    B, C, S, S2 = images.shape
    if C != 3 or S != S2 or params.shape != (B, P_LEN):
        raise ValueError(f"fused_photometric: images (B, 3, S, S) and params (B, {P_LEN}), "
                         f"got {tuple(images.shape)} and {tuple(params.shape)}")
    images, params = images.contiguous(), params.contiguous()
    out = torch.empty_like(images)
    # the mean-gray partial sums of each image's row bands (fewer than S)
    partials = torch.empty((B, S), dtype=torch.float32, device=images.device)
    err = _build.library().dinomc_photometric(
        images.data_ptr(), params.data_ptr(), partials.data_ptr(), out.data_ptr(),
        B, S, int(flip), *map(float, mean), *(1.0 / s for s in std),
        _build.stream_handle(images),
    )
    _build.check(err, "photometric")
    _build.LAUNCHES["photometric"] += 1
    return out


def fused_photometric(
    images: torch.Tensor,
    params: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    flip: bool = False,
) -> torch.Tensor:
    """(Flip +) jitter + gray + blur + solarize + normalize on (B, 3, S, S)
    f32 in [0, 1]. CUDA tensors go through K3; CPU tensors through
    ``photometric_reference``. ``flip=True`` mirrors the rows whose
    ``P_FLIP`` is set first. ``mean=(0,0,0), std=(1,1,1)`` makes the
    normalize an identity."""
    if images.device.type == "cpu":
        return photometric_reference(images, params, mean, std, flip)
    return photometric_kernel(images, params, mean, std, flip)
