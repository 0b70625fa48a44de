"""Port photometric chain (dinomc_tpu_torch/ops/hopper/augment.py) against
the JAX package.

K3's plain version ``photometric_reference`` is held against the JAX
package's unfused chain (flip, color jitter, grayscale, blur, solarize,
normalize: tests/test_fused_augment.py's reference), fed with rows from JAX
``draw_photometric_params`` on the same keys, at that file's atol 2e-4. The
CUDA kernel is held against the plain version on the card (``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ops import augment as xaug
from dinomc_tpu.ops.pallas import augment as paug
from dinomc_tpu_torch.ops.hopper import augment as haug
from _torch_port import cuda_device, n, one_torch_thread, t  # noqa: F401

CHAINS = [  # jitter, p_jit, p_gray, p_blur, p_sol
    pytest.param((0.4, 0.4, 0.2, 0.1), 0.8, 0.2, 1.0, 0.0, id="global-crop-1"),
    pytest.param((0.4, 0.4, 0.2, 0.1), 0.8, 0.2, 0.1, 0.2, id="global-crop-2"),
    pytest.param((0.8, 0.8, 0.8, 0.2), 0.8, 0.2, 0.5, 0.0, id="local-crop"),
    pytest.param((0.8, 0.8, 0.8, 0.2), 1.0, 0.5, 0.5, 0.5, id="jitter-always"),
]


def _unfused_chain(x, k, jitter, p_jit, p_gray, p_blur, p_sol):
    x = xaug.random_hflip(k[1], x)
    x = xaug.color_jitter(k[2], x, *jitter, p=p_jit)
    x = xaug.random_grayscale(k[3], x, p=p_gray)
    x = xaug.gaussian_blur(k[4], x, p=p_blur)
    if p_sol > 0:
        x = xaug.random_solarize(k[5], x, p=p_sol)
    return xaug.normalize(x)


def _port_chain(x_nhwc, rows, mean=haug.IMAGENET_MEAN, std=haug.IMAGENET_STD):
    """Flip by row P_FLIP (the caller's job, as in the JAX package), then the
    photometric wrapper on planar CPU tensors."""
    x = t(x_nhwc).permute(0, 3, 1, 2)
    flip = (rows[:, haug.P_FLIP] > 0.5)[:, None, None, None]
    x = torch.where(flip, x.flip(-1), x)
    return haug.fused_photometric(x, rows, mean, std).permute(0, 2, 3, 1)


@pytest.mark.parametrize("jitter,p_jit,p_gray,p_blur,p_sol", CHAINS)
def test_plain_version_matches_jax_unfused_chain(jitter, p_jit, p_gray, p_blur, p_sol):
    B, S, seed = 8, 40, 3
    k = jax.random.split(jax.random.PRNGKey(seed), 6)
    x = np.random.default_rng(seed).uniform(size=(B, S, S, 3)).astype(np.float32)
    ref = np.asarray(_unfused_chain(jnp.asarray(x), k, jitter, p_jit, p_gray, p_blur, p_sol))
    rows = paug.draw_photometric_params(
        k[1], k[2], k[3], k[4], k[5] if p_sol > 0 else None, B, jitter,
        p_jit=p_jit, p_gray=p_gray, p_blur=p_blur, p_sol=p_sol,
    )
    out = n(_port_chain(x, t(rows)))
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_identity_normalize_matches_jax():
    """mean 0 / std 1: the normalize-free form (the DINO-TP pre-crop chain)."""
    B, S = 6, 40
    x = np.random.default_rng(21).uniform(size=(B, S, S, 3)).astype(np.float32)
    k = jax.random.split(jax.random.PRNGKey(22), 4)
    rows = paug.draw_photometric_params(
        k[3], k[0], k[1], k[2], None, B, (0.4, 0.4, 0.4, 0.1),
        p_jit=0.0, p_gray=0.5, p_blur=0.5, p_sol=0.0,
    )
    ref = xaug.random_grayscale(k[1], jnp.asarray(x), p=0.5)
    ref = xaug.gaussian_blur(k[2], ref, p=0.5)
    ref = np.asarray(xaug.random_hflip(k[3], ref))
    out = n(_port_chain(x, t(rows), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    np.testing.assert_allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("fh", [0.0, 0.07, -0.18, 0.5])
def test_hue_shift_matches_jax(fh):
    x = np.random.default_rng(11).uniform(size=(64, 64, 3)).astype(np.float32)
    ref = paug._hue_shift(x[..., 0], x[..., 1], x[..., 2], fh)
    got = haug.hue_shift(t(x[..., 0]), t(x[..., 1]), t(x[..., 2]), fh)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)


def test_gaussian_taps_match_jax():
    sigma = np.linspace(0.1, 2.0, 7).astype(np.float32)
    ref = np.asarray(xaug._gaussian_kernel_1d(jnp.asarray(sigma), 6))
    np.testing.assert_allclose(n(haug.gaussian_taps(t(sigma))), ref, atol=1e-7)


def test_row_layout_matches_jax():
    assert (haug.P_FLIP, haug.P_JIT, haug.P_FB, haug.P_FC, haug.P_FS, haug.P_FH,
            haug.P_GRAY, haug.P_BLUR, haug.P_SOL, haug.P_TAPS, haug.P_LEN) == (
        paug.P_FLIP, paug.P_JIT, paug.P_FB, paug.P_FC, paug.P_FS, paug.P_FH,
        paug.P_GRAY, paug.P_BLUR, paug.P_SOL, paug.P_TAPS, paug.P_LEN)


def test_draw_photometric_params_distributions():
    gen = torch.Generator().manual_seed(0)
    B = 4096
    rows = haug.draw_photometric_params(gen, B, (0.4, 0.3, 0.2, 0.1), 0.8, 0.2, 0.5, 0.2)
    assert rows.shape == (B, haug.P_LEN)
    for col, p in ((haug.P_JIT, 0.8), (haug.P_GRAY, 0.2), (haug.P_BLUR, 0.5),
                   (haug.P_SOL, 0.2), (haug.P_FLIP, 0.5)):
        vals = rows[:, col]
        assert set(vals.unique().tolist()) <= {0.0, 1.0}
        assert abs(vals.mean().item() - p) < 0.03
    for col, lo, hi in ((haug.P_FB, 0.6, 1.4), (haug.P_FC, 0.7, 1.3),
                        (haug.P_FS, 0.8, 1.2), (haug.P_FH, -0.1, 0.1)):
        assert rows[:, col].min() >= lo and rows[:, col].max() <= hi
    taps = rows[:, haug.P_TAPS:haug.P_TAPS + haug.N_TAPS]
    np.testing.assert_allclose(n(taps.sum(1)), 1.0, atol=1e-6)
    assert (rows[:, haug.P_TAPS + haug.N_TAPS:] == 0).all()
    no_sol = haug.draw_photometric_params(gen, 64, (0.4, 0.4, 0.2, 0.1), 0.8, 0.2, 1.0, 0.0)
    assert (no_sol[:, haug.P_SOL] == 0).all() and (no_sol[:, haug.P_BLUR] == 1).all()


def test_all_stages_off_is_normalize_only():
    x = torch.rand(3, 3, 20, 20, generator=torch.Generator().manual_seed(1))
    rows = torch.zeros(3, haug.P_LEN)
    out = haug.fused_photometric(x, rows)
    m = torch.tensor(haug.IMAGENET_MEAN).view(1, 3, 1, 1)
    s = torch.tensor(haug.IMAGENET_STD).view(1, 3, 1, 1)
    np.testing.assert_allclose(n(out), n((x - m) / s), atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        haug.photometric_kernel(torch.rand(2, 3, 8, 8), torch.zeros(2, haug.P_LEN))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [224, 84, 37])
def test_kernel_matches_plain_on_card(cuda_device, S):
    """K3 against the plain version in f32, atol 1e-4 (as chip_smoke.py)."""
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    x = torch.rand(8, 3, S, S, generator=gen, device=cuda_device)
    rows = haug.draw_photometric_params(gen, 8, (0.8, 0.8, 0.8, 0.2), 0.5, 0.5, 0.5, 0.5)
    out = haug.photometric_kernel(x, rows)
    torch.cuda.synchronize()
    ref = haug.photometric_reference(x, rows)
    assert (out - ref).abs().max().item() <= 1e-4
