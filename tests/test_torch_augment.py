"""Port multi-crop augmentation (dinomc_tpu_torch/ops/augment.py) against
the JAX package.

``random_resized_crop`` is held against ``jax.image.scale_and_translate``
on the same crop boxes (atol 1e-5); ``multicrop_augment`` is fed the JAX
package's own draws (crop boxes from the key structure of its
``random_resized_crop``, photometric rows from ``draw_photometric_params``)
and held against JAX ``multicrop_augment(..., fused="off")`` at the
photometric chain's atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ops import augment as xaug
from dinomc_tpu.ops.pallas import augment as paug
from dinomc_tpu_torch.ops import augment as taug
from _torch_port import n, one_torch_thread, t  # noqa: F401

MC = dict(local_sizes=(24, 16), global_size=32)


def _jax_boxes(rng, B, H, W, scale, ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """The draws of JAX ``random_resized_crop`` (augment.py:63-76) as
    (B, 4) = (w, h, x0, y0)."""
    k_area, k_ratio, k_x, k_y = jax.random.split(rng, 4)
    target_area = jax.random.uniform(k_area, (B,), minval=scale[0], maxval=scale[1]) * (H * W)
    log_ratio = jax.random.uniform(
        k_ratio, (B,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])
    )
    aspect = jnp.exp(log_ratio)
    w = jnp.clip(jnp.sqrt(target_area * aspect), 1.0, W)
    h = jnp.clip(jnp.sqrt(target_area / aspect), 1.0, H)
    x0 = jax.random.uniform(k_x, (B,)) * (W - w)
    y0 = jax.random.uniform(k_y, (B,)) * (H - h)
    return np.asarray(jnp.stack([w, h, x0, y0], axis=1))


def _jax_draws(rng, B, H, W, cfg):
    """The JAX package's draws for one ``multicrop_augment`` call, in the
    port's CropDraw form (key structure of augment.py:314-378)."""
    keys = jax.random.split(rng, 2 + len(cfg.local_sizes))
    draws = []
    for variant in (0, 1):
        k = jax.random.split(keys[variant], 6)
        rows = paug.draw_photometric_params(
            k[1], k[2], k[3], k[4], k[5] if variant == 1 else None, B,
            (0.4, 0.4, 0.2, 0.1), p_jit=0.8, p_gray=0.2,
            p_blur=(1.0 if variant == 0 else 0.1), p_sol=(0.2 if variant == 1 else 0.0),
        )
        draws.append(taug.CropDraw(t(_jax_boxes(k[0], B, H, W, cfg.global_scale)), t(rows)))
    for i in range(len(cfg.local_sizes)):
        r = keys[2 + i]
        k = jax.random.split(r, 4)
        rows = paug.draw_photometric_params(
            k[1], k[2], k[3], jax.random.fold_in(r, 7), None, B,
            (0.8, 0.8, 0.8, 0.2), p_jit=0.8, p_gray=0.2, p_blur=0.5, p_sol=0.0,
        )
        draws.append(taug.CropDraw(t(_jax_boxes(k[0], B, H, W, cfg.local_scale)), t(rows)))
    return draws


@pytest.mark.parametrize("method,out_size,scale", [
    ("bicubic", 32, (0.32, 1.0)),
    ("bilinear", 24, (0.05, 0.32)),
    ("bicubic", 40, (0.05, 0.32)),  # upsampling: no antialias widening
    ("bilinear", 16, (0.32, 1.0)),
])
def test_random_resized_crop_matches_scale_and_translate(method, out_size, scale):
    B, H, W, C = 5, 48, 56, 3
    img = np.random.default_rng(0).uniform(size=(B, H, W, C)).astype(np.float32)
    boxes = _jax_boxes(jax.random.PRNGKey(out_size), B, H, W, scale)
    ref = []
    for b in range(B):
        w, h, x0, y0 = boxes[b]
        sy, sx = out_size / h, out_size / w
        ref.append(jax.image.scale_and_translate(
            jnp.asarray(img[b]), (out_size, out_size, C), (0, 1),
            jnp.asarray([sy, sx], jnp.float32), jnp.asarray([-y0 * sy, -x0 * sx], jnp.float32),
            method=method,
        ))
    ref = np.clip(np.stack([np.asarray(r) for r in ref]), 0.0, 1.0)
    out = taug.random_resized_crop(t(img).permute(0, 3, 1, 2), t(boxes), out_size, method)
    np.testing.assert_allclose(n(out.permute(0, 2, 3, 1)), ref, atol=1e-5)


def test_resize_weights_zero_outside_input():
    """A box hanging off the image zeroes the samples outside it, like
    scale_and_translate."""
    w = taug.resize_weights(10, 8, torch.tensor([1.0]), torch.tensor([4.0]), "bilinear")
    assert w.shape == (1, 8, 10)
    np.testing.assert_array_equal(n(w[0, :3]), 0.0)
    np.testing.assert_allclose(n(w[0, 4:].sum(1)), 1.0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_multicrop_augment_with_jax_draws_matches_jax(dtype):
    B, H, W = 3, 48, 48
    cfg_j = xaug.MultiCropConfig(fused="off", **MC)
    cfg_t = taug.MultiCropConfig(**MC)
    rng = np.random.default_rng(4)
    if dtype == "uint8":
        x = rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8)
    else:
        x = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    gj, lj = xaug.multicrop_augment(key, jnp.asarray(x), cfg_j)
    xt = torch.from_numpy(x.copy())
    gt, lt = taug.multicrop_augment(xt, _jax_draws(key, B, H, W, cfg_j), cfg_t)
    assert gt.shape == gj.shape and gt.dtype == torch.float32
    np.testing.assert_allclose(n(gt), np.asarray(gj), atol=2e-4)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), np.asarray(b), atol=2e-4)


def test_draw_multicrop_shapes_and_boxes():
    cfg = taug.MultiCropConfig(**MC)
    gen = torch.Generator().manual_seed(0)
    B, H, W = 256, 40, 60
    draws = taug.draw_multicrop(gen, B, H, W, cfg)
    assert len(draws) == 2 + len(cfg.local_sizes)
    for i, d in enumerate(draws):
        assert d.boxes.shape == (B, 4) and d.params.shape == (B, 24)
        w, h, x0, y0 = d.boxes.unbind(1)
        assert (w >= 1).all() and (w <= W).all() and (h >= 1).all() and (h <= H).all()
        assert (x0 >= 0).all() and (x0 + w <= W + 1e-3).all()
        assert (y0 >= 0).all() and (y0 + h <= H + 1e-3).all()
        lo, hi = cfg.global_scale if i < 2 else cfg.local_scale
        frac = (w * h / (H * W))
        assert frac.max().item() <= hi + 1e-4
    # global crop 1 always blurs; global crop 2 may solarize; locals never do
    assert (draws[0].params[:, 7] == 1).all()
    assert draws[1].params[:, 8].sum() > 0
    assert all((d.params[:, 8] == 0).all() for d in draws[2:])


def test_multicrop_augment_draws_from_port_generator():
    cfg = taug.MultiCropConfig(**MC)
    x = torch.rand(2, 40, 40, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        g, l = taug.multicrop_augment(x, taug.draw_multicrop(gen, 2, 40, 40, cfg), cfg)
        assert g.shape == (2, 2, 32, 32, 3) and [a.shape[1] for a in l] == [24, 16]
        assert torch.isfinite(g).all()
        outs.append(g)
    assert torch.equal(outs[0], outs[1])  # same seed, same crops
