"""Port ViT (dinomc_tpu_torch/models/vit.py) against the JAX package.

Weights are initialized by the JAX package, carried across with
``ckpt/from_jax.load_jax_params`` (strict state-dict load), and both
forwards run in f32 on the same numpy inputs. DropPath masks are the JAX
package's own draws (the same one-call bernoulli as ``_scan_blocks``),
injected into the port. Attention goes through K1's plain version on the
port side and dense attention on the JAX side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt.torch_export import vit_state_dict
from dinomc_tpu.models import vit as jvit
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.models import vit as tvit
from _torch_port import n, one_torch_thread, t  # noqa: F401

ATOL = 2e-5


def _pair(gelu_approx=False, drop_path_rate=0.0, img_size=16, patch=4):
    """(JAX cfg, JAX params, port ViT with the same weights), f32."""
    jcfg = jvit.vit_test(
        patch_size=patch, img_size=img_size, compute_dtype=jnp.float32,
        gelu_approx=gelu_approx, drop_path_rate=drop_path_rate,
    )
    params = jvit.init_vit(jax.random.PRNGKey(0), jcfg)
    tcfg = tvit.vit_test(
        patch_size=patch, img_size=img_size, compute_dtype=torch.float32,
        gelu_approx=gelu_approx, drop_path_rate=drop_path_rate,
    )
    model = tvit.VisionTransformer(tcfg)
    load_jax_params(model, jax.device_get(params))
    return jcfg, params, model


def _images(B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, S, 3)).astype(np.float32)


def _jax_masks(jcfg, rng, B, packed):
    """The bernoulli draw of ``_scan_blocks`` (vit.py:515-529)."""
    L = jcfg.depth
    keep = 1.0 - jnp.linspace(0.0, jcfg.drop_path_rate, L)
    shape = (L, 2, B) + ((2,) if packed else ())
    keep_p = keep.reshape((L, 1, 1) + ((1,) if packed else ()))
    return np.array(jax.random.bernoulli(rng, keep_p, shape))


def test_state_dict_layout_matches_export():
    _, params, model = _pair()
    ours = model.state_dict()
    ref = vit_state_dict(jax.device_get(params))
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(n(ours[k]), ref[k])


@pytest.mark.parametrize("S", [16, 24, 12, 18], ids=lambda s: f"img{s}")
@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
def test_forward_matches_jax(S, gelu_approx):
    """Deterministic forward at the native grid and at interpolated
    (including non-divisible, truncated) crop sizes."""
    jcfg, params, model = _pair(gelu_approx=gelu_approx)
    x = _images(3, S, seed=S)
    ref = np.asarray(jvit.vit_forward(params, jnp.asarray(x), jcfg))
    out = n(tvit.vit_forward(model, t(x)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_forward_with_drop_path_matches_jax():
    jcfg, params, model = _pair(drop_path_rate=0.3)
    x = _images(6, 16, seed=1)
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jvit.vit_forward(params, jnp.asarray(x), jcfg, rng, deterministic=False))
    masks = _jax_masks(jcfg, rng, 6, packed=False)
    assert not masks.all(), "want some dropped samples"
    out = n(tvit.vit_forward(model, t(x), deterministic=False, dp_masks=torch.from_numpy(masks)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_packed_forward_with_drop_path_matches_jax():
    jcfg, params, model = _pair(drop_path_rate=0.3)
    xa, xb = _images(4, 24, seed=2), _images(4, 12, seed=3)
    rng = jax.random.PRNGKey(6)
    ra, rb = jvit.vit_forward_packed(
        params, jnp.asarray(xa), jnp.asarray(xb), jcfg, rng, deterministic=False
    )
    masks = torch.from_numpy(_jax_masks(jcfg, rng, 4, packed=True))
    oa, ob = tvit.vit_forward_packed(model, t(xa), t(xb), deterministic=False, dp_masks=masks)
    np.testing.assert_allclose(n(oa), np.asarray(ra), atol=ATOL)
    np.testing.assert_allclose(n(ob), np.asarray(rb), atol=ATOL)


def test_packed_equals_two_forwards():
    _, _, model = _pair()
    xa, xb = t(_images(2, 20, seed=4)), t(_images(2, 12, seed=5))
    oa, ob = tvit.vit_forward_packed(model, xa, xb)
    np.testing.assert_allclose(n(oa), n(tvit.vit_forward(model, xa)), atol=1e-5)
    np.testing.assert_allclose(n(ob), n(tvit.vit_forward(model, xb)), atol=1e-5)


@pytest.mark.parametrize("grid", [(4, 4), (6, 6), (3, 3), (5, 7)])
def test_interpolate_pos_embed_matches_jax(grid):
    pos = np.random.default_rng(0).standard_normal((1, 17, 32)).astype(np.float32)
    ref = np.asarray(jvit.interpolate_pos_embed(jnp.asarray(pos), grid))
    out = n(tvit.interpolate_pos_embed(t(pos), grid))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_patchify_matches_jax():
    x = _images(2, 13, seed=7)
    np.testing.assert_array_equal(
        n(tvit.patchify(t(x), 4)), np.asarray(jvit.patchify(jnp.asarray(x), 4))
    )


def test_drop_path_masks_one_draw_shapes():
    cfg = dataclasses.replace(tvit.vit_test(), drop_path_rate=0.5)
    gen = torch.Generator().manual_seed(0)
    m = tvit.drop_path_masks(cfg, 5, False, gen, "cpu")
    mp = tvit.drop_path_masks(cfg, 5, True, gen, "cpu")
    assert m.shape == (3, 2, 5) and mp.shape == (3, 2, 5, 2)
    assert m.dtype == torch.bool
    assert m[0].all()  # layer 0 has drop rate 0


def test_bf16_forward_is_close_to_f32():
    """The training dtype: weights cast at use, f32 LayerNorm statistics."""
    _, _, model = _pair()
    x = t(_images(2, 16, seed=8))
    f32 = tvit.vit_forward(model, x)
    model.cfg = dataclasses.replace(model.cfg, compute_dtype=torch.bfloat16)
    bf16 = tvit.vit_forward(model, x)
    assert bf16.dtype == torch.float32
    np.testing.assert_allclose(n(bf16), n(f32), atol=0.1)
