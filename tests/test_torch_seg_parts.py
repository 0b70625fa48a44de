"""Port segmentation parts against the JAX package, one function each:
``models/layers`` (resize, pooling, BatchNorm), ``objectives/segmentation``,
``eval/metrics`` and the train transform of ``data/seg_datasets`` with the
JAX package's own draws injected.

Tolerances: f32 on both sides. Resizes, pooling and BatchNorm are a few
f32 sums per output: 1e-5. Losses are means over a few thousand f32 terms:
1e-6 (values) and 1e-7 (gradients, which are each ~1/n). The train
transform's hue stage uses the port's branch-free HSV round trip, which
matches JAX's sector-select form to ~1e-5 before the normalize divides by a
std of ~0.22: 2e-4 on the images; masks are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.data import seg_datasets as jsd
from dinomc_tpu.eval import metrics as jmetrics
from dinomc_tpu.models import layers as jlayers
from dinomc_tpu.objectives import segmentation as jseg
from dinomc_tpu_torch.data import seg_datasets as tsd
from dinomc_tpu_torch.eval import metrics as tmetrics
from dinomc_tpu_torch.models import layers as tlayers
from dinomc_tpu_torch.objectives import segmentation as tseg
from dinomc_tpu_torch.ops import augment as taug
from dinomc_tpu_torch.ops import spatial as tspatial
from _torch_port import n, one_torch_thread, t, write_seg_folder  # noqa: F401


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return n(x.permute(0, 2, 3, 1))


@pytest.mark.parametrize("hw_in,hw_out", [
    ((33, 33), (16, 16)),  # shrink, odd: 132 px at patch 4 -> Hf/2
    ((33, 33), (8, 8)),    # shrink by 4 -> Hf/4
    ((33, 33), (66, 66)),  # grow: pyramid level 0
    ((7, 9), (15, 4)),     # grow one axis, shrink the other
    ((1, 1), (6, 6)),      # PSP's pooled map back to the level size
    ((5, 6), (5, 12)),     # one axis unchanged
])
def test_resize_bilinear_matches_jax(hw_in, hw_out):
    x = np.random.default_rng(0).standard_normal((2,) + hw_in + (5,)).astype(np.float32)
    ref = np.asarray(jlayers.resize_bilinear(jnp.asarray(x), hw_out))
    out = _nhwc(tlayers.resize_bilinear(_nchw(x), hw_out))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("size,out", [(11, 1), (11, 2), (11, 3), (11, 6), (4, 6), (1, 6)])
def test_adaptive_avg_pool_matches_jax(size, out):
    x = np.random.default_rng(size).standard_normal((2, size, size, 4)).astype(np.float32)
    ref = np.asarray(jlayers.adaptive_avg_pool(jnp.asarray(x), out))
    np.testing.assert_allclose(_nhwc(tlayers.adaptive_avg_pool(_nchw(x), out)), ref, atol=1e-6)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_apply_and_running_stats_match_jax(train):
    rng = np.random.default_rng(1)
    C = 6
    x = (rng.standard_normal((4, 7, 8, C)) * 3 + 2).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": rng.standard_normal(C).astype(np.float32)}
    s = {"mean": rng.standard_normal(C).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    y_ref, s_ref = jlayers.bn_apply(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                                    jnp.asarray(x), train)
    bn = tlayers.BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(t(p["scale"]))
        bn.bias.copy_(t(p["bias"]))
        bn.running_mean.copy_(t(s["mean"]))
        bn.running_var.copy_(t(s["var"]))
    y = tlayers.bn_apply(bn, _nchw(x), train)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(n(bn.running_mean), np.asarray(s_ref["mean"]), atol=1e-6)
    np.testing.assert_allclose(n(bn.running_var), np.asarray(s_ref["var"]), atol=1e-5)
    assert int(bn.num_batches_tracked) == int(train)


@pytest.mark.parametrize("ignore_index", [None, 0, 3])
def test_dice_ce_loss_and_grads_match_jax(ignore_index):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 12, 10, 5)) * 2).astype(np.float32)
    target = rng.integers(0, 5, (2, 12, 10)).astype(np.int32)
    ref, gref = jax.value_and_grad(jseg.dice_ce_loss)(jnp.asarray(logits), jnp.asarray(target),
                                                      ignore_index)
    lt = t(logits).requires_grad_()
    loss = tseg.dice_ce_loss(lt, t(target, torch.long), ignore_index)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), atol=1e-6)
    np.testing.assert_allclose(n(lt.grad), np.asarray(gref), atol=1e-7)
    ce_ref = jseg.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(target), ignore_index)
    ce = tseg.cross_entropy_loss(t(logits), t(target, torch.long), ignore_index)
    np.testing.assert_allclose(float(ce), float(ce_ref), atol=1e-6)


def test_confusion_matrix_cm2score_and_seg_stats_match_jax():
    rng = np.random.default_rng(3)
    C = 5
    preds = [rng.integers(0, C, (2, 9, 9)) for _ in range(3)]
    targets = [rng.integers(0, C + 1, (2, 9, 9)) for _ in range(3)]  # C: outside, ignored
    targets[0][0, 0, :3] = -1
    js, ts = jmetrics.seg_stats_init(C), tmetrics.seg_stats_init(C)
    for p, g in zip(preds, targets):
        cm_ref = np.asarray(jmetrics.confusion_matrix(jnp.asarray(p), jnp.asarray(g), C))
        cm = tmetrics.confusion_matrix(torch.from_numpy(p), torch.from_numpy(g), C)
        np.testing.assert_array_equal(cm.numpy(), cm_ref)
        sc_ref = jmetrics.cm2score(jnp.asarray(cm_ref.astype(np.int32)))
        sc = tmetrics.cm2score(cm.int())
        for k in sc_ref:
            np.testing.assert_allclose(n(sc[k]), np.asarray(sc_ref[k]), atol=1e-6, err_msg=k)
        js = jmetrics.seg_stats_update(js, jnp.asarray(p), jnp.asarray(g))
        ts = tmetrics.seg_stats_update(ts, torch.from_numpy(p), torch.from_numpy(g))
    fin_ref, fin = jmetrics.seg_stats_finalize(js), tmetrics.seg_stats_finalize(ts)
    for k in fin_ref:
        np.testing.assert_allclose(np.asarray(fin[k], np.float64),
                                   np.asarray(fin_ref[k], np.float64), atol=1e-6, err_msg=k)
    names = jsd.UAVID.classes[:C]
    assert (tmetrics.format_class_metrics_table(names, fin)
            == jmetrics.format_class_metrics_table(names, fin_ref))


def test_specs_equal_the_jax_constants():
    assert set(tsd.SPECS) == set(jsd.SPECS)
    for name, spec in jsd.SPECS.items():
        assert dataclasses.asdict(tsd.SPECS[name]) == dataclasses.asdict(spec), name
    mask = np.random.default_rng(4).integers(0, 8, (6, 5))
    rgb = np.asarray(jsd.UAVID.palette, np.uint8)[mask]
    rgb[0, 0] = (1, 2, 3)  # unknown color -> class 0
    np.testing.assert_array_equal(tsd.rgb_to_class(rgb, tsd.UAVID),
                                  jsd.rgb_to_class(rgb, jsd.UAVID))


def test_sample_index_loads_what_jax_loads(tmp_path):
    write_seg_folder(tmp_path, 3, 20, jsd.UAVID, seed=6)
    (tmp_path / "images" / "orphan.png").write_bytes(b"")  # no mask: not listed
    dirs = (str(tmp_path / "images"), str(tmp_path / "masks"))
    ref = jsd.SegSampleIndex(*dirs, jsd.UAVID, image_size=16)
    ours = tsd.SegSampleIndex(*dirs, tsd.UAVID, image_size=16)
    assert ours.stems == ref.stems == ["tile_0", "tile_1", "tile_2"]
    for (a, am), (b, bm) in zip(ours.batches(2, shuffle=True, seed=1),
                                ref.batches(2, shuffle=True, seed=1)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(am, bm)
        assert a.shape == (2, 16, 16, 3) and am.dtype == np.int32


def _jax_draws(rng, B, spec):
    """The draws of ``seg_datasets.augment_batch`` (seg_datasets.py:277-283,
    spatial.py:42-61,147-150, augment.py:165-170, 186), as the port's."""
    k1, k2, k3 = jax.random.split(rng, 3)
    kh, kv = jax.random.split(k1)
    flip_h = jax.random.bernoulli(kh, spec.hflip_p, (B, 1, 1)).reshape(B)
    flip_v = jax.random.bernoulli(kv, spec.vflip_p, (B, 1, 1)).reshape(B)
    affine = None
    if spec.affine is not None:
        a = spec.affine
        kc, ka, kr, ktx, kty, ks, ksh = jax.random.split(k2, 7)
        w = jnp.asarray(a.weights)

        def u(k, lo, hi):
            return jax.random.uniform(k, (B,), minval=lo, maxval=hi)

        affine = tspatial.AffineDraw(*(t(np.asarray(x), None) for x in (
            jax.random.categorical(kc, jnp.log(w / w.sum()), shape=(B,)),
            jax.random.bernoulli(ka, a.p, (B,)),
            u(kr, -a.rotate_deg, a.rotate_deg) * (jnp.pi / 180.0),
            u(ktx, -a.translate_frac, a.translate_frac),
            u(kty, -a.translate_frac, a.translate_frac),
            u(ks, *a.scale_range),
            u(ksh, -a.shear_deg, a.shear_deg) * (jnp.pi / 180.0),
        )))
    b, c, s, h = spec.jitter
    # the fifth key draws bernoulli(p=1.0): the transform jitters every sample
    kb, kc, ks, kh, _ = jax.random.split(k3, 5)

    def u(k, lo, hi):
        return t(np.asarray(jax.random.uniform(k, (B,), minval=lo, maxval=hi)))

    jitter = taug.JitterDraw(
        fb=u(kb, 1 - b, 1 + b), fc=u(kc, 1 - c, 1 + c), fs=u(ks, 1 - s, 1 + s),
        fh=u(kh, -h, h),
    )
    return tsd.SegAugDraw(t(np.asarray(flip_h), None), t(np.asarray(flip_v), None),
                          affine, jitter)


@pytest.mark.parametrize("name", ["uavid", "udd6", "potsdam"])
def test_augment_batch_matches_jax_with_its_draws(name):
    spec = jsd.SPECS[name]
    B, S = 6, 24
    rng_np = np.random.default_rng(5)
    images = rng_np.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    masks = rng_np.integers(0, spec.num_classes, (B, S, S)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    ref_img, ref_mask = jsd.augment_batch(key, jnp.asarray(images), jnp.asarray(masks), spec)
    draws = _jax_draws(key, B, spec)
    if draws.affine is not None:  # the port's matrices from the same draws
        from dinomc_tpu.ops import spatial as jspatial

        _, k2, _ = jax.random.split(key, 3)
        np.testing.assert_allclose(n(tspatial.affine_matrices(draws.affine)),
                                   np.asarray(jspatial._affine_matrices(k2, B, spec.affine)),
                                   atol=1e-6)
    img, mask = tsd.augment_batch(t(images), t(masks, torch.long), tsd.SPECS[name], draws)
    np.testing.assert_allclose(n(img), np.asarray(ref_img), atol=2e-4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    ev_img, ev_mask = jsd.augment_batch(key, jnp.asarray(images), jnp.asarray(masks), spec,
                                        train=False)
    img, mask = tsd.augment_batch(t(images), t(masks, torch.long), tsd.SPECS[name])
    np.testing.assert_allclose(n(img), np.asarray(ev_img), atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ev_mask))
