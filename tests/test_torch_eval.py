"""Port feature evaluation (dinomc_tpu_torch/eval/{knn,linear_probe,
retrieval,metrics}.py) against the JAX package.

The same numpy inputs from a seed go through both; tolerances are stated
per test. k-NN runs on continuous random features, where ties between
neighbours have measure zero, so the predicted labels must be equal. The
probe starts from the JAX package's own initial ``w`` (``init=``), f32: on
separable data the top-1 must be equal, loss and weights within 1e-5
relative (the order of float32 reductions is all that differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.eval import knn as jknn
from dinomc_tpu.eval import linear_probe as jlp
from dinomc_tpu.eval import metrics as jm
from dinomc_tpu.eval import retrieval as jret
from dinomc_tpu_torch.eval import knn as tknn
from dinomc_tpu_torch.eval import linear_probe as tlp
from dinomc_tpu_torch.eval import metrics as tm
from dinomc_tpu_torch.eval import retrieval as tret
from dinomc_tpu_torch.ops import augment as taug
from _torch_port import n, one_torch_thread, t  # noqa: F401

PROBE_RTOL = 1e-5


def _feats(seed, N=200, M=50, D=64, C=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32), rng.integers(0, C, N),
            rng.standard_normal((M, D)).astype(np.float32), rng.integers(0, C, M))


@pytest.mark.parametrize("k", [10, 20])
def test_knn_predict_and_accuracy_match_jax(k):
    trf, trl, tef, tel = _feats(k)
    ref = np.asarray(jknn.knn_predict(jnp.asarray(trf), jnp.asarray(trl), jnp.asarray(tef),
                                      k=k, num_classes=10))
    got = tknn.knn_predict(t(trf), torch.from_numpy(trl), t(tef), k=k, num_classes=10)
    np.testing.assert_array_equal(got.numpy(), ref)
    acc_ref = jknn.knn_accuracy(jnp.asarray(trf), jnp.asarray(trl), jnp.asarray(tef),
                                jnp.asarray(tel), ks=(k,), num_classes=10)
    assert tknn.knn_accuracy(trf, trl, tef, tel, ks=(k,), num_classes=10) == acc_ref


def test_extract_features_stacks_batches_without_autograd():
    w = torch.randn(3, 4, requires_grad=True)
    batches = [(np.ones((2, 3), np.float32) * i, np.array([i, i + 1])) for i in range(3)]
    f, y = tknn.extract_features(lambda x: torch.from_numpy(x) @ w, batches)
    assert f.shape == (6, 4) and not f.requires_grad
    assert y.tolist() == [0, 1, 1, 2, 2, 3]


def test_topk_accuracy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((37, 10)).astype(np.float32)
    target = rng.integers(0, 10, 37)
    ref = jm.topk_accuracy(jnp.asarray(logits), jnp.asarray(target), (1, 5))
    got = tm.topk_accuracy(t(logits), torch.from_numpy(target), (1, 5))
    for k in (1, 5):
        assert float(got[k]) == float(ref[k])


def test_average_precision_and_micro_map_match_jax():
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((16, 19)).astype(np.float32)
    labels = (rng.uniform(size=(16, 19)) < 0.2).astype(np.float32)
    assert tm.micro_map(scores, labels) == jm.micro_map(scores, labels)
    for c in range(3):
        assert tm.average_precision(scores[:, c], labels[:, c]) == \
            jm.average_precision(scores[:, c], labels[:, c])
    assert tm.average_precision(scores[:, 0], np.zeros(16)) == 0.0


def test_confuse_matrix_meter_streams_like_jax():
    rng = np.random.default_rng(3)
    ours, ref = tm.ConfuseMatrixMeter(5), jm.ConfuseMatrixMeter(5)
    for i, size in enumerate((40, 25, 7)):
        pr, gt = rng.integers(0, 5, size), rng.integers(-1, 5, size)  # -1: ignored
        w = 1.0 + 0.5 * i
        np.testing.assert_allclose(ours.update_cm(pr, gt, w), ref.update_cm(pr, gt, w), rtol=1e-6)
    np.testing.assert_array_equal(ours.sum, ref.sum)
    assert ours.count == ref.count
    got, want = ours.get_scores(), ref.get_scores()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    ours.clear()
    assert ours.sum.sum() == 0 and ours.count == 0


def _separable(seed, N, D, C, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((C, D)) * spread
    y = rng.integers(0, C, N)
    return (centers[y] + rng.standard_normal((N, D))).astype(np.float32), y


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("wd,batch", [(0.0, 64), (1e-3, 1024)], ids=["minibatch", "fullbatch-wd"])
def test_linear_probe_matches_jax_from_its_init(wd, batch):
    x, y = _separable(4, 300, 16, 4)
    D, C, seed = 16, 4, 5
    w0 = np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(seed), (D, C), jnp.float32))
    kw = dict(epochs=20, batch_size=batch, weight_decay=wd, seed=seed, return_params=True)
    ref = jlp.train_linear_probe(x[:200], y[:200], x[200:], y[200:], C, **kw)
    got = tlp.train_linear_probe(x[:200], y[:200], x[200:], y[200:], C, init=t(w0), **kw)
    assert got["top1"] == ref["top1"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=PROBE_RTOL)
    for ours, theirs in zip(got["params"], ref["params"]):
        assert _rel(n(ours), theirs) <= PROBE_RTOL


def test_probe_init_is_a_scaled_normal_draw():
    w = tlp.probe_init(torch.Generator().manual_seed(0), 384, 10)
    assert w.shape == (384, 10) and 0.009 < float(w.std()) < 0.011


def test_dense_linear_probe_matches_jax_from_its_init():
    x, y = _separable(6, 600, 8, 3, spread=1.0)
    x = x * np.linspace(0.01, 100.0, 8, dtype=np.float32)  # scales the standardization fixes
    w0 = np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(0), (8, 3), jnp.float32))
    kw = dict(epochs=5, batch_size=128)
    ref = jlp.dense_linear_probe(x[:400], y[:400], x[400:], y[400:], 3, **kw)
    got = tlp.dense_linear_probe(x[:400], y[:400], x[400:], y[400:], 3, init=t(w0), **kw)
    assert got["top1"] == ref["top1"] and got["miou"] == ref["miou"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=PROBE_RTOL)


@pytest.mark.parametrize("hw,size", [((64, 96), (45, 68)), ((40, 40), (56, 56))],
                         ids=["down-antialiased", "up"])
def test_resize_is_jax_image_resize(hw, size):
    """The bilinear resize of ``multi_scale`` and the learning check, at a
    1/sqrt(2) downsample (antialiased) and an upsample; atol 1e-5."""
    img = np.random.default_rng(7).uniform(size=(2, *hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), (2, *size, 3), "bilinear")
    np.testing.assert_allclose(n(taug.resize(t(img), size, "bilinear")), np.asarray(ref),
                               atol=1e-5)


def test_multi_scale_matches_jax():
    """Scales 1 and 1/sqrt(2) (64 -> 45 px, rounded to 32: the antialiased
    downsample) and 1/2, through a forward that reads every pixel of an 8 x
    8 corner and the mean colour; atol 1e-5 on the unit-norm result."""
    img = np.random.default_rng(8).uniform(size=(3, 64, 96, 3)).astype(np.float32)
    proj = np.random.default_rng(9).standard_normal((195, 16)).astype(np.float32)

    def fwd_j(x):
        feats = jnp.concatenate([x[:, :8, :8].reshape(x.shape[0], -1), x.mean(axis=(1, 2))], 1)
        return feats @ jnp.asarray(proj)

    def fwd_t(x):
        feats = torch.cat([x[:, :8, :8].reshape(x.shape[0], -1), x.mean(dim=(1, 2))], 1)
        return feats @ t(proj)

    ref = jret.multi_scale(jnp.asarray(img), fwd_j)
    np.testing.assert_allclose(n(tret.multi_scale(t(img), fwd_t)), np.asarray(ref), atol=1e-5)
