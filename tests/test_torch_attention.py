"""Port attention (dinomc_tpu_torch/ops/hopper/attention.py and
ops/attention.py) against the JAX package.

K1/K2's plain version ``fused_mha_reference`` is held against the JAX
``fused_mha`` Pallas kernel, run in TPU interpret mode as
tests/test_pallas_attention.py runs it, and against JAX ``dense_attention``;
forward atol 2e-5 and gradient atol 5e-4 are that file's bounds. The CUDA
kernels themselves are held against the plain version on the card
(``cuda`` marker).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dinomc_tpu.ops import attention as jatt
from dinomc_tpu.ops.pallas import attention as jpatt
from dinomc_tpu_torch.ops import attention as tatt
from dinomc_tpu_torch.ops.hopper import attention as hatt
from _torch_port import cuda_device, n, one_torch_thread, t  # noqa: F401

CASES = [  # (N, boundary, scale)
    pytest.param(64, 0, None, id="plain"),
    pytest.param(50, 0, 0.2, id="padded-N50"),
    pytest.param(90, 57, None, id="boundary-57-of-90"),
    pytest.param(70, 33, None, id="boundary-33-of-70"),
]


def _qkv(N, seed, B=2, h=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, h, d)).astype(np.float32) for _ in range(3)]


def _scale(scale, d=32):
    return 1.0 / math.sqrt(d) if scale is None else scale


@pytest.mark.parametrize("N,boundary,scale", CASES)
def test_forward_matches_jax_fused_and_dense(N, boundary, scale):
    q, k, v = _qkv(N, seed=N)
    s = _scale(scale)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpatt.fused_mha(*map(jnp.asarray, (q, k, v)), s, boundary))
    dense = np.asarray(jatt.dense_attention(*map(jnp.asarray, (q, k, v)), s, boundary))
    out = n(hatt.fused_mha(t(q), t(k), t(v), s, boundary))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, dense, atol=2e-5)


@pytest.mark.parametrize("N,boundary,scale", CASES)
def test_grads_match_jax_fused(N, boundary, scale):
    q, k, v = _qkv(N, seed=N + 1)
    s = _scale(scale)

    def loss(q, k, v):
        return jnp.sum(jpatt.fused_mha(q, k, v, s, boundary) ** 2)

    with pltpu.force_tpu_interpret_mode():
        gj = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    (hatt.fused_mha(qt, kt, vt, s, boundary) ** 2).sum().backward()
    for a, b in zip((qt.grad, kt.grad, vt.grad), gj):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=5e-4)


def test_dense_attention_matches_jax_with_boundary():
    q, k, v = _qkv(64, seed=6)
    ref = np.asarray(jatt.dense_attention(*map(jnp.asarray, (q, k, v)), 0.17, 40))
    out = n(tatt.dense_attention(t(q), t(k), t(v), 0.17, 40))
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_mha_on_cpu_runs_the_plain_version():
    q, k, v = (t(x) for x in _qkv(40, seed=3))
    out = tatt.mha(q, k, v, boundary=17)
    ref = hatt.fused_mha_reference(q, k, v, 1.0 / math.sqrt(32), 17)
    assert torch.equal(out, ref)
    dense = tatt.dense_attention(q, k, v, 1.0 / math.sqrt(32), 17)
    np.testing.assert_allclose(n(dense), n(ref), atol=1e-6)


def test_mha_refuses_unported_impls():
    """Past MAX_FUSED_LEN padded tokens ``mha`` takes the long-sequence
    route (K4-K6), which has no crop packing: a ``boundary`` there raises,
    as the JAX package's ``fused_long`` route does."""
    rng = np.random.default_rng(0)
    q = t(rng.standard_normal((1, hatt.MAX_FUSED_LEN + 1, 1, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="boundary"):
        tatt.mha(q, q, q, boundary=100)
    out = tatt.mha(q, q, q)
    assert out.shape == q.shape and torch.isfinite(out).all()
    tatt.mha(q[:, : hatt.MAX_FUSED_LEN], q[:, : hatt.MAX_FUSED_LEN], q[:, : hatt.MAX_FUSED_LEN])


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches its kernel or raises: it never falls back."""
    q, k, v = (t(x).bfloat16() for x in _qkv(16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        hatt.attention_fwd(q, k, v, 0.1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        hatt.FusedMHA.apply(q, k, v, 0.1, 0)


def test_packing_bound_matches_jax():
    assert hatt.MAX_FUSED_LEN == jpatt.MAX_FUSED_LEN
    for N in (1, 101, 128, 495, 631, 785):
        assert hatt._pad_len(N) == jpatt._pad_len(N)


def test_rows_sum_to_one():
    q, k, _ = (t(x) for x in _qkv(33, seed=5))
    out = hatt.fused_mha_reference(q, k, torch.ones_like(q), 0.1, 20)
    np.testing.assert_allclose(n(out), 1.0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("N,boundary,d", [(785, 0, 64), (631, 530, 64), (70, 33, 32), (50, 0, 16)])
def test_kernels_match_plain_on_card(cuda_device, N, boundary, d):
    """K1/K2 against the plain version in bf16 (bounds as chip_smoke.py)."""
    gen = torch.Generator(device=cuda_device).manual_seed(N)
    qkv = torch.randn(2, N, 3, 4, d, generator=gen, device=cuda_device).bfloat16()
    do = torch.randn(2, N, 4, d, generator=gen, device=cuda_device).bfloat16()
    s = 1.0 / math.sqrt(d)
    outs, grads = [], []
    for fn in (hatt.fused_mha, hatt.fused_mha_reference):
        x = qkv.clone().requires_grad_()
        o = fn(*x.unbind(2), s, boundary)
        outs.append(o.float())
        grads.append(torch.autograd.grad(o, x, do)[0].float())
    torch.cuda.synchronize()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-2
    assert ((grads[0] - grads[1]).abs().max() / grads[1].abs().max()).item() <= 2e-2
