"""Port long-sequence attention (dinomc_tpu_torch/ops/hopper/attention_long.py
and its route in ops/attention.py) against the JAX package.

K4-K6's plain version ``long_mha_reference`` is held against the JAX
``long_mha`` Pallas kernels, run in TPU interpret mode as
tests/test_pallas_attention_long.py runs them, in f32: forward atol 2e-5
and gradients of sum(out^2) atol 5e-4, that file's bounds. The CUDA kernels
themselves are held against the plain version on the card (``cuda``
marker), in bf16 with chip_smoke.py's bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dinomc_tpu.ops import attention as jatt
from dinomc_tpu.ops.pallas import attention_long as jlong
from dinomc_tpu_torch.ops import attention as tatt
from dinomc_tpu_torch.ops.hopper import attention_long as hlong
from _torch_port import cuda_device, n, one_torch_thread, t  # noqa: F401

CASES = [  # (N, scale): ragged over two 128-row chunks, and an exact multiple
    pytest.param(150, None, id="ragged-N150"),
    pytest.param(256, 0.17, id="exact-N256"),
]


def _qkv(N, seed, B=1, h=2, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, h, d)).astype(np.float32) for _ in range(3)]


def _scale(scale, d=32):
    return 1.0 / math.sqrt(d) if scale is None else scale


@pytest.mark.parametrize("N,scale", CASES)
def test_forward_matches_jax_long(N, scale):
    q, k, v = _qkv(N, seed=N)
    s = _scale(scale)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jlong.long_mha(*map(jnp.asarray, (q, k, v)), s))
    out = n(hlong.long_mha(t(q), t(k), t(v), s))
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("N,scale", CASES)
def test_grads_match_jax_long(N, scale):
    q, k, v = _qkv(N, seed=N + 1)
    s = _scale(scale)

    def loss(q, k, v):
        return jnp.sum(jlong.long_mha(q, k, v, s) ** 2)

    with pltpu.force_tpu_interpret_mode():
        gj = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    (hlong.long_mha(qt, kt, vt, s) ** 2).sum().backward()
    for a, b in zip((qt.grad, kt.grad, vt.grad), gj):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=5e-4)


def test_mha_sends_long_sequences_to_long_mha(monkeypatch):
    """Padded N = 1152 > 1024: ``mha`` routes to ``long_mha`` (no cap) and
    agrees with the JAX package's dense attention, which is what its
    ``mha`` runs on a CPU."""
    q, k, v = _qkv(1100, seed=3, h=1, d=16)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return hlong.long_mha(*args)

    monkeypatch.setattr(tatt, "long_mha", spy)
    out = n(tatt.mha(t(q), t(k), t(v)))
    assert calls == [(1, 1100, 1, 16)]
    ref = np.asarray(jatt.mha(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    tatt.mha(*(t(x)[:, :1000] for x in (q, k, v)))
    assert len(calls) == 1  # padded 1024 stays on the fused route


def test_boundary_on_a_long_sequence_raises():
    q = t(_qkv(1030, seed=4, h=1, d=16)[0])
    with pytest.raises(ValueError, match="boundary"):
        tatt.mha(q, q, q, boundary=500)
    with pytest.raises(ValueError):
        jatt.mha(*(jnp.asarray(n(q)),) * 3, impl="fused_long", boundary=500)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches its kernel or raises: it never falls back."""
    q, k, v = (t(x).bfloat16() for x in _qkv(16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        hlong.long_attention_fwd(q, k, v, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        hlong.LongMHA.apply(q, k, v, 0.1)


def test_rows_sum_to_one():
    q, k, _ = (t(x) for x in _qkv(140, seed=5))
    out = hlong.long_mha_reference(q, k, torch.ones_like(q), 0.1)
    np.testing.assert_allclose(n(out), 1.0, atol=1e-6)


def _split(qkv, layout):
    """q, k, v: the strided views of qkv, or a contiguous copy of each."""
    q, k, v = qkv.unbind(2)
    return (q, k, v) if layout == "strided" else (q.contiguous(), k.contiguous(), v.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("B,N,h,d", [(2, 4097, 6, 64), (1, 1100, 2, 32), (1, 1030, 4, 16)])
def test_kernels_match_plain_on_card(cuda_device, B, N, h, d, layout):
    """K4-K6 against the plain version in bf16 (bounds as chip_smoke.py); K5
    and K6 read K4's log-sum-exp."""
    gen = torch.Generator(device=cuda_device).manual_seed(N)
    qkv = torch.randn(B, N, 3, h, d, generator=gen, device=cuda_device).bfloat16()
    do = torch.randn(B, N, h, d, generator=gen, device=cuda_device).bfloat16()
    s = 1.0 / math.sqrt(d)
    outs, grads = [], []
    for fn in (hlong.long_mha, hlong.long_mha_reference):
        x = qkv.clone().requires_grad_()
        o = fn(*_split(x, layout), s)
        outs.append(o.float())
        grads.append(torch.autograd.grad(o, x, do)[0].float())
    torch.cuda.synchronize()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-2
    assert ((grads[0] - grads[1]).abs().max() / grads[1].abs().max()).item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 1025, 4097])
def test_forward_kernel_at_tile_edges(cuda_device, N, d, layout):
    """K4 at lengths on and beside its 64-row TMA boxes and 128-key tiles,
    at each head dim (each its own swizzle): the output within 1e-2 of the
    plain version, and the saved log-sum-exp that of the plain f32 scores
    within 1e-4 (f32 sums in another order; it is about ln N)."""
    gen = torch.Generator(device=cuda_device).manual_seed(N + d)
    qkv = torch.randn(2, N, 3, 3, d, generator=gen, device=cuda_device).bfloat16()
    q, k, v = _split(qkv, layout)
    s = 1.0 / math.sqrt(d)
    o, lse = hlong.long_attention_fwd(q, k, v, s)
    ref = hlong.long_mha_reference(q, k, v, s)
    ref_lse = torch.logsumexp(torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * s, dim=-1)
    torch.cuda.synchronize()
    assert o.shape == q.shape and lse.shape == (2, 3, N)
    assert (o.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _long_grads(device, N, d, B=2, h=3, layout="strided"):
    """K4's o and lse and K5's delta on the qkv views (or contiguous copies)
    as K6's arguments, the arguments of K5, and the plain version's (dq, dk,
    dv)."""
    gen = torch.Generator(device=device).manual_seed(10 * N + d)
    qkv = torch.randn(B, N, 3, h, d, generator=gen, device=device).bfloat16()
    do = torch.randn(B, N, h, d, generator=gen, device=device).bfloat16()
    q, k, v = _split(qkv, layout)
    s = 1.0 / math.sqrt(d)
    o, lse = hlong.long_attention_fwd(q, k, v, s)
    _, delta = hlong.long_attention_dq(q, k, v, o, lse, do, s)
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(hlong.long_mha_reference(*xs, s), xs, do)
    return (q, k, v, lse, delta, do, s), (q, k, v, o, lse, do, s), ref


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 1025, 4097])
def test_dq_kernel_at_tile_edges(cuda_device, N, d, layout):
    """K5 at lengths on and beside its 64-row query boxes and key tiles, at
    each head dim (each its own swizzle): dQ within 2e-2 of the plain
    version's, relative to its largest magnitude (chip_smoke.py's bound);
    1e-5 absolute beside it for N = 1, where dQ is exactly 0 (the one key's
    dS is 0). delta is rowsum(dO * O) of K4's bf16 output, the same f32
    products summed in another order: within 1e-4 relative of the largest."""
    _, args, (ref_dq, _, _) = _long_grads(cuda_device, N, d, layout=layout)
    q, k, v, o, lse, do, s = args
    dq, delta = hlong.long_attention_dq(*args)
    ref_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    torch.cuda.synchronize()
    assert dq.shape == ref_dq.shape and torch.isfinite(dq.float()).all()
    err = (dq.float() - ref_dq.float()).abs().max().item()
    assert err <= 2e-2 * ref_dq.float().abs().max().item() + 1e-5
    assert delta.shape == ref_delta.shape
    assert (delta - ref_delta).abs().max().item() <= 1e-4 * ref_delta.abs().max().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 1025, 4097])
def test_dkv_kernel_at_tile_edges(cuda_device, N, d):
    """K6 at lengths on and beside its 64-row query tiles and 64-key boxes,
    at each head dim (each its own swizzle): dK and dV within 2e-2 of the
    plain version's, relative to its largest magnitude (chip_smoke.py's
    bound); 1e-5 absolute beside it for N = 1, where dK is exactly 0 (the
    one key's dS is P (dP - delta) with P = 1 and dP = delta)."""
    args, _, (_, ref_dk, ref_dv) = _long_grads(cuda_device, N, d)
    dk, dv = hlong.long_attention_dkv(*args)
    torch.cuda.synchronize()
    for got, ref in ((dk, ref_dk), (dv, ref_dv)):
        assert got.shape == ref.shape and torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("N,d", [(4097, 64), (1100, 32), (1030, 16)])
def test_dkv_kernel_is_deterministic(cuda_device, N, d):
    """K5 and K6 have no atomics: two calls on the same inputs give the same
    bits (K5's dQ and delta, K6's dK and dV)."""
    args, dq_args, _ = _long_grads(cuda_device, N, d)
    for kernel, xs in ((hlong.long_attention_dkv, args), (hlong.long_attention_dq, dq_args)):
        first, again = kernel(*xs), kernel(*xs)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), kernel.__name__
