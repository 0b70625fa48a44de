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


def _card_qkv(device, N, d, B=2, h=4):
    """(qkv (B, N, 3, h, d) bf16, do) on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(N + d)
    qkv = torch.randn(B, N, 3, h, d, generator=gen, device=device).bfloat16()
    do = torch.randn(B, N, h, d, generator=gen, device=device).bfloat16()
    return qkv, do


def _split(qkv, layout):
    """q, k, v: the strided views of qkv, or a contiguous copy of each."""
    q, k, v = qkv.unbind(2)
    return (q, k, v) if layout == "strided" else (q.contiguous(), k.contiguous(), v.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("N,boundary,d", [
    (785, 0, 64), (631, 530, 64), (70, 33, 32), (50, 0, 16),
    (256, 128, 64), (256, 128, 16),  # the crop boundary on a tile edge
])
def test_kernels_match_plain_on_card(cuda_device, N, boundary, d, layout):
    """K1/K2 against the plain version in bf16 (bounds as chip_smoke.py)."""
    qkv, do = _card_qkv(cuda_device, N, d)
    s = 1.0 / math.sqrt(d)
    outs, grads = [], []
    for fn in (hatt.fused_mha, hatt.fused_mha_reference):
        x = qkv.clone().requires_grad_()
        o = fn(*_split(x, layout), s, boundary)
        outs.append(o.float())
        grads.append(torch.autograd.grad(o, x, do)[0].float())
    torch.cuda.synchronize()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-2
    assert ((grads[0] - grads[1]).abs().max() / grads[1].abs().max()).item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N,boundary,d", [(785, 0, 64), (631, 530, 64), (256, 128, 32),
                                          (50, 0, 16)])
def test_backward_kernel_is_deterministic(cuda_device, N, boundary, d):
    """K2 has no atomics: two calls on the same inputs give the same bits."""
    qkv, do = _card_qkv(cuda_device, N, d)
    q, k, v = _split(qkv, "strided")
    s = 1.0 / math.sqrt(d)
    o, lse = hatt.attention_fwd(q, k, v, s, boundary)
    first = hatt.attention_bwd(q, k, v, o, lse, do, s, boundary)
    again = hatt.attention_bwd(q, k, v, o, lse, do, s, boundary)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# chip_smoke.py's ATTN_SHAPES: (B, N, h, d, boundary)
FWD_SHAPES = [
    pytest.param(16, 785, 6, 64, 0, id="global-224px"),
    pytest.param(8, 631, 6, 64, 530, id="packed-184+84px"),
    pytest.param(8, 627, 6, 64, 401, id="packed-164+124px"),
    pytest.param(8, 495, 6, 64, 325, id="packed-144+104px"),
    pytest.param(8, 101, 6, 64, 0, id="single-84px"),
    pytest.param(2, 70, 2, 32, 33, id="ragged-d32"),
    pytest.param(3, 50, 4, 16, 0, id="ragged-d16"),
    pytest.param(32, 785, 6, 64, 0, id="eurosat-finetune"),
    pytest.param(64, 785, 6, 64, 0, id="eurosat-feature-batch"),
    pytest.param(8, 785, 6, 64, 0, id="eurosat-val-remainder"),
    pytest.param(32, 65, 6, 64, 0, id="eurosat-cli-64px"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("B,N,h,d,boundary", FWD_SHAPES)
def test_forward_kernel_at_every_main_path_shape(cuda_device, B, N, h, d, boundary, layout):
    """K1 at every shape chip_smoke.py checks: the output within 1e-2 of the
    plain version, and the saved log-sum-exp that of the plain f32 scores
    over the live keys within 1e-4 (f32 sums in another order; it is about
    ln N). The packed shapes have query blocks that straddle the boundary,
    whose rows past it see whole key tiles of the other crop first (at
    631/530 the block of rows 512-575 sees four): rows with every key so far
    dead, which must give P = 0 and not NaN."""
    gen = torch.Generator(device=cuda_device).manual_seed(N + d + boundary)
    qkv = torch.randn(B, N, 3, h, d, generator=gen, device=cuda_device).bfloat16()
    q, k, v = _split(qkv, layout)
    s = 1.0 / math.sqrt(d)
    o, lse = hatt.attention_fwd(q, k, v, s, boundary)
    ref = hatt.fused_mha_reference(q, k, v, s, boundary)
    scores = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * s
    live = hatt._live_mask(N, boundary, q.device)
    ref_lse = torch.logsumexp(scores.masked_fill(~live, float("-inf")), dim=-1)
    torch.cuda.synchronize()
    assert o.shape == q.shape and lse.shape == (B, h, N)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (o.float() - ref.float()).abs().max().item() <= 1e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-4


# --- K1 and K2 on the EuroSAT paths -----------------------------------------

@pytest.mark.cuda
def test_feature_extraction_launches_k1_alone(cuda_device):
    """Frozen features (``eval/knn.extract_features``, autograd off) run K1
    forward only: 12 launches a batch of ViT-Ti/16, no K2."""
    from dinomc_tpu_torch.eval.knn import extract_features
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train import cls_trainer as tcls

    cfg = tcls.ClsConfig(arch="vit_tiny", patch_size=16)
    model = tcls.init_cls_train_state(cfg, device=cuda_device).model
    enc = cfg.encoder()
    batches = [(torch.rand(8, 64, 64, 3, device=cuda_device), torch.arange(8)) for _ in range(3)]
    _build.LAUNCHES.clear()
    f, y = extract_features(lambda x: enc.apply(model["backbone"], x), batches)
    assert f.shape == (24, 192) and y.device.type == "cuda"
    assert dict(_build.LAUNCHES) == {"attention_fwd": 36}


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True])
def test_finetune_launch_counts(cuda_device, freeze):
    """``cls_train_step``: per step 12 K1 and, unless the backbone is frozen,
    12 K2 (remat ``attn`` keeps K1's output); a frozen backbone stays
    bit-identical."""
    from dinomc_tpu_torch.ops.hopper import _build
    from dinomc_tpu_torch.train import cls_trainer as tcls

    cfg = tcls.ClsConfig(arch="vit_tiny", patch_size=16, freeze_backbone=freeze)
    state = tcls.init_cls_train_state(cfg, device=cuda_device)
    bb0 = [p.clone() for p in state.model["backbone"].parameters()]
    x = torch.randn(8, 64, 64, 3, device=cuda_device)
    y = torch.arange(8, device=cuda_device) % 10
    _build.LAUNCHES.clear()
    for _ in range(2):
        m = tcls.cls_train_step(state, x, y, 0.01, 0.0, cfg)
    assert np.isfinite(float(m["loss"]))
    assert dict(_build.LAUNCHES) == ({"attention_fwd": 24} if freeze else
                                     {"attention_fwd": 24, "attention_bwd": 24})
    same = all(torch.equal(a, b) for a, b in zip(state.model["backbone"].parameters(), bb0))
    assert same == freeze
