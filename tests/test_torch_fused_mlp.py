"""Port fused MLP (ops/hopper/fused_mlp.py, K11) against the JAX package's.

The plain version and the plain backward are held to JAX ``fused_mlp`` (its
Pallas kernel in TPU interpret mode, its ``_fused_bwd``) in f32 at the
bounds of tests/test_fused_mlp.py: forward 2e-5, gradients 5e-4. The ViT
with ``mlp_impl='fused'`` is held to the JAX ViT with the same config,
weights carried across by ``ckpt/from_jax``. The CUDA kernel is held to the
plain version on the card (``cuda``-marked, skipped without one) at
chip_smoke.py's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dinomc_tpu.ckpt.torch_export import vit_state_dict
from dinomc_tpu.models import vit as jvit
from dinomc_tpu.ops.pallas import fused_mlp as jfm
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.models import vit as tvit
from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.hopper import fused_mlp as tfm
from _torch_port import cuda_device, n, one_torch_thread, t  # noqa: F401


def _mats(M=100, D=32, F=128, seed=0):
    """x (M, D) and the JAX layout's W1 (D, F), b1, W2 (F, D), b2, f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1, b1, w2, b2 = (0.1 * rng.standard_normal(s).astype(np.float32)
                      for s in ((D, F), (F,), (F, D), (D,)))
    return x, w1, b1, w2, b2


def _port_args(x, w1, b1, w2, b2):
    """The port's Linear layout: W1 (F, D), W2 (D, F)."""
    return t(x), t(w1.T), t(b1), t(w2.T), t(b2)


@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
def test_forward_matches_jax_kernel(approx):
    x, w1, b1, w2, b2 = _mats(seed=int(approx))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfm.fused_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2)), approx=approx))
    out = tfm.fused_mlp(*_port_args(x, w1, b1, w2, b2), approx)
    assert out.shape == (100, 32)  # a ragged M: no padding to the TPU's 512 rows
    np.testing.assert_allclose(n(out), ref, atol=2e-5)
    np.testing.assert_allclose(n(tfm.fused_mlp_reference(*_port_args(x, w1, b1, w2, b2), approx)),
                               ref, atol=2e-5)


@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
def test_gradients_match_jax_backward(approx):
    x, w1, b1, w2, b2 = _mats(seed=2 + int(approx))

    def loss(*a):
        return jnp.sum(jfm.fused_mlp(*a, approx=approx) ** 2)

    with pltpu.force_tpu_interpret_mode():
        g_ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    xs = [a.requires_grad_() for a in _port_args(x, w1, b1, w2, b2)]
    g = torch.autograd.grad((tfm.fused_mlp(*xs, approx) ** 2).sum(), xs)
    # the port's weight gradients are in its (out, in) layout
    for a, b, name in zip(g, (g_ref[0], g_ref[1].T, g_ref[2], g_ref[3].T, g_ref[4]),
                          ("dx", "dW1", "db1", "dW2", "db2")):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=5e-4, err_msg=name)


def test_backward_reads_only_the_saved_inputs():
    """The backward takes the same values whatever the forward computed: the
    plain route and a forward with another output give the same gradients."""
    args = _port_args(*_mats(M=37, seed=4))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal((37, 32)).astype(np.float32))
    grads = []
    for forward in (tfm.fused_mlp_reference, lambda x, *_: torch.zeros_like(x)):
        xs = [a.clone().requires_grad_() for a in args]
        out = tfm.FusedMLP.apply(*xs, True, forward)
        grads.append(torch.autograd.grad(out, xs, do))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _vit_pair(mlp_impl, drop_path_rate=0.0):
    jcfg = jvit.vit_test(compute_dtype=jnp.float32, gelu_approx=True, mlp_impl=mlp_impl,
                         drop_path_rate=drop_path_rate, remat=False)
    params = jvit.init_vit(jax.random.PRNGKey(0), jcfg)
    model = tvit.VisionTransformer(tvit.vit_test(
        compute_dtype=torch.float32, gelu_approx=True, mlp_impl=mlp_impl, remat=False,
        drop_path_rate=drop_path_rate))
    load_jax_params(model, jax.device_get(params))
    return jcfg, params, model


def test_vit_fused_forward_and_gradients_match_jax():
    jcfg, params, model = _vit_pair("fused")
    x = np.random.default_rng(6).standard_normal((2, 16, 16, 3)).astype(np.float32)

    def loss(p):
        return jnp.sum(jvit.vit_forward(p, jnp.asarray(x), jcfg) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref_loss, g_ref = jax.value_and_grad(loss)(params)
        ref_out = np.asarray(jvit.vit_forward(params, jnp.asarray(x), jcfg))
    out = tvit.vit_forward(model, t(x))
    np.testing.assert_allclose(n(out), ref_out, atol=2e-5)
    names = [k for k, _ in model.named_parameters()]
    total = (out ** 2).sum()
    np.testing.assert_allclose(float(total.detach()), float(ref_loss), rtol=1e-5)
    g = torch.autograd.grad(total, list(model.parameters()))
    ref = vit_state_dict(jax.device_get(g_ref))
    for name, a in zip(names, g):
        np.testing.assert_allclose(n(a), np.asarray(ref[name]), atol=5e-4, err_msg=name)


def test_vit_routes_the_mlp_by_impl(monkeypatch):
    """``mlp_impl='fused'`` sends every block's MLP to ``fused_mlp`` with the
    Linear layers' own tensors, and ``'dense'`` never does; the two agree
    in f32 (they round the hidden activation alike there)."""
    calls = []
    real = tvit.fused_mlp
    monkeypatch.setattr(tvit, "fused_mlp", lambda *a: calls.append(a[1].shape) or real(*a))
    _, _, fused = _vit_pair("fused")
    _, _, dense = _vit_pair("dense")
    x = t(np.random.default_rng(7).standard_normal((2, 16, 16, 3)))
    out_fused = tvit.vit_forward(fused, x)
    assert calls == [(128, 32)] * 3  # W1 (F, D), one call a block
    out_dense = tvit.vit_forward(dense, x)
    assert len(calls) == 3
    np.testing.assert_allclose(n(out_fused), n(out_dense), atol=1e-5)


def test_config_refuses_an_unknown_impl():
    with pytest.raises(ValueError, match="mlp_impl"):
        tvit.vit_test(mlp_impl="triton")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches K11 or raises; it never falls back."""
    args = [a.bfloat16() for a in _port_args(*_mats(M=8, D=192, F=768))]
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_fwd(*args, True)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.FusedMLP.apply(*args, True, tfm.fused_mlp_fwd)


# (M, D, F): the DINO step's row counts at ViT-S (16 global crops of 785
# tokens; packed 184+84, 164+124, 144+104 px pairs; 84 px alone), ViT-B and
# ViT-Ti widths, and a ragged small M; then at each width an M below one
# row tile (128 rows at D = 192 and 384, 64 at 768), one past a tile edge,
# and 12560
CARD_SHAPES = [(12560, 384, 1536), (5048, 384, 1536), (808, 384, 1536),
               (12560, 768, 3072), (70, 192, 768),
               (50, 192, 768), (129, 192, 768), (12560, 192, 768),
               (50, 384, 1536), (129, 384, 1536),
               (40, 768, 3072), (65, 768, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("M,D,F", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, M, D, F, approx):
    gen = torch.Generator(device="cuda").manual_seed(M + D)
    x = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    w1, w2 = ((torch.randn(*s, generator=gen, device="cuda") / s[1] ** 0.5).bfloat16()
              for s in ((F, D), (D, F)))
    b1, b2 = (0.1 * torch.randn(s, generator=gen, device="cuda").bfloat16() for s in (F, D))
    do = torch.randn(M, D, generator=gen, device="cuda").bfloat16()
    before = _build.LAUNCHES["fused_mlp"]
    outs, grads = [], []
    for forward in (tfm.fused_mlp_fwd, tfm.fused_mlp_reference):
        xs = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2)]
        out = tfm.FusedMLP.apply(*xs, approx, forward)
        outs.append(out.float())
        grads.append(torch.autograd.grad(out, xs, do))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mlp"] == before + 1
    rel = (outs[0] - outs[1]).abs().max() / outs[1].abs().max()
    assert rel.item() <= 1e-2, rel.item()
    for a, b in zip(*grads):
        assert torch.equal(a, b)  # the backward reads only the saved inputs and dO

