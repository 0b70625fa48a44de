"""Port ViT remat (models/vit.py ``ViTConfig.remat``/``remat_policy``)
against no remat and against the JAX package.

Every policy recomputes the same numbers: in f32 on the CPU the loss and
every parameter gradient of a ``vit_test`` student (DropPath on, plain and
packed) are bit-identical to ``remat=False`` (the recompute runs the same
ops on the same inputs), and match the JAX ViT under the same policy at the
ViT parity tests' bounds. What a policy keeps shows in the kernel launches:
with the kernels' launchers replaced by counting plain versions on the CPU,
the attention forward (K1) runs again in the backward only under ``full``
and ``dots``, and the fused MLP (K11) under every policy.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.cli.train_dino import get_args_parser as jax_args_parser
from dinomc_tpu.ckpt.torch_export import vit_state_dict
from dinomc_tpu.models import vit as jvit
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.models import vit as tvit
from dinomc_tpu_torch.ops import attention as tatt
from dinomc_tpu_torch.ops.hopper import attention as hatt
from dinomc_tpu_torch.ops.hopper import fused_mlp as tfm
from _torch_port import n, one_torch_thread, t  # noqa: F401
from test_torch_vit import _jax_masks

POLICIES = sorted(tvit.REMAT_POLICIES)
B, DEPTH = 3, 3


def _model(**kw):
    cfg = tvit.vit_test(compute_dtype=torch.float32, drop_path_rate=0.3, **kw)
    return tvit.VisionTransformer(cfg, torch.Generator().manual_seed(0))


def _images(seed, size=16):
    return t(np.random.default_rng(seed).standard_normal((B, size, size, 3)))


def _loss_and_grads(model, packed, masks):
    if packed:
        a, b = tvit.vit_forward_packed(model, _images(1), _images(2, 12), None, False, masks)
        loss = (a ** 2).sum() + 0.5 * (b ** 2).sum()
    else:
        loss = (tvit.vit_forward(model, _images(1), None, False, masks) ** 2).sum()
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("mlp_impl", ["dense", "fused"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bit_identical_to_no_remat(policy, packed, mlp_impl):
    model = _model(mlp_impl=mlp_impl, remat=False)
    masks = tvit.drop_path_masks(model.cfg, B, packed, torch.Generator().manual_seed(3), "cpu")
    ref_loss, ref = _loss_and_grads(model, packed, masks)
    model.cfg = dataclasses.replace(model.cfg, remat=True, remat_policy=policy)
    loss, got = _loss_and_grads(model, packed, masks)
    assert torch.equal(loss, ref_loss)
    for (name, _), a, b in zip(model.named_parameters(), got, ref):
        assert torch.equal(a, b), name


def test_drop_path_draw_is_outside_the_recompute():
    """Masks drawn from a generator inside the forward (one draw, before the
    checkpointed blocks): remat gives the no-remat gradients."""
    out = []
    for remat in (False, True):
        model = _model(remat=remat)
        loss = (tvit.vit_forward(model, _images(4), torch.Generator().manual_seed(9), False) ** 2).sum()
        out.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_intermediate_layers_under_remat():
    """The segmentation backbone's tap path recomputes too, to the same
    gradients."""
    out = []
    for remat in (False, True):
        model = _model(remat=remat)
        taps = tvit.vit_intermediate_layers(model, _images(5), (0, 2), apply_norm=False)
        used = [p for name, p in model.named_parameters() if not name.startswith("norm.")]
        out.append(torch.autograd.grad((taps ** 2).sum(), used))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy, packed):
    jcfg = jvit.vit_test(compute_dtype=jnp.float32, gelu_approx=False, drop_path_rate=0.3,
                         remat=True, remat_policy=policy)
    params = jvit.init_vit(jax.random.PRNGKey(0), jcfg)
    rng = jax.random.PRNGKey(7)
    xa = np.random.default_rng(1).standard_normal((B, 16, 16, 3)).astype(np.float32)
    xb = np.random.default_rng(2).standard_normal((B, 12, 12, 3)).astype(np.float32)

    def loss(p):
        if packed:
            a, b = jvit.vit_forward_packed(p, jnp.asarray(xa), jnp.asarray(xb), jcfg, rng, False)
            return jnp.sum(a ** 2) + 0.5 * jnp.sum(b ** 2)
        return jnp.sum(jvit.vit_forward(p, jnp.asarray(xa), jcfg, rng, False) ** 2)

    ref_loss, g_ref = jax.value_and_grad(loss)(params)
    model = tvit.VisionTransformer(tvit.vit_test(
        compute_dtype=torch.float32, gelu_approx=False, drop_path_rate=0.3, remat_policy=policy))
    load_jax_params(model, jax.device_get(params))
    masks = torch.from_numpy(_jax_masks(jcfg, rng, B, packed))
    got_loss, got = _loss_and_grads(model, packed, masks)
    np.testing.assert_allclose(float(got_loss.detach()), float(ref_loss), rtol=1e-5)
    ref = vit_state_dict(jax.device_get(g_ref))
    for (name, _), a in zip(model.named_parameters(), got):
        np.testing.assert_allclose(n(a), np.asarray(ref[name]), atol=1e-4, rtol=1e-5,
                                   err_msg=name)


@pytest.fixture
def counted_kernels(monkeypatch):
    """K1, K2 and K11's launchers replaced by counting plain versions on the
    CPU, so the ViT takes the kernels' autograd routes (``FusedMHA`` with
    its kept launch, ``FusedMLP``) and the counts are what the card would
    launch."""
    launches = collections.Counter()

    def attention_fwd(q, k, v, scale, boundary):
        launches["attention_fwd"] += 1
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
        s = s.masked_fill(~hatt._live_mask(q.shape[1], boundary, q.device), float("-inf"))
        return hatt.fused_mha_reference(q, k, v, scale, boundary), torch.logsumexp(s, -1)

    def attention_bwd(q, k, v, o, lse, do, scale, boundary):
        launches["attention_bwd"] += 1
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(hatt.fused_mha_reference(*xs, scale, boundary), xs, do)

    plain_mlp = tfm.fused_mlp_reference

    def fused_mlp(*args):
        launches["fused_mlp"] += 1
        return plain_mlp(*args)

    monkeypatch.setattr(hatt, "attention_fwd", attention_fwd)
    monkeypatch.setattr(hatt, "attention_bwd", attention_bwd)
    monkeypatch.setattr(tatt, "fused_mha", lambda q, k, v, scale, boundary=0: hatt.FusedMHA.apply(
        q, k, v, float(scale), int(boundary)))
    monkeypatch.setattr(tfm, "fused_mlp_reference", fused_mlp)
    return launches


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_kernel_launches_follow_the_policy(counted_kernels, policy):
    """One student forward + backward over DEPTH blocks: K1 runs again in the
    backward unless the policy keeps ``attn_out`` (the JAX package's 60 vs
    108 launches a DINO step), K2 once a block, K11 again under any remat."""
    kw = {"remat": False} if policy is None else {"remat_policy": policy}
    model = _model(mlp_impl="fused", **kw)
    masks = tvit.drop_path_masks(model.cfg, B, True, torch.Generator().manual_seed(3), "cpu")
    _, got = _loss_and_grads(model, True, masks)
    counted = dict(counted_kernels)
    reruns_attention = policy is not None and "attn_out" not in tvit.REMAT_POLICIES[policy]
    assert counted == {"attention_fwd": DEPTH * (1 + reruns_attention), "attention_bwd": DEPTH,
                       "fused_mlp": DEPTH * (1 + (policy is not None))}
    model.cfg = dataclasses.replace(model.cfg, remat=False)
    _, ref = _loss_and_grads(model, True, masks)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_no_recompute_without_autograd(counted_kernels):
    """Under ``no_grad`` (the teacher, a frozen backbone) nothing is
    checkpointed and nothing runs twice."""
    model = _model(mlp_impl="fused", remat_policy="full")
    with torch.no_grad():
        tvit.vit_forward(model, _images(1))
    assert dict(counted_kernels) == {"attention_fwd": DEPTH, "fused_mlp": DEPTH}


def test_cli_offers_the_jax_choices():
    def choices(parser):
        return next(a.choices for a in parser._actions if a.dest == "remat_policy")

    assert sorted(choices(get_args_parser())) == sorted(choices(jax_args_parser())) == POLICIES
    assert get_args_parser().parse_args([]).remat_policy == "attn"
    with pytest.raises(SystemExit):
        get_args_parser().parse_args(["--remat_policy", "everything"])
    with pytest.raises(ValueError, match="remat_policy"):
        tvit.vit_test(remat_policy="everything")


@pytest.mark.parametrize("policy", POLICIES)
def test_cli_trains_under_each_policy(tmp_path, policy):
    args = get_args_parser().parse_args([
        "--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--out_dim", "64",
        "--batch_size_per_gpu", "2", "--num_workers", "1", "--max_steps", "1",
        "--local_crops_number", "2", "--remat_policy", policy, "--output_dir", str(tmp_path),
    ])
    summary = train_dino(args)
    assert len(summary.losses) == 1 and np.isfinite(summary.losses[0])
    for model in (summary.state.student, summary.state.teacher):
        assert model["backbone"].cfg.remat_policy == policy
