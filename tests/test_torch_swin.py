"""Port Swin-T (dinomc_tpu_torch/models/swin.py) and its DINO step against
the JAX package.

Full Swin-T widths (the JAX ``SwinConfig`` has no depth knob), weights
carried from JAX with ``ckpt/from_jax``, f32 on the CPU where window
attention runs its plain version. Bounds: forward 5e-5 (the kernel-path
bound of tests/test_window_attention.py); DINO steps at
tests/test_torch_dino_step.py's, loss 1e-5 and parameters 5e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt import torch_export
from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.models import swin as jsw
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu.train import optim as joptim
from dinomc_tpu_torch.ckpt import state_dicts
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.models import swin as tsw
from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.hopper.window_attention import window_attention_reference
from dinomc_tpu_torch.train import dino_trainer as ttr
from dinomc_tpu_torch.train import optim as toptim
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401

GLOBAL, LOCAL_SIZES, B, STEPS = 56, (28, 42), 2, 3
jax_forward = jax.jit(jsw.swin_forward, static_argnames=("cfg", "deterministic"))


@pytest.fixture(scope="module")
def jax_swin():
    """JAX Swin-T params (f32) and their host copy."""
    params = jsw.init_swin(jax.random.PRNGKey(0), jsw.swin_t(compute_dtype=jnp.float32))
    return params, jax.device_get(params)


def _port(host_params, **kw):
    model = tsw.SwinTransformer(tsw.swin_t(compute_dtype=torch.float32, **kw))
    load_jax_params(model, host_params)
    return model


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("hw", [(56, 56), (40, 56)], ids=["56px", "40x56"])
def test_forward_matches_jax(jax_swin, gelu_approx, hw):
    """56 px: shift masks at stage 1, pad masks from stage 3. 40 x 56: a
    10 x 14 map, shift + pad masks at stage 1, odd sides at the merges."""
    params, host = jax_swin
    x = _images((2,) + hw + (3,), 1)
    jcfg = jsw.swin_t(compute_dtype=jnp.float32, gelu_approx=gelu_approx)
    ref = np.asarray(jax_forward(params, jnp.asarray(x), jcfg))
    out = _port(host, gelu_approx=gelu_approx)(t(x))
    assert out.shape == (2, 768) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), ref, rtol=5e-5, atol=5e-5)


def test_forward_with_drop_path_matches_jax(jax_swin):
    """JAX's own DropPath draw (``swin_forward``: one bernoulli of shape
    (12, 2, B)) injected into the port as ``dp_masks``."""
    params, host = jax_swin
    x = _images((3, 56, 56, 3), 2)
    jcfg = jsw.swin_t(compute_dtype=jnp.float32, drop_path_rate=0.5)
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jax_forward(params, jnp.asarray(x), jcfg, deterministic=False, rng=rng))
    keeps = 1.0 - jnp.linspace(0.0, 0.5, 12)
    masks = np.array(jax.random.bernoulli(rng, keeps[:, None, None], (12, 2, 3)))
    assert 0 < masks.sum() < masks.size
    model = _port(host, drop_path_rate=0.5)
    out = tsw.swin_forward(model, t(x), deterministic=False, dp_masks=torch.from_numpy(masks))
    np.testing.assert_allclose(n(out), ref, rtol=5e-5, atol=5e-5)
    drawn = tsw.drop_path_masks(model.cfg, 4, torch.Generator().manual_seed(0), "cpu")
    assert drawn.shape == (12, 2, 4) and drawn.dtype == torch.bool


@pytest.mark.parametrize("hw", [(56, 56), (40, 56)])
def test_kernel_gate_routes_blocks(jax_swin, monkeypatch, hw):
    """Every one of the 12 blocks takes ``window_attention`` (K7/K8 on the
    card), with its stage's head count: no stage is gated to the plain
    version, as the JAX package gates its TPU kernel to heads <= 6."""
    calls = []
    monkeypatch.setattr(tsw, "window_attention", lambda *a: calls.append(a[-1]) or
                        window_attention_reference(*a))
    _port(jax_swin[1])(t(_images((1,) + hw + (3,), 3)))
    assert calls == [3] * 2 + [6] * 2 + [12] * 6 + [24] * 2


def test_state_dict_is_the_jax_export(jax_swin):
    """The port's ``swin_state_dict`` equals the JAX package's key for key
    and value for value, and a Swin module takes it with strict=True
    (``relative_position_index`` is a non-persistent buffer)."""
    _, host = jax_swin
    ours = state_dicts.swin_state_dict(host, "backbone.")
    ref = torch_export.swin_state_dict(host, "backbone.")
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    model = _port(host)
    assert set(model.state_dict()) == {k[len("backbone."):] for k in ref}
    assert "features.1.0.attn.relative_position_index" in dict(model.named_buffers())


def test_wd_mask_and_clip_groups_match_jax(jax_swin):
    """The port's ``wd_mask`` over torchvision names equals JAX ``wd_mask``
    over the tree (mapped through the export); the (169, heads) relative
    bias table is decayed on both sides. Swin's blocks stay a list in the
    JAX package, so every tensor is its own clipping group."""
    _, host = jax_swin
    params = dict(_port(host).named_parameters())
    jwd = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32),
                                 joptim.wd_mask(host), host)
    jwd = state_dicts.swin_state_dict(jwd)
    ours = toptim.wd_mask(params)
    assert set(ours) == set(jwd)
    for k, m in ours.items():
        assert np.all(jwd[k] == m), k
    assert ours["features.1.0.attn.relative_position_bias_table"] == 1.0
    assert ours["features.1.0.attn.qkv.bias"] == 0.0 and ours["features.0.2.weight"] == 0.0
    assert all(toptim.stacked_name(k) == k for k in params)


def _configs():
    common = dict(arch="swin_t", out_dim=64, drop_path_rate=0.0, niter_per_ep=1,
                  global_crop_size=GLOBAL, compute_dtype="float32", gelu_approx=False)
    return jtr.DinoConfig(**common), ttr.DinoConfig(**common)


def test_three_dino_steps_match_jax():
    """Three ``dino_train_step``s of both packages from JAX's own
    initialization: 56 px globals, 28 and 42 px locals (each its own
    forward: Swin does not pack crops; shift, pad and shift + pad masks),
    clipping, the last-layer freeze in epoch 0, AdamW, the EMA teacher."""
    jcfg, tcfg = _configs()
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    lr = jsched.cosine_scheduler(5e-4, 1e-6, STEPS, 1, warmup_epochs=1)
    wd = jsched.cosine_scheduler(0.04, 0.4, STEPS, 1)
    mom = jsched.cosine_scheduler(0.996, 1.0, STEPS, 1)
    ttemp = jsched.teacher_temp_schedule(0.04, 0.07, 1, STEPS)
    jsch = jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                             teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp))
    tsch = ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp)
    rng = np.random.default_rng(7)
    for it in range(STEPS):
        g = rng.standard_normal((2, B, GLOBAL, GLOBAL, 3)).astype(np.float32)
        locals_ = [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in LOCAL_SIZES]
        jstate, jm = jtr.dino_train_step(jstate, jnp.asarray(g), tuple(map(jnp.asarray, locals_)),
                                         jsch, jcfg)
        tm = ttr.dino_train_step(tstate, t(g), tuple(map(t, locals_)), tsch, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0,
                                   err_msg=f"loss at step {it}")
    for which in ("student", "teacher"):
        tree = jax.device_get(getattr(jstate, which))
        ref = state_dicts.swin_state_dict(tree["backbone"], "backbone.")
        ref.update(state_dicts.dino_head_state_dict(tree["head"], "head."))
        assert_state_dicts_close(getattr(tstate, which).state_dict(), ref, 5e-4, f"{which} ")
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=5e-4)


def test_cli_runs_swin_on_the_cpu(tmp_path):
    """``train_dino --arch swin_t`` at the smallest size the flags allow:
    one image a step, 224 px globals and one 96 px local; window attention
    takes its plain version on CPU tensors, so no kernel launches."""
    args = get_args_parser().parse_args([
        "--device", "cpu", "--arch", "swin_t", "--out_dim", "64", "--batch_size_per_gpu", "1",
        "--local_crops_number", "1", "--size_crops", "96", "--num_workers", "1",
        "--image_size", "224", "--max_steps", "1", "--output_dir", str(tmp_path),
    ])
    _build.LAUNCHES.clear()
    summary = train_dino(args)
    assert len(summary.losses) == 1 and math.isfinite(summary.losses[0])
    assert isinstance(summary.state.student["backbone"], tsw.SwinTransformer)
    assert not _build.LAUNCHES
