"""Port XCiT (dinomc_tpu_torch/models/xcit.py) and its training paths
against the JAX package.

Weights come from the JAX package's ``init_xcit`` and cross with
``ckpt/from_jax.load_jax_params``; inputs are numpy draws from a seed; both
sides run in f32 on the CPU. The forward runs at tests/test_xcit.py's TINY
widths, patch 16 and 8, at sizes whose stem inputs are even and odd. Bounds:
forward 1e-5 (the two packages differ by ~1e-6 at features of ~2);
gradients 5e-5 of each leaf's largest entry (the gradients of the
LayerNorm that feeds the LPI's batch-statistics BatchNorm drift 1.5e-5 of
their largest from float64 in JAX itself, 1.2e-5 in the port); the DINO steps
tests/test_torch_swin.py's for AdamW (loss 1e-5, parameters 5e-4) and
tests/test_torch_convnet_step.py's for LARS at lr 0.3 (loss 5e-5,
parameters 2e-3, each leaf's change from the init within 1e-2 of JAX's
largest); the classification step tests/test_torch_cls.py's (loss 1e-5,
parameters 5e-4, logits 1e-5 of their largest).

The JAX package has no small XCiT arch, so the training tests swap both
packages' ``XCIT_FACTORIES['xcit_small_12']`` for a two-layer one at its
width (384: the JAX ``EncoderConfig.embed_dim`` names it) with
``monkeypatch.setitem``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.models import xcit as jxc
from dinomc_tpu.train import cls_trainer as jcls
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu.train import optim as joptim
from dinomc_tpu_torch.ckpt.from_jax import head_state_dict, load_jax_params, xcit_state_dict
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.models import xcit as txc
from dinomc_tpu_torch.models.encoders import EncoderConfig
from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.train import cls_trainer as tcls
from dinomc_tpu_torch.train import dino_trainer as ttr
from dinomc_tpu_torch.train import optim as toptim
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401
from test_torch_convnet_step import _assert_changes_close

TINY = dict(embed_dim=32, depth=2, num_heads=2, cls_attn_layers=1, pos_hidden=8)
SIZES = (32, 40, 44, 48, 84)  # p16 stems see 5, 11, 21 (odd); p8 stems 5, 11, 21
FWD_TOL = 1e-5
jax_forward = jax.jit(jxc.xcit_forward, static_argnames=("cfg", "deterministic"))


def _configs(patch, **kw):
    return (jxc.XCiTConfig(patch_size=patch, compute_dtype=jnp.float32, **TINY, **kw),
            txc.XCiTConfig(patch_size=patch, compute_dtype=torch.float32, **TINY, **kw))


@pytest.fixture(scope="module", params=[16, 8], ids=["p16", "p8"])
def tiny(request):
    """(JAX config, port config, JAX params, port model) at one patch size."""
    jcfg, tcfg = _configs(request.param)
    params = jax.device_get(jxc.init_xcit(jax.random.PRNGKey(request.param), jcfg))
    model = txc.XCiT(tcfg)
    load_jax_params(model, params)
    return jcfg, tcfg, params, model


def _images(B, size, seed):
    return np.random.default_rng(seed).uniform(size=(B, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", SIZES)
def test_forward_matches_jax(tiny, size):
    jcfg, _, params, model = tiny
    x = _images(3, size, size)
    ref = np.asarray(jax_forward(params, jnp.asarray(x), jcfg))
    out = txc.xcit_forward(model, t(x))
    assert out.shape == (3, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), ref, atol=FWD_TOL, rtol=0)


def test_forward_with_erf_gelu_matches_jax(tiny):
    jcfg, tcfg, params, _ = tiny
    model = txc.XCiT(dataclasses.replace(tcfg, gelu_approx=False))
    load_jax_params(model, params)
    x = _images(2, 44, 1)
    ref = np.asarray(jax_forward(params, jnp.asarray(x), dataclasses.replace(jcfg, gelu_approx=False)))
    np.testing.assert_allclose(n(txc.xcit_forward(model, t(x))), ref, atol=FWD_TOL, rtol=0)


def test_stem_pads_as_xla_same(tiny, monkeypatch):
    """XLA's "SAME" at stride 2 pads an even side (0, 1) and an odd one
    (1, 1); torch-style k // 2 on both sides gives the same shapes with every
    window one pixel off, and the parity test sees it."""
    assert [txc._same_pad(s, 3, 2) for s in (224, 41, 42, 21)] == [(0, 1), (1, 1), (0, 1), (1, 1)]
    assert txc._same_pad(11, 3, 1) == (1, 1)
    jcfg, _, params, model = tiny
    x = _images(2, 84, 2)
    ref = np.asarray(jax_forward(params, jnp.asarray(x), jcfg))
    monkeypatch.setattr(txc, "_same_pad", lambda n_, k, s: (k // 2, k // 2))
    assert np.abs(n(txc.xcit_forward(model, t(x))) - ref).max() > 100 * FWD_TOL


def test_fourier_pos_matches_jax():
    """x features before y, (i + 1) / (g + 1e-6) * 2 pi, on grids square and not."""
    for gh, gw, hidden in ((3, 5, 8), (11, 11, 32), (28, 28, 32)):
        ours = txc.fourier_pos(gh, gw, hidden)
        ref = np.asarray(jxc._fourier_pos(gh, gw, hidden))
        assert ours.shape == ref.shape == (gh * gw, 2 * hidden)
        np.testing.assert_allclose(n(ours), ref, atol=1e-6, rtol=0)


def test_forward_with_drop_path_matches_jax(tiny):
    """JAX's own draws (``xcit_forward``: (depth, 3, B) and (cls, 2, B) from
    one split) injected into the port as ``dp_masks``."""
    jcfg, tcfg, params, _ = tiny
    jcfg, tcfg = (dataclasses.replace(c, drop_path_rate=0.5) for c in (jcfg, tcfg))
    model = txc.XCiT(tcfg)
    load_jax_params(model, params)
    x, B = _images(5, 40, 3), 5
    rng = jax.random.PRNGKey(4)
    ref = np.asarray(jax_forward(params, jnp.asarray(x), jcfg, rng, deterministic=False))
    rb, rc = jax.random.split(rng)
    masks = (t(jax.random.bernoulli(rb, 0.5, (2, 3, B)), torch.bool),
             t(jax.random.bernoulli(rc, 0.5, (1, 2, B)), torch.bool))
    assert 0 < int(masks[0].sum()) < masks[0].numel()
    out = txc.xcit_forward(model, t(x), deterministic=False, dp_masks=masks)
    np.testing.assert_allclose(n(out), ref, atol=FWD_TOL, rtol=0)
    drawn = txc.drop_path_masks(tcfg, 4, torch.Generator().manual_seed(0), "cpu")
    assert [m.shape for m in drawn] == [(2, 3, 4), (1, 2, 4)]
    assert all(m.dtype == torch.bool for m in drawn)
    off = txc.xcit_forward(model, t(x))  # deterministic: no DropPath
    np.testing.assert_allclose(n(off), np.asarray(jax_forward(params, jnp.asarray(x), jcfg)),
                               atol=FWD_TOL, rtol=0)


# --- gradients and remat ------------------------------------------------------

GRAD_B, GRAD_SIZE = 3, 44  # a p8 stem at 44 px: 22, 11 (odd), 6


@pytest.fixture(scope="module")
def jax_grads():
    """One jitted ``jax.grad`` of a random projection of the p8 features,
    shared by the tests that need it. Returns (config, params, images,
    projection, gradient tree)."""
    jcfg, _ = _configs(8)
    params = jax.device_get(jxc.init_xcit(jax.random.PRNGKey(8), jcfg))
    x = _images(GRAD_B, GRAD_SIZE, 5)
    w = np.random.default_rng(6).standard_normal((GRAD_B, 32)).astype(np.float32)

    def loss(p, x, w):
        return jnp.sum(jxc.xcit_forward(p, x, jcfg) * w)

    grads = jax.jit(jax.grad(loss))(params, jnp.asarray(x), jnp.asarray(w))
    return jcfg, params, x, w, jax.device_get(grads)


def _port_grads(params, x, w, **cfg_kw):
    _, tcfg = _configs(8, **cfg_kw)
    model = txc.XCiT(tcfg)
    load_jax_params(model, params)
    loss = (txc.xcit_forward(model, t(x)) * t(w)).sum()
    names, ps = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, ps)))


def test_grads_match_jax(jax_grads):
    """Every gradient leaf, the stacked blocks' split by layer, within 5e-5
    of the leaf's largest entry."""
    _, params, x, w, grads = jax_grads
    _, ours = _port_grads(params, x, w)
    ref = xcit_state_dict(grads)
    assert set(ours) == set(ref)
    for k in sorted(ref):
        np.testing.assert_allclose(n(ours[k]), ref[k], atol=5e-5 * np.abs(ref[k]).max() + 1e-9,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "branches")],
                         ids=["off", "branches"])
def test_remat_policies_compute_what_full_computes(jax_grads, remat, policy):
    """The loss and every gradient bit-equal to the default (remat, ``full``)."""
    _, params, x, w, _ = jax_grads
    loss, grads = _port_grads(params, x, w)
    loss2, grads2 = _port_grads(params, x, w, remat=remat, remat_policy=policy)
    assert torch.equal(loss, loss2)
    for k in grads:
        assert torch.equal(grads[k], grads2[k]), k
    with pytest.raises(ValueError, match="remat_policy"):
        txc.XCiTConfig(remat_policy="attn")


def test_state_has_no_running_statistics_and_eval_reads_the_batch(tiny):
    """The LPI BatchNorm keeps no buffers, and normalizes by the batch in
    eval too: an image's features change with the batch it is in, in both
    packages alike."""
    jcfg, _, params, model = tiny
    assert not list(model.buffers())
    assert set(model.state_dict()) == {k for k, _ in model.named_parameters()}
    x = _images(4, 40, 7)
    for batch in (x[:2], x):
        ref = np.asarray(jax_forward(params, jnp.asarray(batch), jcfg))
        np.testing.assert_allclose(n(txc.xcit_forward(model, t(batch))), ref,
                                   atol=FWD_TOL, rtol=0)
    alone = n(txc.xcit_forward(model, t(x[:2])))
    within = n(txc.xcit_forward(model, t(x)))[:2]
    assert np.abs(alone - within).max() > 1e-3


def test_wd_mask_and_clip_groups_are_the_jax_leaves():
    """Over the trainers' names (``backbone.``), the port's ``wd_mask``
    equals the JAX ``wd_mask`` of the tree, mapped through
    ``xcit_state_dict``: a block's ``temp``, ``gamma*``, LayerNorm and LPI
    BatchNorm scales are rows of (depth, ...) leaves and are decayed; a
    class-attention layer's are 1-D and are not. The clipping groups
    (``stacked_name``) are the JAX leaves: ``blocks.{l}.`` joined, ``stem``
    and ``cls_blocks`` each its own."""
    jcfg, _ = _configs(8)
    tree = jax.device_get(jxc.init_xcit(jax.random.PRNGKey(0), jcfg))
    jwd = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32),
                                 joptim.wd_mask(tree), tree)
    ref = xcit_state_dict(jwd, "backbone.")
    model = txc.XCiT(_configs(8)[1])
    params = {f"backbone.{k}": p for k, p in model.named_parameters()}
    ours = toptim.wd_mask(params)
    assert set(ours) == set(ref)
    for k, m in ours.items():
        assert np.all(ref[k] == m), k
    assert ours["backbone.blocks.1.temp"] == ours["backbone.blocks.0.gamma3"] == 1.0
    assert ours["backbone.blocks.0.lpi_bn.weight"] == ours["backbone.blocks.1.norm1.weight"] == 1.0
    assert ours["backbone.cls_blocks.0.gamma1"] == ours["backbone.cls_blocks.0.norm1.weight"] == 0.0
    # a leaf's index in every element of its leaf, mapped: a group is a leaf
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(v), i, np.float32) for i, v in enumerate(leaves)])
    by_leaf = {}
    for k, v in xcit_state_dict(ids, "backbone.").items():
        assert np.unique(v).size == 1
        by_leaf.setdefault(int(v.flat[0]), set()).add(k)
    assert sorted(map(sorted, by_leaf.values())) == sorted(
        map(sorted, toptim._groups(params).values()))
    assert toptim._groups(params)["backbone.blocks.*.qkv.weight"] == [
        "backbone.blocks.0.qkv.weight", "backbone.blocks.1.qkv.weight"]


# --- the training steps, at a two-layer XCiT ------------------------------------

GLOBAL, LOCAL_SIZES, B, NITER, EPOCHS = 32, (24, 16, 16), 4, 2, 3


def _small(mod):
    def factory(patch_size=16, **kw):
        return mod.XCiTConfig(patch_size=patch_size, embed_dim=384, depth=2, num_heads=8,
                              cls_attn_layers=1, pos_hidden=8, **kw)
    return factory


@pytest.fixture
def small_xcit(monkeypatch):
    for mod in (jxc, txc):
        monkeypatch.setitem(mod.XCIT_FACTORIES, "xcit_small_12", _small(mod))


def _crops(rng):
    crops = [rng.standard_normal((B, GLOBAL, GLOBAL, 3)).astype(np.float32) for _ in range(2)]
    return crops + [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in LOCAL_SIZES]


def _dino_sd(tree):
    tree = jax.device_get(tree)
    sd = xcit_state_dict(tree["backbone"], "backbone.")
    sd.update(head_state_dict(tree["head"], "head."))
    return sd


@pytest.mark.parametrize("optimizer", ["adamw", "lars"])
def test_three_dino_steps_match_jax(small_xcit, optimizer):
    """3 ``dino_train_step``s of both packages from JAX's init: 32 px
    globals in one backbone call, the 16 px bucket (two crops) and the 24 px
    one each in one call (XCiT packs nothing; the LPI BatchNorm sees each
    call's batch), clipping over the stacked groups, the last-layer freeze
    of epoch 0 and its end, the EMA teacher and the centre; AdamW on the
    CLI's schedules, LARS on the convnet recipe's lr 0.3."""
    common = dict(arch="xcit_small_12", patch_size=8, out_dim=64, drop_path_rate=0.0,
                  niter_per_ep=NITER, global_crop_size=GLOBAL, compute_dtype="float32",
                  gelu_approx=False, optimizer=optimizer)
    jcfg, tcfg = jtr.DinoConfig(**common), ttr.DinoConfig(**common)
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    assert isinstance(tstate.student["backbone"], txc.XCiT)
    load_jax_params(tstate, jax.device_get(jstate))
    init = {which: {k: n(v).copy() for k, v in getattr(tstate, which).state_dict().items()}
            for which in ("student", "teacher")}
    base, wd0, wd1 = (5e-4, 0.04, 0.4) if optimizer == "adamw" else (0.3, 1e-6, 1e-6)
    lr = jsched.cosine_scheduler(base, 1e-6, EPOCHS, NITER, warmup_epochs=1)
    wd = jsched.cosine_scheduler(wd0, wd1, EPOCHS, NITER)
    mom = jsched.cosine_scheduler(0.996, 1.0, EPOCHS, NITER)
    ttemp = jsched.teacher_temp_schedule(0.04, 0.07, 2, EPOCHS)
    jsch = jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                             teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp))
    tsch = ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp)
    loss_tol, param_tol = (1e-5, 5e-4) if optimizer == "adamw" else (5e-5, 2e-3)
    rng = np.random.default_rng(7)
    for it in range(3):
        crops = _crops(rng)
        g = np.stack(crops[:2])
        jstate, jm = jtr.dino_train_step(jstate, jnp.asarray(g), tuple(map(jnp.asarray, crops[2:])),
                                         jsch, jcfg)
        tm = ttr.dino_train_step(tstate, t(g), tuple(map(t, crops[2:])), tsch, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=loss_tol, rtol=0,
                                   err_msg=f"loss at step {it}")
    for which in ("student", "teacher"):
        ours, ref = getattr(tstate, which).state_dict(), _dino_sd(getattr(jstate, which))
        assert_state_dicts_close(ours, ref, param_tol, f"{which} ")
        if optimizer == "lars":
            _assert_changes_close(ours, ref, init[which], f"{which} ")
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=param_tol)
    moved = n(tstate.student.state_dict()["backbone.blocks.1.temp"]) - init["student"][
        "backbone.blocks.1.temp"]
    assert np.abs(moved).max() > 0


@pytest.mark.parametrize("freeze", [False, True], ids=["finetune", "frozen"])
def test_cls_step_matches_jax(small_xcit, freeze):
    """One SGD ``cls_train_step`` of both packages from JAX's init: loss and
    accuracy, every parameter after (a frozen backbone bit-identical), then
    ``cls_predict``'s logits."""
    common = dict(arch="xcit_small_12", patch_size=8, num_classes=5, compute_dtype="float32",
                  freeze_backbone=freeze)
    jcfg, tcfg = jcls.ClsConfig(**common), tcls.ClsConfig(**common)
    jstate = jcls.init_cls_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = tcls.init_cls_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    bb0 = {k: v.clone() for k, v in tstate.model.state_dict().items() if k.startswith("backbone.")}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, GLOBAL, GLOBAL, 3)).astype(np.float32)
    labels = rng.integers(0, 5, B)
    jstate, jm = jcls.cls_train_step(jstate, jnp.asarray(x), jnp.asarray(labels), jnp.float32(0.05),
                                     jnp.float32(1e-4), jcfg)
    tm = tcls.cls_train_step(tstate, t(x), torch.from_numpy(labels), 0.05, 1e-4, tcfg)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0)
    assert float(tm["acc"]) == float(jm["acc"])
    params = jax.device_get(jstate.params)
    ref = xcit_state_dict(params["backbone"], "backbone.")
    ref.update({f"fc.{k}": np.asarray(v) for k, v in params["fc"].items()})
    assert_state_dicts_close(tstate.model.state_dict(), ref, 5e-4)
    if freeze:
        assert all(torch.equal(tstate.model.state_dict()[k], v) for k, v in bb0.items())
    want = np.asarray(jcls.cls_predict(jstate.params, jstate.bn_state, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(n(tcls.cls_predict(tstate.model, t(x), tcfg)), want,
                               atol=1e-5 * np.abs(want).max())


def test_cli_runs_xcit_on_the_cpu(small_xcit, tmp_path):
    """``train_dino --arch xcit_small_12`` (the two-layer stand-in) at the
    CLI's crops, one image a step, 2 steps: finite losses, an XCiT student,
    and no kernel launched on the CPU (K3 runs its plain version)."""
    args = get_args_parser().parse_args([
        "--device", "cpu", "--arch", "xcit_small_12", "--out_dim", "64",
        "--batch_size_per_gpu", "1", "--local_crops_number", "2", "--num_workers", "1",
        "--image_size", "224", "--max_steps", "2", "--output_dir", str(tmp_path),
    ])
    assert args.patch_size == 8
    _build.LAUNCHES.clear()
    summary = train_dino(args)
    assert len(summary.losses) == 2 and all(math.isfinite(x) for x in summary.losses)
    backbone = summary.state.student["backbone"]
    assert isinstance(backbone, txc.XCiT) and backbone.cfg.patch_size == 8
    assert backbone.cfg.remat and backbone.cfg.remat_policy == "full"
    assert not _build.LAUNCHES


def test_encoder_registry_passes_patch_and_not_the_vit_remat_policy():
    enc = EncoderConfig(arch="xcit_medium_24", patch_size=8, remat_policy="qkv+attn",
                        drop_path_rate=0.1)
    cfg = enc.xcit_config()
    assert (cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.drop_path_rate) == (8, 512, 24, 0.1)
    assert cfg.remat_policy == "full" and enc.embed_dim == 512
    assert enc.is_xcit and not (enc.is_vit or enc.has_bn or enc.supports_packing)
    assert txc.xcit_small_12(8).stem_widths == (96, 192, 384)
    assert txc.xcit_small_12(16).stem_widths == (48, 96, 192, 384)
