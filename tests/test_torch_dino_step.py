"""Port DINO step (head, loss, AdamW, trainer) against the JAX package.

Both packages start from the same weights, carried across with
``ckpt/from_jax.load_jax_params`` (or loaded from the torch reference
transcription in tests/_torch_dino.py), and see the same numpy crops, in f32
with exact GELU. Bounds are tests/test_step_oracle.py's: loss 1e-6 and raw
gradients 1e-5 for one forward/backward; per-step loss 1e-5 and parameters
5e-4 after 6 optimizer steps (AdamW moves near-zero-gradient elements by
O(lr) times the sign of float32 reduction-order noise).
"""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt.torch_export import dino_head_state_dict, vit_state_dict
from dinomc_tpu.ckpt.torch_import import dino_head_params_from_torch, vit_params_from_torch
from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.models import dino_head as jhead
from dinomc_tpu.models.encoders import EncoderConfig as JEncoderConfig
from dinomc_tpu.objectives import dino as jdino
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu.train import optim as joptim
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.core import schedules as tsched
from dinomc_tpu_torch.models import dino_head as thead
from dinomc_tpu_torch.models.encoders import EncoderConfig
from dinomc_tpu_torch.objectives import dino as tdino
from dinomc_tpu_torch.train import dino_trainer as ttr
from dinomc_tpu_torch.train import optim as toptim
from _torch_dino import OracleDino, OracleViT, clip_gradients, params_groups
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, NITER, B, GLOBAL = 3, 2, 4, 32
LOCAL_SIZES = (24, 16, 20)  # equal rows: one packed pair + one single


def _configs(**kw):
    common = dict(
        arch="vit_test", patch_size=4, out_dim=64, drop_path_rate=0.0,
        niter_per_ep=NITER, global_crop_size=GLOBAL, compute_dtype="float32",
        gelu_approx=False,
    )
    common.update(kw)
    return jtr.DinoConfig(**common), ttr.DinoConfig(**common)


def _states(jcfg, tcfg):
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    return jstate, tstate


def _crops(rng):
    crops = [rng.standard_normal((B, GLOBAL, GLOBAL, 3)).astype(np.float32) for _ in range(2)]
    crops += [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in LOCAL_SIZES]
    return crops


def _sd(tree):
    """A JAX {'backbone', 'head'} tree in the port's naming and layout."""
    tree = jax.device_get(tree)
    sd = vit_state_dict(tree["backbone"], "backbone.")
    sd.update(dino_head_state_dict(tree["head"], "head."))
    return sd


def _schedules(lr_base=5e-4, wd=(0.04, 0.4)):
    lr = jsched.cosine_scheduler(lr_base, 1e-6, EPOCHS, NITER, warmup_epochs=1)
    wd = jsched.cosine_scheduler(*wd, EPOCHS, NITER)
    mom = jsched.cosine_scheduler(0.996, 1.0, EPOCHS, NITER)
    ttemp = jsched.teacher_temp_schedule(0.04, 0.07, 2, EPOCHS)
    return lr, wd, mom, ttemp


def test_schedules_match_jax():
    for args in ((5e-4, 1e-6, 3, 7, 1), (0.04, 0.4, 2, 5, 0), (0.996, 1.0, 4, 1, 2)):
        np.testing.assert_array_equal(
            tsched.cosine_scheduler(*args), jsched.cosine_scheduler(*args))
    np.testing.assert_array_equal(
        tsched.teacher_temp_schedule(0.04, 0.07, 3, 10),
        jsched.teacher_temp_schedule(0.04, 0.07, 3, 10))
    assert tsched.linear_scaled_lr(5e-4, 64) == jsched.linear_scaled_lr(5e-4, 64)


@pytest.mark.parametrize("norm_last_layer", [True, False])
def test_dino_head_matches_jax(norm_last_layer):
    jcfg = jhead.DINOHeadConfig(in_dim=32, out_dim=64, compute_dtype=jnp.float32,
                                norm_last_layer=norm_last_layer)
    params = jhead.init_dino_head(jax.random.PRNGKey(1), jcfg)
    params["last_layer"]["g"] = params["last_layer"]["g"] * 1.5  # non-unit g
    head = thead.DINOHead(thead.DINOHeadConfig(in_dim=32, out_dim=64, compute_dtype=torch.float32))
    load_jax_params(head, jax.device_get(params))
    x = np.random.default_rng(0).standard_normal((6, 32)).astype(np.float32)
    ref = np.asarray(jhead.dino_head_forward(params, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(n(thead.dino_head_forward(head, t(x))), ref, atol=1e-6)
    assert head.last_layer.weight_g.shape == (64, 1)
    assert head.last_layer.weight_v.shape == (64, 256)


def _bn_head_tree():
    jcfg = jhead.DINOHeadConfig(in_dim=32, out_dim=64, use_bn=True, compute_dtype=jnp.float32)
    return jax.device_get(jhead.init_dino_head(jax.random.PRNGKey(1), jcfg))


def test_head_refuses_bn():
    """The JAX package's head exporter, and so the port's copy of it,
    refuse a BN head's tree. (BN-in-head itself is ported: its parity tests
    are in tests/test_torch_resnet.py.)"""
    from dinomc_tpu.ckpt.torch_export import dino_head_state_dict as jexport_head
    from dinomc_tpu_torch.ckpt.state_dicts import dino_head_state_dict

    params = _bn_head_tree()
    for export in (jexport_head, dino_head_state_dict):
        with pytest.raises(AssertionError, match="BN-in-head"):
            export(params)


def test_bn_head_tree_maps_to_the_reference_names():
    """``ckpt/from_jax.head_state_dict`` maps a BN head's tree by hand, to
    the port's head's names (the reference's shifted indices)."""
    from dinomc_tpu_torch.ckpt.from_jax import head_state_dict

    params = _bn_head_tree()
    head = thead.DINOHead(thead.DINOHeadConfig(in_dim=32, out_dim=64, use_bn=True))
    assert set(head_state_dict(params)) == set(head.state_dict())


def test_dino_loss_and_center_match_jax():
    rng = np.random.default_rng(2)
    student = rng.standard_normal((5, 3, 64)).astype(np.float32)
    teacher = rng.standard_normal((2, 3, 64)).astype(np.float32)
    center = rng.standard_normal((64,)).astype(np.float32) * 0.1
    lj, cj = jdino.dino_loss(jnp.asarray(student), jnp.asarray(teacher), jnp.asarray(center), 0.05)
    st = t(student).requires_grad_()
    lt, ct = tdino.dino_loss(st, t(teacher), t(center), 0.05)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=1e-6)
    np.testing.assert_allclose(n(ct), np.asarray(cj), atol=1e-7)
    gj = jax.grad(lambda s: jdino.dino_loss(s, jnp.asarray(teacher), jnp.asarray(center), 0.05)[0])(
        jnp.asarray(student))
    lt.backward()
    np.testing.assert_allclose(n(st.grad), np.asarray(gj), atol=1e-6)


def test_adamw_with_frozen_mask_matches_jax():
    """Per-leaf step counts and the frozen skip (value, moments, count
    untouched), over steps where the frozen set changes."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (4,), "c": (2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    wd_m = {"a": 1.0, "b": 0.0, "c": 1.0}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = joptim.adamw_init(jp)
    tp = {k: t(v) for k, v in p0.items()}
    ts = toptim.adamw_init(tp)
    frozen_seq = [{"a": 1.0, "b": 0.0, "c": 0.0}, {"a": 1.0, "b": 1.0, "c": 0.0},
                  {"a": 0.0, "b": 0.0, "c": 0.0}, {"a": 0.0, "b": 0.0, "c": 1.0}]
    for i, frozen in enumerate(frozen_seq):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        lr, wd = 1e-2 * (i + 1), 0.05
        jp, js = joptim.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.float32(lr),
            jnp.float32(wd), {k: jnp.float32(v) for k, v in wd_m.items()},
            frozen_mask={k: jnp.float32(v) for k, v in frozen.items()},
        )
        toptim.adamw_update({k: t(v) for k, v in g.items()}, ts, tp, lr, wd, wd_m,
                            frozen_mask=frozen)
    for k in shapes:
        np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]), atol=1e-6)
        np.testing.assert_allclose(n(ts["mu"][k]), np.asarray(js["mu"][k]), atol=1e-7)
        np.testing.assert_allclose(n(ts["nu"][k]), np.asarray(js["nu"][k]), atol=1e-7)
        assert ts["count"][k] == int(js["count"][k])


def test_clip_gradients_per_tensor_matches_jax():
    rng = np.random.default_rng(4)
    g = {"x": rng.standard_normal((5, 5)).astype(np.float32) * 3,
         "y": rng.standard_normal((7,)).astype(np.float32) * 1e-3}
    ref = joptim.clip_gradients_per_tensor({k: jnp.asarray(v) for k, v in g.items()}, 3.0)
    out = toptim.clip_gradients_per_tensor({k: t(v) for k, v in g.items()}, 3.0)
    for k in g:
        np.testing.assert_allclose(n(out[k]), np.asarray(ref[k]), atol=1e-6)


def test_masks_follow_reference_groups():
    _, tcfg = _configs()
    st = ttr.init_dino_train_state(tcfg, 0)
    params = dict(st.student.named_parameters())
    wd_m, last, frozen = ttr._masks(tcfg, params)
    assert wd_m["head.last_layer.weight_g"] == 1.0  # (out, 1): decayed, as in the reference
    assert wd_m["backbone.blocks.0.attn.qkv.bias"] == 0.0
    assert wd_m["backbone.norm.weight"] == 0.0
    assert wd_m["backbone.blocks.0.norm1.weight"] == 1.0  # a row of JAX's (depth, D) leaf
    assert wd_m["backbone.pos_embed"] == 1.0
    assert {k for k, v in last.items() if v} == {"head.last_layer.weight_g", "head.last_layer.weight_v"}
    assert {k for k, v in frozen.items() if v} == {"head.last_layer.weight_g"}


def test_plan_packing_bench_sizes():
    """The bench multi-crop sizes at patch 8 pack as in the JAX package:
    (184, 84), (164, 124), (144, 104), larger segment first."""
    enc_t = EncoderConfig(arch="vit_small", patch_size=8)
    enc_j = JEncoderConfig(arch="vit_small", patch_size=8)
    sizes = [184, 164, 144, 124, 104, 84]
    pairs, singles = ttr._plan_packing(
        [(s, torch.zeros(4, s, s, 3), [i]) for i, s in enumerate(sizes)], enc_t)
    jpairs, _ = jtr._plan_packing(
        [(s, jnp.zeros((4, s, s, 3)), [i]) for i, s in enumerate(sizes)], enc_j)
    assert not singles
    got = sorted((a[0], b[0]) for a, b in pairs)
    assert got == [(144, 104), (164, 124), (184, 84)]
    assert got == sorted((a[0], b[0]) for a, b in jpairs)
    assert all(a[0] > b[0] for a, b in pairs)


def test_non_vit_encoders_name_their_roadmap_item():
    """Swin-T, the convnets and XCiT are ported: XCiT registers its two
    widths, has no BatchNorm state, packs no crops (``_plan_packing`` leaves
    every bucket single) and takes ``patch_size``."""
    assert EncoderConfig(arch="resnet50").has_bn and not EncoderConfig(arch="swin_t").has_bn
    for arch, width in (("xcit_small_12", 384), ("xcit_medium_24", 512)):
        enc = EncoderConfig(arch=arch, patch_size=8)
        assert enc.embed_dim == width and enc.xcit_config().patch_size == 8
        assert not (enc.has_bn or enc.supports_packing)
        work = [(s, torch.zeros(4, s, s, 3), [i]) for i, s in enumerate((96, 84))]
        assert ttr._plan_packing(work, enc) == ([], work)
    with pytest.raises(ValueError, match="unknown encoder"):
        EncoderConfig(arch="xcit_tiny")


def test_loss_and_grads_match_jax():
    """One forward/backward over the multi-crop stack, before any optimizer
    state: every student gradient (g too: norm_last_layer=False)."""
    jcfg, tcfg = _configs(norm_last_layer=False, freeze_last_layer=0)
    jstate, tstate = _states(jcfg, tcfg)
    crops = _crops(np.random.default_rng(3))
    lj, gj, cj, _, _ = jax.jit(jtr.dino_loss_and_grads, static_argnames=("cfg",))(
        jstate, jnp.asarray(np.stack(crops[:2])), tuple(map(jnp.asarray, crops[2:])),
        jnp.float32(0.04), jax.random.PRNGKey(1), jcfg,
    )
    lt, gt, ct = ttr.dino_loss_and_grads(
        tstate, t(np.stack(crops[:2])), tuple(map(t, crops[2:])), 0.04, tstate.generator, tcfg)
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-6, rtol=0)
    assert_state_dicts_close(gt, _sd(gj), atol=1e-5, what="grad ")
    np.testing.assert_allclose(n(ct), np.asarray(cj), atol=1e-7)


def _oracle_states(jcfg, tcfg):
    """The torch reference transcription (tests/_torch_dino.py) with its own
    initialization, as tests/test_step_oracle.py runs it, and the JAX and
    port states loaded from its weights."""
    oracle = OracleDino(OracleViT, embed_dim=32, out_dim=64, optimizer="adamw")
    sd = {k: v.detach().clone() for k, v in oracle.state_dicts().items()}
    # the reference ViT's position grid is 4x4 (16 px), interpolated to the
    # crops, as in test_step_oracle.py; the port's module takes that shape
    tstate = ttr.init_dino_train_state(dataclasses.replace(tcfg, global_crop_size=16), seed=0)
    tstate.student.load_state_dict(sd, strict=True)
    tstate.teacher.load_state_dict(sd, strict=True)
    bb = {k[len("backbone."):]: v.numpy() for k, v in sd.items() if k.startswith("backbone.")}
    hd = {k[len("head."):]: v.numpy() for k, v in sd.items() if k.startswith("head.")}
    student = {
        "backbone": jax.tree_util.tree_map(jnp.asarray, vit_params_from_torch(bb, depth=3)),
        "head": jax.tree_util.tree_map(jnp.asarray, dino_head_params_from_torch(hd)),
    }
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg).replace(
        student=student, teacher=jax.tree_util.tree_map(jnp.copy, student),
        opt_state=joptim.adamw_init(student),
    )
    return oracle, jstate, tstate


def _run_six_steps(jstate, tstate, jcfg, tcfg, schedules, oracle=None):
    """6 steps of both packages' ``dino_train_step`` (and of the reference
    transcription when given), losses held together at every step."""
    lr, wd, mom, ttemp = schedules
    jsch = jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                             teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp))
    tsch = ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp)
    rng = np.random.default_rng(7)
    for it in range(EPOCHS * NITER):
        epoch = it // NITER
        crops = _crops(rng)
        jstate, jm = jtr.dino_train_step(
            jstate, jnp.asarray(np.stack(crops[:2])), tuple(map(jnp.asarray, crops[2:])), jsch, jcfg)
        tm = ttr.dino_train_step(tstate, t(np.stack(crops[:2])), tuple(map(t, crops[2:])), tsch, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0,
                                   err_msg=f"loss against JAX at step {it}")
        if oracle is not None:
            loss_ref = oracle.step(crops, it, epoch, float(lr[it]), float(wd[it]), float(mom[it]),
                                   float(ttemp[epoch]))
            np.testing.assert_allclose(float(tm["loss"]), loss_ref, atol=1e-5, rtol=0,
                                       err_msg=f"loss against the reference at step {it}")
    assert tstate.step == int(jstate.step) == EPOCHS * NITER
    assert_state_dicts_close(tstate.student.state_dict(), _sd(jstate.student), 5e-4, "student ")
    assert_state_dicts_close(tstate.teacher.state_dict(), _sd(jstate.teacher), 5e-4, "teacher ")
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=5e-4)
    # g stayed frozen at 1 (norm_last_layer), its step count at 0
    assert torch.equal(tstate.student["head"].last_layer.weight_g, torch.ones(64, 1))
    assert tstate.opt_state["count"]["head.last_layer.weight_g"] == 0
    assert tstate.opt_state["count"]["head.last_layer.weight_v"] == EPOCHS * NITER - NITER
    return jstate


def test_six_steps_match_jax_and_reference():
    """dino_train_step, 6 steps over 3 epochs (lr warmup, the last-layer
    freeze in epoch 0, frozen g, clipping, the EMA teacher, the centre)
    against JAX ``dino_train_step`` and against the torch reference
    transcription, from the reference's own initialization.

    The reference differs from both packages in two rules of the JAX
    package's stacked blocks (test_clip_and_decay_groups_are_the_references):
    it clips each block's tensor on its own and leaves the blocks' LayerNorm
    scales undecayed. From this initialization at the reference's lr, both
    stay below the 5e-4 bound, as in tests/test_step_oracle.py; the case
    from the JAX package's initialization below is where they show."""
    jcfg, tcfg = _configs(clip_grad=3.0, freeze_last_layer=1)
    oracle, jstate, tstate = _oracle_states(jcfg, tcfg)
    _run_six_steps(jstate, tstate, jcfg, tcfg, _schedules(), oracle)
    for which in ("student", "teacher"):
        ref = {k: v.numpy() for k, v in oracle.state_dicts(which).items()}
        assert_state_dicts_close(getattr(tstate, which).state_dict(), ref, 5e-4, f"{which} ")
    np.testing.assert_allclose(n(tstate.center), oracle.center.numpy().reshape(-1), atol=5e-4)


def test_six_steps_match_jax_from_its_init():
    """The same 6 steps from the JAX package's own trunc-normal(0.02)
    initialization, with clipping at 3.0 engaged on stacked block leaves
    and a weight decay of 4 that moves the blocks' LayerNorm scales by about
    1.4e-3: clipping per block, or leaving those scales undecayed, breaks
    the 5e-4 parameter bound. The lr of 1e-4 keeps AdamW's O(lr) response
    to float32 reduction-order noise in near-zero gradients well inside the
    loss bound of 1e-5."""
    jcfg, tcfg = _configs(clip_grad=3.0, freeze_last_layer=1)
    jstate, tstate = _states(jcfg, tcfg)
    crops = _crops(np.random.default_rng(7))  # the first step's crops
    _, gj, _, _, _ = jax.jit(jtr.dino_loss_and_grads, static_argnames=("cfg",))(
        jstate, jnp.asarray(np.stack(crops[:2])), tuple(map(jnp.asarray, crops[2:])),
        jnp.float32(0.04), jax.random.PRNGKey(1), jcfg,
    )
    blocks = jax.tree_util.tree_leaves(jax.tree_util.tree_map(jnp.linalg.norm, gj["backbone"]["blocks"]))
    assert max(float(x) for x in blocks) > 3.0, "clipping never engages on a block leaf"
    ln0 = {k: v.clone() for k, v in tstate.student.state_dict().items() if ".norm" in k}
    _run_six_steps(jstate, tstate, jcfg, tcfg, _schedules(lr_base=1e-4, wd=(4.0, 4.0)))
    moved = max((tstate.student.state_dict()[k] - v).abs().max().item()
                for k, v in ln0.items() if k.startswith("backbone.blocks.") and k.endswith("weight"))
    assert moved > 1e-3


def test_three_sgd_steps_match_jax():
    """``optimizer='sgd'`` (momentum 0.9): 3 steps of both packages'
    ``dino_train_step`` from the JAX package's init, over the last-layer
    freeze of epoch 0 and its end, at the bounds above."""
    jcfg, tcfg = _configs(optimizer="sgd", clip_grad=3.0, freeze_last_layer=1)
    jstate, tstate = _states(jcfg, tcfg)
    assert set(tstate.opt_state) == {"mu"}
    lr, wd, mom, ttemp = _schedules(lr_base=1e-2)
    jsch = jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                             teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp))
    tsch = ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp)
    rng = np.random.default_rng(11)
    for it in range(3):
        crops = _crops(rng)
        jstate, jm = jtr.dino_train_step(
            jstate, jnp.asarray(np.stack(crops[:2])), tuple(map(jnp.asarray, crops[2:])), jsch, jcfg)
        tm = ttr.dino_train_step(tstate, t(np.stack(crops[:2])), tuple(map(t, crops[2:])), tsch, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0,
                                   err_msg=f"loss at step {it}")
    assert_state_dicts_close(tstate.student.state_dict(), _sd(jstate.student), 5e-4, "student ")
    assert_state_dicts_close(tstate.teacher.state_dict(), _sd(jstate.teacher), 5e-4, "teacher ")
    assert torch.equal(tstate.student["head"].last_layer.weight_g, torch.ones(64, 1))
    assert float(tstate.opt_state["mu"]["head.last_layer.weight_v"].abs().max()) > 0


def test_clip_and_decay_groups_are_the_references():
    """The port's weight-decay groups and clip are the JAX package's, which
    apply both rules to its stacked (depth, ...) block leaves: all blocks'
    copies of a tensor clip by their joint norm, and the blocks' LayerNorm
    scales are decayed. Held against JAX ``_masks`` and
    ``clip_gradients_per_tensor`` on the JAX tree, mapped to the port's
    names; the reference's per-layer rules (tests/_torch_dino.py) differ."""
    jcfg, tcfg = _configs()
    jstate, tstate = _states(jcfg, tcfg)
    params = dict(tstate.student.named_parameters())
    jstudent = jax.device_get(jstate.student)
    as_tensors = lambda tree: {k: t(v) for k, v in _sd(tree).items()}  # noqa: E731

    jwd = jtr._masks(jcfg, jstudent)[0]
    jwd = as_tensors(jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32), jwd, jstudent))
    wd_m = ttr._masks(tcfg, params)[0]
    assert set(wd_m) == set(jwd)
    for k, m in wd_m.items():
        assert torch.all(jwd[k] == m), k
    assert wd_m["backbone.blocks.1.norm1.weight"] == 1.0
    _, not_reg = params_groups(tstate.student)  # the reference leaves it undecayed
    assert any(p is params["backbone.blocks.1.norm1.weight"] for p in not_reg["params"])

    rng = np.random.default_rng(5)
    jgrads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.5, jstudent)
    ref = as_tensors(joptim.clip_gradients_per_tensor(jgrads, 3.0))
    grads = as_tensors(jgrads)
    before = grads["backbone.blocks.0.attn.qkv.weight"].clone()
    toptim.clip_gradients_per_tensor(grads, 3.0)
    for k in ref:
        np.testing.assert_allclose(n(grads[k]), n(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    # the joint norm of the 3 blocks' qkv weights is above 3: clipping engaged
    assert grads["backbone.blocks.0.attn.qkv.weight"].abs().max() < before.abs().max()

    # the reference's per-layer clip gives another result for a block tensor
    model = copy.deepcopy(tstate.student)
    for k, p in model.named_parameters():
        p.grad = as_tensors(jgrads)[k].clone()
    clip_gradients(model, 3.0)
    g_ref = dict(model.named_parameters())["backbone.blocks.0.attn.qkv.weight"].grad
    assert not torch.allclose(g_ref, grads["backbone.blocks.0.attn.qkv.weight"], atol=1e-4)


def test_package_never_imports_jax():
    """Every dinomc_tpu_torch module, and chip_smoke.py, import without jax
    and without any module of the JAX package, jax-free ones included."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dinomc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dinomc_tpu_torch.__path__, "
        "'dinomc_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'dinomc_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
