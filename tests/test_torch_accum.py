"""Port gradient accumulation (``train/dino_trainer.dino_train_step_accum``
and ``train_dino --grad_accum_steps``) against the JAX package.

Both packages start from the JAX package's weights and see the same numpy
crops in f32 on the CPU; microbatch ``a`` takes rows ``a::A`` in both. Bounds
against JAX ``dino_train_step_accum`` over 3 steps at A = 2:
tests/test_torch_dino_step.py's for the ViT under AdamW (loss 1e-5 a step,
parameters and centre 5e-4), tests/test_torch_xcit.py's for the two-layer
XCiT, and tests/test_torch_convnet_step.py's for ``resnet_test`` with LARS
and BN in the head (loss 5e-5, parameters, running statistics and centre
2e-3, each leaf's change from the init within 1e-2 of JAX's largest). The
port's A = 2 step against its own big-batch step is held to
tests/test_dino_train_step.py::test_grad_accum_matches_big_batch's bounds
(loss and centre rtol 1e-5, parameters rtol 2e-4 atol 2e-6).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.train import dino_trainer as ttr
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401
import test_torch_convnet_step as conv
import test_torch_dino_step as vit
import test_torch_xcit as xcit

A = 2
STEPS = 3
small_xcit = xcit.small_xcit  # the two-layer XCiT fixture


def _jax_and_port_schedules(lr, wd, epochs, niter):
    mom = jsched.cosine_scheduler(0.996, 1.0, epochs, niter)
    ttemp = jsched.teacher_temp_schedule(0.04, 0.07, 2, epochs)
    return (jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                              teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp)),
            ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp))


def _accum_steps_both(jstate, tstate, jcfg, tcfg, schedules, crops_fn, loss_tol):
    """``STEPS`` accumulated steps of both packages on the same crops, the
    loss held at every step. Returns the JAX state."""
    jsch, tsch = schedules
    rng = np.random.default_rng(13)
    for it in range(STEPS):
        crops = crops_fn(rng)
        g, locals_ = np.stack(crops[:2]), crops[2:]
        jstate, jm = jtr.dino_train_step_accum(
            jstate, jnp.asarray(g), tuple(map(jnp.asarray, locals_)), jsch, jcfg, accum=A)
        tm = ttr.dino_train_step_accum(tstate, t(g), tuple(map(t, locals_)), tsch, tcfg, accum=A)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=loss_tol, rtol=0,
                                   err_msg=f"loss at step {it}")
    assert tstate.step == int(jstate.step) == STEPS
    return jstate


def test_vit_adamw_accum_matches_jax():
    """ViT (``vit_test``, packed local pairs) under AdamW, across the
    last-layer freeze of epoch 0 and its end, clipping engaged."""
    jcfg, tcfg = vit._configs(clip_grad=3.0, freeze_last_layer=1)
    jstate, tstate = vit._states(jcfg, tcfg)
    lr, wd, _, _ = vit._schedules()
    jstate = _accum_steps_both(jstate, tstate, jcfg, tcfg,
                               _jax_and_port_schedules(lr, wd, vit.EPOCHS, vit.NITER),
                               vit._crops, 1e-5)
    assert_state_dicts_close(tstate.student.state_dict(), vit._sd(jstate.student), 5e-4, "student ")
    assert_state_dicts_close(tstate.teacher.state_dict(), vit._sd(jstate.teacher), 5e-4, "teacher ")
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=5e-4)
    assert tstate.opt_state["count"]["head.last_layer.weight_v"] == STEPS - vit.NITER


def _resnet_crops(rng, B=2 * conv.B):
    """tests/test_torch_convnet_step.py's crops at twice its batch, so that
    each microbatch's BatchNorms see that file's batch of 4. Microbatches of
    2 leave the head's BatchNorm 4 rows of teacher globals: its f32 rounding
    then moves the loss by ~3e-5 before any update (the same weights and
    crops), and LARS at lr 0.3 grows that past 1e-3 by the third step."""
    crops = [rng.standard_normal((B, conv.GLOBAL, conv.GLOBAL, 3)).astype(np.float32)
             for _ in range(2)]
    return crops + [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in conv.LOCAL_SIZES]


def test_resnet_lars_bn_head_accum_matches_jax():
    """``resnet_test`` with LARS and BN in the head at lr 0.3: the
    BatchNorm statistics move a microbatch at a time, teacher then student
    (globals, then each local bucket), as the JAX scan threads them, so
    ``num_batches_tracked`` rises A times a step in the teacher and A times a
    bucket a step in the student. Held to that file's loss (5e-5) and
    parameter, statistics and centre (2e-3) bounds; not to its check of each
    leaf's change from the init (1e-2 of JAX's largest), which is fitted to
    its own batch of 4: at this batch of 8 the plain ``dino_train_step``
    misses it 8-fold as well, and one accumulated step at lr 0.3 3-fold."""
    jcfg, tcfg = conv._dino_configs()
    jstate, tstate = conv._dino_states(jcfg, tcfg)
    lr = jsched.cosine_scheduler(0.3, 1e-6, conv.EPOCHS, conv.NITER, warmup_epochs=1)
    wd = jsched.cosine_scheduler(1e-6, 1e-6, conv.EPOCHS, conv.NITER)
    jstate = _accum_steps_both(jstate, tstate, jcfg, tcfg,
                               _jax_and_port_schedules(lr, wd, conv.EPOCHS, conv.NITER),
                               _resnet_crops, 5e-5)
    for which in ("student", "teacher"):
        ours = getattr(tstate, which).state_dict()
        ref = conv._dino_sd(getattr(jstate, which), getattr(jstate, f"{which}_state"))
        assert_state_dicts_close(conv._without_counts(ours), ref, 2e-3, f"{which} ")
        buckets = 1 + len(set(conv.LOCAL_SIZES)) if which == "student" else 1
        assert {int(v) for k, v in ours.items() if k.endswith("num_batches_tracked")} == {
            STEPS * A * buckets}
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=2e-3)


def test_xcit_accum_matches_jax(small_xcit):
    """The two-layer XCiT under AdamW: its LPI BatchNorm reads each
    microbatch's statistics in both packages."""
    common = dict(arch="xcit_small_12", patch_size=8, out_dim=64, drop_path_rate=0.0,
                  niter_per_ep=xcit.NITER, global_crop_size=xcit.GLOBAL,
                  compute_dtype="float32", gelu_approx=False)
    jcfg, tcfg = jtr.DinoConfig(**common), ttr.DinoConfig(**common)
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    lr = jsched.cosine_scheduler(5e-4, 1e-6, xcit.EPOCHS, xcit.NITER, warmup_epochs=1)
    wd = jsched.cosine_scheduler(0.04, 0.4, xcit.EPOCHS, xcit.NITER)
    jstate = _accum_steps_both(jstate, tstate, jcfg, tcfg,
                               _jax_and_port_schedules(lr, wd, xcit.EPOCHS, xcit.NITER),
                               xcit._crops, 1e-5)
    for which in ("student", "teacher"):
        assert_state_dicts_close(getattr(tstate, which).state_dict(),
                                 xcit._dino_sd(getattr(jstate, which)), 5e-4, f"{which} ")
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=5e-4)



def _sgd_big_batch_setup(B=8):
    """The port's ViT at f32, SGD, no DropPath, a warm-up-free lr so the
    parameters move, and 2 steps of B-sample crops."""
    _, tcfg = vit._configs(optimizer="sgd", drop_path_rate=0.0, clip_grad=3.0,
                           freeze_last_layer=0)
    lr = jsched.cosine_scheduler(1e-2, 1e-6, vit.EPOCHS, vit.NITER)
    wd = jsched.cosine_scheduler(0.04, 0.4, vit.EPOCHS, vit.NITER)
    sch = _jax_and_port_schedules(lr, wd, vit.EPOCHS, vit.NITER)[1]
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(2):
        crops = [rng.standard_normal((B, vit.GLOBAL, vit.GLOBAL, 3)).astype(np.float32)
                 for _ in range(2)]
        crops += [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in vit.LOCAL_SIZES]
        batches.append((t(np.stack(crops[:2])), tuple(map(t, crops[2:]))))
    return tcfg, sch, batches


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_matches_the_ports_big_batch_step(accum):
    """A microbatches of B / A against one step on the full batch of 8 from
    the same weights: SGD and no DropPath make the gradient linear in the
    batch; the averaged microbatch gradients, the averaged teacher centre
    and one optimizer and EMA step reproduce the big-batch step."""
    tcfg, sch, batches = _sgd_big_batch_setup()
    big = ttr.init_dino_train_state(tcfg, seed=0)
    acc = ttr.init_dino_train_state(tcfg, seed=0)
    for g, locals_ in batches:
        m_big = ttr.dino_train_step(big, g, locals_, sch, tcfg)
        m_acc = ttr.dino_train_step_accum(acc, g, locals_, sch, tcfg, accum=accum)
        np.testing.assert_allclose(float(m_acc["loss"]), float(m_big["loss"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(n(acc.center), n(big.center), rtol=1e-5, atol=1e-6)
    assert acc.step == big.step == 2
    moved = 0.0
    for (k, a), b, p0 in zip(acc.student.state_dict().items(), big.student.state_dict().values(),
                             ttr.init_dino_train_state(tcfg, seed=0).student.state_dict().values()):
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-6, err_msg=k)
        moved = max(moved, float((b - p0).abs().max()))
    assert moved > 1e-4  # the parameters did move


def test_accum_of_one_is_the_plain_step_bit_for_bit():
    """``accum=1`` takes the whole batch as one microbatch: parameters,
    optimizer buffers, teacher, centre and loss equal ``dino_train_step``'s
    bit for bit."""
    tcfg, sch, batches = _sgd_big_batch_setup(B=4)
    tcfg = dataclasses.replace(tcfg, optimizer="adamw", drop_path_rate=0.1)
    one = ttr.init_dino_train_state(tcfg, seed=0)
    plain = ttr.init_dino_train_state(tcfg, seed=0)
    for g, locals_ in batches:
        m1 = ttr.dino_train_step_accum(one, g, locals_, sch, tcfg, accum=1)
        m0 = ttr.dino_train_step(plain, g, locals_, sch, tcfg)
        assert torch.equal(m1["loss"], m0["loss"])
    for which in ("student", "teacher"):
        a, b = getattr(one, which).state_dict(), getattr(plain, which).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b), which
    assert all(torch.equal(one.opt_state["mu"][k], v) for k, v in plain.opt_state["mu"].items())
    assert torch.equal(one.center, plain.center)


def test_accum_draws_drop_path_per_microbatch():
    """With DropPath on, microbatch ``a`` draws its masks from
    ``state.generator`` after microbatch ``a - 1``'s: A = 2 steps from the
    same seed are reproducible, and differ from the big-batch step, which
    draws once for all rows."""
    tcfg, sch, batches = _sgd_big_batch_setup(B=4)
    tcfg = dataclasses.replace(tcfg, drop_path_rate=0.5)
    g, locals_ = batches[0]
    losses = []
    for step in (ttr.dino_train_step_accum, ttr.dino_train_step_accum, ttr.dino_train_step):
        state = ttr.init_dino_train_state(tcfg, seed=0)
        losses.append(float(step(state, g, locals_, sch, tcfg, **(
            {"accum": 2} if step is ttr.dino_train_step_accum else {}))["loss"]))
    assert losses[0] == losses[1] and losses[0] != losses[2]


def test_accum_must_divide_the_batch():
    tcfg, sch, batches = _sgd_big_batch_setup(B=4)
    state = ttr.init_dino_train_state(tcfg, seed=0)
    with pytest.raises(ValueError, match="must divide batch 4"):
        ttr.dino_train_step_accum(state, *batches[0], sch, tcfg, accum=3)
    assert state.step == 0


SMOKE = [
    "--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--out_dim", "128",
    "--epochs", "1", "--max_steps", "1", "--local_crops_number", "2", "--size_crops", "96", "64",
    "--warmup_epochs", "0", "--image_size", "128", "--print_freq", "1", "--num_workers", "1",
]


def test_cli_grad_accum_runs_one_accumulated_step(tmp_path, monkeypatch):
    """``train_dino --grad_accum_steps 2`` (JAX tests/test_cli_smoke.py's
    case): one step through ``dino_train_step_accum`` with accum 2 and
    never the plain step; a finite loss."""
    calls = []
    real = ttr.dino_train_step_accum

    def spy(*args, **kwargs):
        calls.append(kwargs["accum"])
        return real(*args, **kwargs)

    monkeypatch.setattr(ttr, "dino_train_step_accum", spy)
    monkeypatch.setattr(ttr, "dino_train_step", None)
    out = train_dino(get_args_parser().parse_args(
        SMOKE + ["--batch_size_per_gpu", "2", "--grad_accum_steps", "2",
                 "--output_dir", str(tmp_path)]))
    assert calls == [2]
    assert len(out.losses) == 1 and math.isfinite(out.losses[0])


def test_cli_grad_accum_must_divide_the_batch(tmp_path):
    with pytest.raises(AssertionError, match="grad_accum_steps=3 must divide batch_size_per_gpu=2"):
        train_dino(get_args_parser().parse_args(
            SMOKE + ["--batch_size_per_gpu", "2", "--grad_accum_steps", "3",
                     "--output_dir", str(tmp_path)]))
