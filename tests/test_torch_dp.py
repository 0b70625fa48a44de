"""Data-parallel DINO steps of the port at world size 2 (two gloo CPU
processes, tests/_torch_mp.py) against the JAX package on the same global
batch.

Each rank takes its half of every crop's rows; the JAX package runs
``dino_train_step`` (or ``dino_train_step_accum``) unsharded on the whole
batch, from the same weights (carried across with
``ckpt/from_jax.load_jax_params``), in f32 with exact GELU. Bounds are
tests/test_multiprocess.py's: both ranks report the same loss (atol 0), and
the losses lie within 5e-5 of the single-program run. Under SGD the
parameters are held to rtol 2e-3, atol 2e-5 (tests/test_tp.py's bound);
under AdamW to tests/test_torch_dino_step.py's 5e-4, since AdamW's first
updates are about lr times the sign of the gradient, and the f32
reduction-order noise of the all-reduce flips the sign of near-zero
gradients (tests/test_tp.py:82-93). The convnet
case (``resnet_test``, LARS at lr 0.3, BN in the head) runs 4 rows a rank,
tests/test_torch_accum.py's microbatch: SyncBN makes its batch statistics
the global batch's, and its parameters and running statistics take
tests/test_torch_convnet_step.py's bounds (the one-pass BatchNorm's f32
rounding under LARS's trust ratio, ROADMAP.md queue 3). One group of two
ranks runs every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.train import dino_trainer as ttr
from _torch_mp import start_ranks
from _torch_port import n, one_torch_thread, t  # noqa: F401
import test_torch_convnet_step as conv
import test_torch_dino_step as vit

WORLD, STEPS, EPOCHS, NITER, B = 2, 2, 2, 2, 8
LOCAL_SIZES = (24, 16)


def _vit_cfgs(**kw):
    common = dict(arch="vit_test", patch_size=4, out_dim=128, drop_path_rate=0.0,
                  niter_per_ep=NITER, global_crop_size=32, compute_dtype="float32",
                  gelu_approx=False)
    common.update(kw)
    return jtr.DinoConfig(**common), ttr.DinoConfig(**common)


def _schedules(lr=1e-3, wd=(0.04, 0.4)):
    """tests/_multiproc_common.py's schedules, as (JAX, port, numpy dict)."""
    arrays = dict(
        lr=jsched.cosine_scheduler(lr, 1e-6, EPOCHS, NITER),
        wd=jsched.cosine_scheduler(*wd, EPOCHS, NITER),
        teacher_momentum=jsched.cosine_scheduler(0.996, 1.0, EPOCHS, NITER),
        teacher_temp=jsched.teacher_temp_schedule(0.04, 0.07, 1, EPOCHS),
    )
    return (jtr.DinoSchedules(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            ttr.DinoSchedules(**arrays), arrays)


def _crops(seed, batch, local_sizes=LOCAL_SIZES, size=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        g = rng.standard_normal((2, batch, size, size, 3)).astype(np.float32)
        out.append([g] + [rng.standard_normal((batch, s, s, 3)).astype(np.float32)
                          for s in local_sizes])
    return out


def _jax_run(j0, jcfg, jsch, crops, accum=1):
    """JAX steps from a device copy of the host state ``j0`` (the step
    donates its state)."""
    jstate = jax.tree_util.tree_map(jnp.array, j0)
    losses = []
    for c in crops:
        args = (jstate, jnp.asarray(c[0]), tuple(map(jnp.asarray, c[1:])), jsch, jcfg)
        if accum > 1:
            jstate, m = jtr.dino_train_step_accum(*args, accum=accum)
        else:
            jstate, m = jtr.dino_train_step(*args)
        losses.append(float(m["loss"]))
    return jstate, losses


def _case(tcfg, jstate, arrays, crops, **kw):
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(tstate, jstate)
    return dict(kind="dino", cfg=dataclasses.asdict(tcfg), weights=tstate.student.state_dict(),
                schedules=arrays, crops=crops, **kw)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every case's inputs, the two ranks' results and the JAX references
    (computed while the ranks run)."""
    _, _, arrays = _schedules()
    jcfg, tcfg = _vit_cfgs(optimizer="sgd")
    j0 = jax.device_get(jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg))
    jacfg, tacfg = _vit_cfgs()  # AdamW
    ja = jax.device_get(jtr.init_dino_train_state(jax.random.PRNGKey(0), jacfg))
    _, dcfg = _vit_cfgs(drop_path_rate=0.3, optimizer="sgd")
    jccfg, tccfg = conv._dino_configs(niter_per_ep=NITER)
    jc = jax.device_get(conv._dino_states(jccfg, tccfg)[0])
    _, _, carrays = _schedules(lr=0.3, wd=(1e-6, 1e-6))
    vit_crops = _crops(1, B)
    conv_crops = _crops(2, 4 * WORLD, local_sizes=(16, 16))
    group = start_ranks(WORLD, {
        "vit": _case(tcfg, j0, arrays, vit_crops),
        "vit_accum": _case(tacfg, ja, arrays, vit_crops, accum=2),
        # DropPath on: against the port alone on the global batch
        "vit_droppath": _case(dcfg, j0, arrays, vit_crops),
        "resnet": _case(tccfg, jc, carrays, conv_crops),
    }, tmp_path_factory.mktemp("dp"))

    jsch, tsch, _ = _schedules()
    refs = {"vit": _jax_run(j0, jcfg, jsch, vit_crops),
            "vit_accum": _jax_run(ja, jacfg, jsch, vit_crops, accum=2)}
    tstate = ttr.init_dino_train_state(dcfg, seed=0)
    load_jax_params(tstate, j0)
    refs["vit_droppath"] = tstate, [
        float(ttr.dino_train_step(tstate, t(c[0]), tuple(map(t, c[1:])), tsch, dcfg)["loss"])
        for c in vit_crops]
    refs["resnet"] = _jax_run(jc, jccfg, _schedules(lr=0.3, wd=(1e-6, 1e-6))[0], conv_crops)
    return refs, group.results()


def _check_losses(results, case, ref_losses, atol):
    losses = [r[case]["losses"] for r in results]
    assert len(losses[0]) == STEPS
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=0)
    np.testing.assert_allclose(losses[0], ref_losses, rtol=0, atol=atol)
    for r in results[1:]:  # every rank ends the step with the same state
        assert r[case]["digests"] == results[0][case]["digests"]
        assert torch.equal(r[case]["center"], results[0][case]["center"])


def _check_vit(res, jstate, rtol=2e-3, atol=2e-5):
    for which in ("student", "teacher"):
        ref = vit._sd(getattr(jstate, which))
        ours = res[which]
        assert set(ours) == set(ref)
        for k in sorted(ref):
            np.testing.assert_allclose(n(ours[k]), ref[k], rtol=rtol, atol=atol,
                                       err_msg=f"{which} {k}")
    np.testing.assert_allclose(n(res["center"]), np.asarray(jstate.center), atol=2e-5)


def test_vit_dp_steps_match_jax(world2):
    """Two SGD steps of ``vit_test`` at world 2 (4 rows a rank): the
    global batch's gradients, loss and centre."""
    refs, results = world2
    jstate, ref_losses = refs["vit"]
    _check_losses(results, "vit", ref_losses, 5e-5)
    _check_vit(results[0]["vit"], jstate)
    assert results[0]["vit"]["step"] == STEPS
    assert not any(results[0]["vit"]["placements"].values())


def test_vit_dp_grad_accum_matches_jax(world2):
    """``accum=2`` at world 2 under AdamW: a rank's rows a::2 are its block
    of the global microbatch a (JAX ``dino_train_step_accum`` on the whole
    batch); the gradients are reduced once, after both microbatches."""
    refs, results = world2
    jstate, ref_losses = refs["vit_accum"]
    _check_losses(results, "vit_accum", ref_losses, 5e-5)
    _check_vit(results[0]["vit_accum"], jstate, rtol=0, atol=5e-4)
    assert results[0]["vit_accum"]["step"] == STEPS


def test_vit_dp_droppath_is_the_global_batchs(world2):
    """DropPath at rate 0.3: each rank keeps its rows of the keep-decisions
    one process draws for the global batch, so world 2 computes the
    one-process run."""
    refs, results = world2
    tstate, ref_losses = refs["vit_droppath"]
    _check_losses(results, "vit_droppath", ref_losses, 5e-5)
    ours = results[0]["vit_droppath"]["student"]
    for k, v in tstate.student.state_dict().items():
        np.testing.assert_allclose(n(ours[k]), n(v), rtol=2e-3, atol=2e-5, err_msg=k)


def test_resnet_syncbn_lars_dp_matches_jax(world2):
    """``resnet_test``, LARS and BN in the head at world 2, 4 rows a rank:
    SyncBN gives every BatchNorm (the backbone's, the head's) the global
    batch's moments, so the step, the running statistics (moved alike on
    both ranks) and the centre are the single program's on 8 rows."""
    refs, results = world2
    jstate, ref_losses = refs["resnet"]
    _check_losses(results, "resnet", ref_losses, 5e-5)
    res = results[0]["resnet"]
    for which in ("student", "teacher"):
        ours = conv._without_counts(res[which])
        ref = conv._dino_sd(getattr(jstate, which), getattr(jstate, f"{which}_state"))
        assert set(ours) == set(ref)
        for k in sorted(ref):
            np.testing.assert_allclose(n(ours[k]), ref[k], atol=2e-3, rtol=0,
                                       err_msg=f"{which} {k}")
        # the buffers too are the same on both ranks (_check_losses: digests)
        assert any(k.endswith("running_var") for k in results[1]["resnet"]["digests"][which])
    np.testing.assert_allclose(n(res["center"]), np.asarray(jstate.center), atol=2e-3)
