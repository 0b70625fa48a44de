"""Head tensor parallelism, ZeRO sharding and checkpoint resume of the
port's DINO step on gloo CPU process groups (tests/_torch_mp.py), against
the JAX package on the same global batch.

The configuration is tests/test_tp.py's ``_tiny_cfg`` (``vit_tiny``, patch
8, out_dim 512, 32 px crops, no DropPath), in f32 with exact GELU, from the
JAX package's weights; the global batch is 8 rows, split over every rank.
TP runs at world 4 (data 2 x model 2): each rank holds half of out_dim of
the last layer, its moments and the centre. ZeRO runs at world 2 (data 2).
As in tests/test_tp.py, trajectories are compared under SGD (the ~1e-7
reduction-order noise of the collectives flips AdamW's first updates,
tests/test_tp.py:82-93), with its bounds: losses rtol/atol 2e-4, the last
layer's ``weight_v`` (or fc1's weights) rtol 2e-3, atol 2e-5, the centre
atol 2e-4; AdamW is held to its first loss (rtol 1e-5). Resume continuity
is tests/test_tp.py:195-230's: a run checkpointed after one step and
restored into a state from another seed equals the uninterrupted run
(rtol 1e-6, atol 1e-7); the world-4 checkpoint also resumes in one process.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.train import dino_trainer as ttr
from _torch_mp import start_ranks
from _torch_port import n, one_torch_thread, t  # noqa: F401
import test_torch_dino_step as vit

B, STEPS, EPOCHS, NITER = 8, 2, 2, 2
V = "head.last_layer.weight_v"
QKV = "backbone.blocks.0.attn.qkv.weight"


def _cfgs(**kw):
    common = dict(arch="vit_tiny", patch_size=8, out_dim=512, niter_per_ep=NITER,
                  global_crop_size=32, drop_path_rate=0.0, compute_dtype="float32",
                  gelu_approx=False)
    common.update(kw)
    return jtr.DinoConfig(**common), ttr.DinoConfig(**common)


def _arrays():
    """tests/test_tp.py's schedules."""
    return dict(
        lr=jsched.cosine_scheduler(1e-3, 1e-6, EPOCHS, NITER),
        wd=jsched.cosine_scheduler(0.04, 0.4, EPOCHS, NITER),
        teacher_momentum=jsched.cosine_scheduler(0.996, 1.0, EPOCHS, NITER),
        teacher_temp=jsched.teacher_temp_schedule(0.04, 0.07, 1, EPOCHS),
    )


def _crops():
    """tests/test_tp.py's batch: two 32 px globals, 24 and 16 px locals."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        g = rng.standard_normal((2, B, 32, 32, 3)).astype(np.float32)
        out.append([g] + [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in (24, 16)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = _cfgs(optimizer="sgd")
    _, tacfg = _cfgs()  # AdamW
    j0 = jax.device_get(jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg))
    port = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(port, j0)
    weights = port.student.state_dict()
    crops, arrays = _crops(), _arrays()
    tmp = tmp_path_factory.mktemp("tp")
    ckpt_dir = str(tmp / "ckpt")

    def case(cfg, **kw):
        return dict(dict(kind="dino", cfg=dataclasses.asdict(cfg), weights=weights,
                         schedules=arrays, crops=crops), **kw)

    fc1 = [f"backbone.blocks.{i}.mlp.fc1.weight" for i in range(12)]
    world4 = start_ranks(4, {
        "tp_sgd": case(tcfg, model=2, keep=[V]),
        "tp_adam": case(tacfg, model=2),
        "tp_resume": case(tacfg, model=2, resume_at=1, ckpt_dir=ckpt_dir, keep=[V]),
    }, tmp)
    world2 = start_ranks(2, {
        "zero_sgd": case(tcfg, fsdp=True, keep=fc1),
        "whole": case(tcfg, crops=crops[:1], keep=[]),
    }, tmp)

    jstate = jax.tree_util.tree_map(jnp.array, j0)
    jsch = jtr.DinoSchedules(**{k: jnp.asarray(v) for k, v in arrays.items()})
    losses = []
    for c in crops:
        jstate, m = jtr.dino_train_step(jstate, jnp.asarray(c[0]), tuple(map(jnp.asarray, c[1:])),
                                        jsch, jcfg)
        losses.append(float(m["loss"]))
    yield dict(jax=(jstate, losses), world4=world4.results(), world2=world2.results(),
               ckpt_dir=ckpt_dir, tacfg=tacfg, crops=crops, arrays=arrays)
    shutil.rmtree(tmp)  # the checkpoint


def _same_on_every_rank(results, case):
    for r in results[1:]:
        np.testing.assert_array_equal(r[case]["losses"], results[0][case]["losses"])
        assert r[case]["digests"] == results[0][case]["digests"]
        assert torch.equal(r[case]["center"], results[0][case]["center"])


def test_tp_head_matches_jax(runs):
    """World 4 = data 2 x model 2, SGD: the last layer, its momentum and the
    centre split on out_dim over the model axis; two steps equal JAX's
    single-program steps, and every rank ends them with the full state."""
    jstate, jlosses = runs["jax"]
    res = runs["world4"]
    _same_on_every_rank(res, "tp_sgd")
    ours = res[0]["tp_sgd"]
    assert ours["placements"][V] == ("model", 0)
    assert ours["placements"]["head.last_layer.weight_g"] == ("model", 0)
    assert ours["moment_shapes"][V] == (256, 256)  # (512 / 2, bottleneck)
    assert not any(p for k, p in ours["placements"].items() if "last_layer" not in k)
    np.testing.assert_allclose(ours["losses"], jlosses, rtol=2e-4, atol=2e-4)
    v_ref = vit._sd(jstate.student)[V]
    np.testing.assert_allclose(n(ours["student"][V]), v_ref, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(n(ours["teacher"][V]), vit._sd(jstate.teacher)[V],
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(n(ours["center"]), np.asarray(jstate.center), atol=2e-4)


def test_tp_adam_step(runs):
    """AdamW over the TP mesh: the moments of the last layer are blocks,
    the first loss is JAX's (no update has happened yet), the next finite."""
    _, jlosses = runs["jax"]
    res = runs["world4"]
    _same_on_every_rank(res, "tp_adam")
    ours = res[0]["tp_adam"]
    assert ours["moment_shapes"][V] == (256, 256)
    np.testing.assert_allclose(ours["losses"][0], jlosses[0], rtol=1e-5)
    assert np.isfinite(ours["losses"]).all()


def test_tp_checkpoint_resume_continuity(runs):
    """TP at world 4 under AdamW: one step, a checkpoint (gathered, written
    by rank 0), a restore into a state from seed 42 placed on the mesh (each
    rank takes its blocks of the moments), one step: the uninterrupted run's
    parameters, centre and step."""
    res = runs["world4"]
    a, c = res[0]["tp_adam"], res[0]["tp_resume"]
    _same_on_every_rank(res, "tp_resume")
    assert c["step"] == 2
    np.testing.assert_allclose(n(c["student"][V]), n(a["student"][V]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(c["center"]), n(a["center"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(c["losses"], a["losses"], rtol=1e-6, atol=1e-7)


def test_tp_checkpoint_resumes_in_one_process(runs):
    """The world-4 TP checkpoint (whole tensors in today's layout) resumes
    alone: the restored state's moments are whole, and one more step on the
    global batch matches the world-4 run's second step (its loss rtol 1e-5;
    AdamW's parameters within tests/test_torch_dino_step.py's 5e-4)."""
    mgr = CheckpointManager(runs["ckpt_dir"])
    assert mgr.steps() == [1]
    saved = torch.load(mgr.path(1), weights_only=True)
    assert saved["opt_state"]["mu"][V].shape == (512, 256)
    state = ttr.init_dino_train_state(runs["tacfg"], seed=7)
    assert mgr.restore(state) and state.step == 1
    sch = ttr.DinoSchedules(**runs["arrays"])
    c = runs["crops"][1]
    m = ttr.dino_train_step(state, t(c[0]), tuple(map(t, c[1:])), sch, runs["tacfg"])
    a = runs["world4"][0]["tp_adam"]
    np.testing.assert_allclose(float(m["loss"]), a["losses"][1], rtol=1e-5)
    for k, v in a["student"].items():
        np.testing.assert_allclose(n(state.student.state_dict()[k]), n(v), atol=5e-4, rtol=0,
                                   err_msg=k)


def test_fsdp_matches_jax(runs):
    """ZeRO at world 2 (data 2), SGD: the sizeable tensors' momentum lives
    as blocks (qkv really is split: ``fsdp_spec`` picks its largest dim),
    the gradients are reduce-scattered, the update and EMA act on blocks;
    the losses and fc1's weights equal JAX's."""
    jstate, jlosses = runs["jax"]
    res = runs["world2"]
    _same_on_every_rank(res, "zero_sgd")
    ours = res[0]["zero_sgd"]
    assert ours["placements"][QKV] == ("data", 0)
    assert ours["moment_shapes"][QKV] == (288, 192)  # (3 * 192 / 2, 192)
    assert ours["placements"]["backbone.blocks.0.norm1.weight"] is None  # under 2**14
    np.testing.assert_allclose(ours["losses"], jlosses, rtol=2e-4, atol=2e-4)
    ref = vit._sd(jstate.student)
    fc1 = [k for k in ref if k.endswith("mlp.fc1.weight")]
    assert len(fc1) == 12 and set(fc1) == set(ours["student"])
    for k in fc1:
        np.testing.assert_allclose(n(ours["student"][k]), ref[k], rtol=2e-3, atol=2e-5,
                                   err_msg=k)


def test_world2_without_flags_keeps_every_tensor_whole(runs):
    """World 2, no ``--model_parallel`` and no ``--fsdp``: nothing is split
    (tests/test_tp.py:176-193); the step is data parallel."""
    res = runs["world2"]
    ours = res[0]["whole"]
    assert not any(ours["placements"].values())
    assert ours["moment_shapes"][V] == (512, 256) and ours["moment_shapes"][QKV] == (576, 192)
    np.testing.assert_allclose(ours["losses"], runs["jax"][1][:1], rtol=2e-4, atol=2e-4)
    _same_on_every_rank(res, "whole")
