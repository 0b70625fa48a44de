"""Port convnet training (LARS in train/optim.py, the BatchNorm-aware DINO
step in train/dino_trainer.py, the ResNet classification step, the CLIs and
checkpoints) against the JAX package.

Both packages start from the JAX package's weights and BatchNorm state,
carried across with ``ckpt/from_jax.load_jax_params``, and see the same
numpy inputs, in f32. Bounds are tests/test_step_oracle.py's for the
ResNet + LARS step: loss 5e-5 a step and parameters 2e-3 after 3 steps (the
one-pass BatchNorm's f32 rounding, amplified by LARS's trust ratio at lr
0.3); the running statistics, state of the same trajectory, are held to
the parameters' 2e-3 and the centre to it too. LARS alone 1e-6 (one f32
update); the classification step tests/test_torch_cls.py's 1e-5 loss and
5e-4 parameters, its logits test_torch_resnet.py's 1e-4 of the largest.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinomc_tpu.ckpt import torch_export as jexport
from dinomc_tpu.core import schedules as jsched
from dinomc_tpu.models import vit as jvit
from dinomc_tpu.train import cls_trainer as jcls
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu.train import optim as joptim
from dinomc_tpu_torch.ckpt import torch_import as timport
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import head_state_dict, load_jax_params
from dinomc_tpu_torch.cli import eurosat
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.train import cls_trainer as tcls
from dinomc_tpu_torch.train import dino_trainer as ttr
from dinomc_tpu_torch.train import optim as toptim
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401
from dinomc_tpu.ops import augment as jaug
from dinomc_tpu_torch.ops import augment as taug
from test_torch_augment import _jax_boxes
from test_torch_cls import SCALE, WD

EPOCHS, NITER, B, GLOBAL = 3, 2, 4, 32
LOCAL_SIZES = (24, 16, 16)  # two buckets: 16 px (two crops), then 24 px


# --- LARS ---------------------------------------------------------------------

def _lars_both(params, wd_m, frozen_seq, seed, to_jax=None, from_jax=None):
    """Steps of both packages' LARS, one a frozen mask of ``frozen_seq``,
    gradients drawn from ``seed`` (zero for a leaf named ``zero``).
    ``params`` is a flat {name: array} dict in the port's layout; ``to_jax``
    and ``from_jax`` map such a dict to the JAX tree and back (default: the
    same dict). Masks go to JAX as ``to_jax`` of a tree of its own leaves'
    masks: ``joptim.wd_mask`` and zeros for the stacked case."""
    rng = np.random.default_rng(seed)
    tp = {k: t(v) for k, v in params.items()}
    ts = toptim.lars_init(tp)
    jp = jax.tree_util.tree_map(jnp.asarray, to_jax(params) if to_jax else params)
    js = joptim.lars_init(jp)
    if to_jax:  # stacked: JAX's own masks of its leaves
        jwd = joptim.wd_mask(jp)
    else:
        jwd = {k: jnp.float32(v) for k, v in wd_m.items()}
    for i, frozen in enumerate(frozen_seq):
        g = {k: (np.zeros_like(v) if k == "zero" else
                 rng.standard_normal(v.shape).astype(np.float32)) for k, v in params.items()}
        lr, wd = 0.3 * (i + 1), 0.05
        jg = jax.tree_util.tree_map(jnp.asarray, to_jax(g) if to_jax else g)
        jf = (jax.tree_util.tree_map(jnp.zeros_like, jwd) if to_jax
              else {k: jnp.float32(v) for k, v in frozen.items()})
        jp, js = joptim.lars_update(jg, js, jp, jnp.float32(lr), jnp.float32(wd), jwd,
                                    frozen_mask=jf)
        toptim.lars_update({k: t(v) for k, v in g.items()}, ts, tp, lr, wd, wd_m,
                           frozen_mask=frozen)
    back = from_jax or (lambda d: d)
    return tp, ts, back(jax.device_get(jp)), back(jax.device_get(js["mu"]))


def test_lars_matches_jax_per_leaf():
    """3 steps on 1-D, bias, 2-D, 4-D, zero-norm (a zero tensor with a zero
    gradient: ratio 1) and frozen leaves; the frozen set changes between
    steps, and a frozen leaf keeps its value and its buffer."""
    rng = np.random.default_rng(0)
    shapes = {"scale": (5,), "fc.bias": (3,), "fc.weight": (3, 4), "conv.weight": (4, 2, 3, 3),
              "zero": (2, 3), "other.weight": (6, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    p0["zero"] = np.zeros(shapes["zero"], np.float32)
    wd_m = toptim.wd_mask({k: t(v) for k, v in p0.items()})
    assert wd_m == {"scale": 0.0, "fc.bias": 0.0, "fc.weight": 1.0, "conv.weight": 1.0,
                    "zero": 1.0, "other.weight": 1.0}
    none = {k: 0.0 for k in shapes}
    frozen_seq = [{**none, "other.weight": 1.0}, {**none, "scale": 1.0, "conv.weight": 1.0}, none]
    p_frozen = p0["other.weight"].copy()
    tp, ts, jp, jmu = _lars_both(p0, wd_m, frozen_seq, seed=1)
    for k in shapes:
        np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]), atol=1e-6, err_msg=k)
        np.testing.assert_allclose(n(ts["mu"][k]), np.asarray(jmu[k]), atol=1e-6, err_msg=k)
    assert np.array_equal(n(tp["zero"]), np.zeros(shapes["zero"]))
    assert not np.array_equal(n(tp["other.weight"]), p_frozen)  # trained after step 0


def test_lars_on_stacked_vit_leaves_matches_jax():
    """``vit_test``: the JAX tree holds each block tensor as one (depth, ...)
    leaf, so its trust ratio is that of the joint norm of every block's
    copy; the port takes it over each tensor's stacked group
    (``optim.stacked_name``). A ratio per block would miss the bound."""
    from dinomc_tpu.ckpt.torch_import import vit_params_from_torch

    tree = jax.device_get(jvit.init_vit(jax.random.PRNGKey(0),
                                        jvit.vit_test(patch_size=4, img_size=16)))
    pre = "backbone."  # the trainers' names, which stacked_name groups
    flat = {k: np.asarray(v) for k, v in jexport.vit_state_dict(tree, pre).items()}
    depth = np.asarray(tree["blocks"]["norm1"]["scale"]).shape[0]
    wd_m = toptim.wd_mask({k: t(v) for k, v in flat.items()})
    assert wd_m["backbone.blocks.1.norm1.weight"] == 1.0  # a row of a 2-D leaf
    none = {k: 0.0 for k in flat}
    tp, ts, jp, jmu = _lars_both(
        flat, wd_m, [none] * 3, seed=2,
        to_jax=lambda d: vit_params_from_torch({k[len(pre):]: v for k, v in d.items()}, depth),
        from_jax=lambda tr: {k: np.asarray(v) for k, v in jexport.vit_state_dict(tr, pre).items()})
    assert set(jp) == set(flat)
    for k in flat:
        np.testing.assert_allclose(n(tp[k]), jp[k], atol=1e-6, err_msg=k)
        np.testing.assert_allclose(n(ts["mu"][k]), jmu[k], atol=1e-6, err_msg=k)


# --- the DINO step ----------------------------------------------------------

def _dino_configs(**kw):
    common = dict(arch="resnet_test", out_dim=64, drop_path_rate=0.0, niter_per_ep=NITER,
                  global_crop_size=GLOBAL, clip_grad=3.0, freeze_last_layer=1,
                  optimizer="lars", use_bn_in_head=True, compute_dtype="float32")
    common.update(kw)
    return jtr.DinoConfig(**common), ttr.DinoConfig(**common)


def _dino_states(jcfg, tcfg):
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    return jstate, tstate


def _crops(rng):
    crops = [rng.standard_normal((B, GLOBAL, GLOBAL, 3)).astype(np.float32) for _ in range(2)]
    return crops + [rng.standard_normal((B, s, s, 3)).astype(np.float32) for s in LOCAL_SIZES]


def _dino_sd(params, bn_state):
    """A JAX {'backbone', 'head'} tree and its BatchNorm state in the port's
    naming and layout (running statistics included)."""
    params, bn_state = jax.device_get((params, bn_state))
    sd = jexport.resnet_state_dict(params["backbone"], bn_state, "backbone.")
    sd.update(head_state_dict(params["head"], "head."))
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _without_counts(sd):
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _assert_changes_close(ours, ref, init, what):
    """Each leaf's change from the shared ``init``, ours against JAX's,
    within 1e-2 of JAX's largest entry of that change, plus f32 rounding (4
    ulp of the leaf's largest value, and 1e-8: the two head biases that feed
    a batch-statistics BatchNorm have no gradient and move by rounding
    alone, ~1e-9). The parameters' 2e-3 is far above what LARS moves a conv
    or linear weight in two updates (~5e-4 in the student, ~2e-6 in the
    teacher); this holds those moves to ~1e-3 (student) and ~3e-1 of the
    bound (teacher)."""
    eps = float(np.finfo(np.float32).eps)
    for k in sorted(ref):
        r = np.asarray(ref[k], np.float32)
        d_ref = r - init[k]
        bound = 1e-2 * np.abs(d_ref).max() + 4 * eps * np.abs(r).max() + 1e-8
        np.testing.assert_allclose(n(ours[k]) - init[k], d_ref, atol=bound, rtol=0,
                                   err_msg=f"{what}{k}: change from init")


def test_three_resnet_lars_bn_head_steps_match_jax():
    """3 steps of ``dino_train_step`` at resnet_test with LARS and BN in the
    head, from the JAX package's init, across the last-layer freeze of
    epoch 0 and its end: the loss at every step; after, the student and the
    teacher (parameters and running statistics: the teacher's BatchNorm runs
    in train mode and is never EMA'd, the student's moves a bucket at a time,
    globals first, then 16 px, then 24 px), each leaf's change from the init
    too, and the centre.
    ``num_batches_tracked`` rises by one a bucket a step in the student and
    once a step in the teacher."""
    jcfg, tcfg = _dino_configs()
    jstate, tstate = _dino_states(jcfg, tcfg)
    assert set(tstate.opt_state) == {"mu"}
    init = {which: {k: n(v).copy()
                    for k, v in _without_counts(getattr(tstate, which).state_dict()).items()}
            for which in ("student", "teacher")}
    lr = jsched.cosine_scheduler(0.3, 1e-6, EPOCHS, NITER, warmup_epochs=1)
    wd = jsched.cosine_scheduler(1e-6, 1e-6, EPOCHS, NITER)
    mom = jsched.cosine_scheduler(0.996, 1.0, EPOCHS, NITER)
    ttemp = jsched.teacher_temp_schedule(0.04, 0.07, 2, EPOCHS)
    jsch = jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                             teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp))
    tsch = ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp)
    rng = np.random.default_rng(7)
    steps = 3
    for it in range(steps):
        crops = _crops(rng)
        jstate, jm = jtr.dino_train_step(
            jstate, jnp.asarray(np.stack(crops[:2])), tuple(map(jnp.asarray, crops[2:])), jsch, jcfg)
        tm = ttr.dino_train_step(tstate, t(np.stack(crops[:2])), tuple(map(t, crops[2:])), tsch, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=5e-5, rtol=0,
                                   err_msg=f"loss at step {it}")
    for which in ("student", "teacher"):
        ours = getattr(tstate, which).state_dict()
        ref = _dino_sd(getattr(jstate, which), getattr(jstate, f"{which}_state"))
        assert_state_dicts_close(_without_counts(ours), ref, 2e-3, f"{which} ")
        _assert_changes_close(ours, ref, init[which], f"{which} ")
        buckets = 1 + len(set(LOCAL_SIZES)) if which == "student" else 1
        assert {int(v) for k, v in ours.items() if k.endswith("num_batches_tracked")} == {
            steps * buckets}
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=2e-3)
    # the running statistics moved, and the teacher's are its own
    key = "backbone.layer3.0.bn2.running_mean"
    assert not np.array_equal(n(tstate.student.state_dict()[key]), init["student"][key])
    assert not torch.equal(tstate.teacher.state_dict()[key], tstate.student.state_dict()[key])


def test_one_train_forward_moves_each_batchnorm_once_a_bucket():
    """No remat and no replay for the convnets: the student's forward over
    the globals and two local buckets moves every BatchNorm's
    ``num_batches_tracked`` by exactly 3, the teacher's (train mode, no
    grad) by 1, and the backward by none."""
    _, tcfg = _dino_configs()
    state = ttr.init_dino_train_state(tcfg, seed=0)
    crops = _crops(np.random.default_rng(1))
    ttr.dino_loss_and_grads(state, t(np.stack(crops[:2])), tuple(map(t, crops[2:])), 0.04,
                            state.generator, tcfg)
    for which, want in (("student", 3), ("teacher", 1)):
        counts = {int(v) for k, v in getattr(state, which).state_dict().items()
                  if k.endswith("num_batches_tracked")}
        assert counts == {want}, which


def test_resume_with_batchnorm_buffers_equals_an_uninterrupted_run(tmp_path):
    """2 steps, a checkpoint, a fresh state restored from it and a third
    step equal 3 steps without a break, bit for bit: student and teacher
    parameters and running statistics, LARS buffers, centre and step."""
    _, tcfg = _dino_configs()
    lr = np.full(EPOCHS * NITER, 0.3, np.float32)
    sch = ttr.DinoSchedules(lr=lr, wd=lr * 0 + 1e-6, teacher_momentum=lr * 0 + 0.99,
                            teacher_temp=np.full(EPOCHS, 0.04, np.float32))
    batches = [_crops(np.random.default_rng(20 + i)) for i in range(3)]

    def step(state, crops):
        ttr.dino_train_step(state, t(np.stack(crops[:2])), tuple(map(t, crops[2:])), sch, tcfg)

    whole = ttr.init_dino_train_state(tcfg, seed=0)
    for crops in batches:
        step(whole, crops)
    first = ttr.init_dino_train_state(tcfg, seed=0)
    for crops in batches[:2]:
        step(first, crops)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(first.step, first)
    resumed = ttr.init_dino_train_state(tcfg, seed=0)
    assert ckpt.restore(resumed)
    for which in ("student", "teacher"):
        for k, v in getattr(first, which).state_dict().items():
            assert torch.equal(getattr(resumed, which).state_dict()[k], v), (which, k)
    step(resumed, batches[2])
    assert resumed.step == whole.step == 3
    for which in ("student", "teacher"):
        ours, ref = getattr(resumed, which).state_dict(), getattr(whole, which).state_dict()
        assert all(torch.equal(ours[k], ref[k]) for k in ref), which
    assert all(torch.equal(resumed.opt_state["mu"][k], v) for k, v in whole.opt_state["mu"].items())
    assert torch.equal(resumed.center, whole.center)


# --- the EuroSAT step -------------------------------------------------------

CLS_RAW, CLS_CROP = 80, 64
# the EuroSAT recipe's scale (0.001 * 32 / 256 = 1.25e-4 on one card; up to
# 8x that here). tests/test_torch_cls.py's ViT lrs 0.05-0.01 drive a random
# BatchNorm ResNet's loss from 1.8 to 7.8 in 3 steps, where the JAX
# package's own f32 loss sits 1e-4 from a float64 run (the port's within
# 1e-6 of it)
CLS_LRS = (1e-3, 6e-4, 2e-4)


def _train_view(key, images):
    """The EuroSAT train transform at 64 px in both packages on the same
    draws: JAX's own calls, and the port's on JAX's boxes and flips."""
    k1, k2 = jax.random.split(key)
    ref = jaug.normalize(jaug.random_hflip(
        k2, jaug.random_resized_crop(k1, jnp.asarray(images), CLS_CROP, SCALE)))
    boxes = t(_jax_boxes(k1, B, CLS_RAW, CLS_RAW, SCALE))
    flips = t(jax.random.bernoulli(k2, 0.5, (B, 1, 1, 1)).reshape(-1), torch.bool)
    return ref, taug.eurosat_train_view(t(images), (boxes, flips), CLS_CROP)


@pytest.mark.parametrize("freeze", [False, True])
def test_three_resnet_cls_steps_match_jax(freeze):
    """3 SGD steps of ``cls_train_step`` at resnet_test, on JAX's crops and
    flips: loss and accuracy a step, then every parameter and running
    statistic, then ``cls_predict`` (running statistics) within 1e-4 of the
    largest logit (tests/test_torch_resnet.py's bound for features: the
    running variances, 1.5e-5 apart relative after 3 steps, scale 17
    BatchNorms in a row). With the backbone frozen its parameters stay
    bit-identical while its running statistics move, as the JAX step keeps
    ``new_bn`` in both modes. Crops of 64 px: at 32 px the last stage's
    BatchNorm normalizes 4 values a channel, where the JAX package's own f32
    features sit 3e-4 from a float64 run (tests/test_torch_resnet.py)."""
    common = dict(arch="resnet_test", num_classes=5, compute_dtype="float32",
                  freeze_backbone=freeze)
    jcfg, tcfg = jcls.ClsConfig(**common), tcls.ClsConfig(**common)
    jstate = jcls.init_cls_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = tcls.init_cls_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    rng = np.random.default_rng(2)
    for step, lr in enumerate(CLS_LRS):
        images = rng.uniform(size=(B, CLS_RAW, CLS_RAW, 3)).astype(np.float32)
        labels = rng.integers(0, 5, B)
        xj, xt = _train_view(jax.random.PRNGKey(10 + step), images)
        jstate, jm = jcls.cls_train_step(jstate, xj, jnp.asarray(labels), jnp.float32(lr),
                                         jnp.float32(WD), jcfg)
        tm = tcls.cls_train_step(tstate, xt, torch.from_numpy(labels), lr, WD, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0,
                                   err_msg=f"loss at step {step}")
        assert float(tm["acc"]) == float(jm["acc"])
    params, bn = jax.device_get((jstate.params, jstate.bn_state))
    ref = jexport.resnet_state_dict(params["backbone"], bn, "backbone.")
    ref.update({f"fc.{k}": np.asarray(v) for k, v in params["fc"].items()})
    now = tstate.model.state_dict()
    assert_state_dicts_close(_without_counts(now), _without_counts(ref), 5e-4)
    assert int(now["backbone.bn1.num_batches_tracked"]) == len(CLS_LRS)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jcls.cls_predict(jstate.params, jstate.bn_state, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(n(tcls.cls_predict(tstate.model, t(x), tcfg)), want,
                               atol=1e-4 * np.abs(want).max())
    stats = [k for k in now if k.startswith("backbone.") and "running_" in k]
    assert not any(torch.equal(now[k], before[k]) for k in stats)
    if freeze:
        assert all(torch.equal(now[k], before[k]) for k, _ in tstate.model.named_parameters()
                   if k.startswith("backbone."))


def test_a_resnet_classifier_pth_round_trips_through_the_reference_layout(tmp_path):
    """``save_cls_checkpoint`` writes a ResNet's classifier where
    ``classifier_name`` puts it, at torchvision's
    ``fc.weight`` / ``fc.bias`` with the running statistics, the JAX
    package's reader (``resnet_params_from_torch``, what its
    ``load_cls_checkpoint`` calls) finds the same numbers, and the port
    loads it back bit for bit."""
    from dinomc_tpu.ckpt import torch_import as jimport

    cfg = tcls.ClsConfig(arch="resnet_test", num_classes=5, compute_dtype="float32")
    model = tcls.init_cls_train_state(cfg, seed=3).model
    assert timport.classifier_name(model["backbone"]) == "fc"
    with torch.no_grad():  # non-trivial running statistics
        tcls.cls_logits(model, torch.rand(4, 32, 32, 3), cfg, train=True)
    path = str(tmp_path / "rn.pth")
    timport.save_cls_checkpoint(path, model, epoch=1, best_acc=40.0)
    sd = jimport.load_torch_state_dict(path, "state_dict")
    assert "fc.weight" in sd and "head.weight" not in sd and "bn1.running_var" in sd
    params, bn = jimport.resnet_params_from_torch(sd, stage_sizes=(1, 1, 1, 1))
    np.testing.assert_array_equal(params["fc"]["kernel"], n(model.state_dict()["fc.kernel"]))
    np.testing.assert_array_equal(bn["stem"]["bn"]["var"], n(model.backbone.bn1.running_var))
    again = tcls.init_cls_train_state(cfg, seed=4).model
    timport.load_cls_checkpoint(again, path)
    assert all(torch.equal(again.state_dict()[k], v) for k, v in model.state_dict().items())


# --- the CLIs, on the CPU ---------------------------------------------------

def test_train_dino_cli_runs_resnet_lars_bn_head(tmp_path):
    """``train_dino`` with ``--optimizer lars --use_bn_in_head true`` at
    resnet_test (set on the parsed flags: the CLI's ``--arch`` choices are the
    JAX CLI's) on the CPU, 2 steps and a resume to 3: finite losses, both
    BatchNorm states restored with the checkpoint."""
    def args(*extra):
        a = get_args_parser().parse_args([
            "--device", "cpu", "--optimizer", "lars", "--use_bn_in_head", "true",
            "--out_dim", "256", "--batch_size_per_gpu", "2", "--num_workers", "1",
            "--print_freq", "1", "--local_crops_number", "2", "--image_size", "128",
            "--output_dir", str(tmp_path), *extra])
        a.arch = "resnet_test"
        return a

    first = train_dino(args("--max_steps", "2"))
    assert len(first.losses) == 2 and all(math.isfinite(x) for x in first.losses)
    tracked = first.state.teacher.state_dict()["backbone.bn1.num_batches_tracked"]
    assert int(tracked) == 2
    second = train_dino(args("--max_steps", "3"))
    assert second.state.step == 3 and math.isfinite(second.losses[0])
    assert int(second.state.teacher.state_dict()["backbone.bn1.num_batches_tracked"]) == 3
    # student: globals and the two local sizes (104, 84 px) a step
    assert int(second.state.student.state_dict()["backbone.bn1.num_batches_tracked"]) == 9


def test_eurosat_cli_runs_resnet_in_its_four_modes(tmp_path, capsys):
    """``cli.eurosat`` at resnet_test (set on the parsed flags) on the CPU:
    train, ``--evaluate`` of the best checkpoint (equal to the train run's
    score), ``--evaluate_knn`` and ``--evaluate_probe``."""
    def run(*extra):
        a = eurosat.get_args_parser().parse_args([
            "--data_path", "synthetic", "--device", "cpu", "--print_freq", "1",
            "--batch_size_per_gpu", "16", "--output_dir", str(tmp_path), *extra])
        a.arch = "resnet_test"
        return eurosat.run(a)

    best = run("--epochs", "1", "--max_steps", "2")
    assert 0.0 <= best <= 100.0
    assert run("--evaluate", "true") == best
    for mode in ("--evaluate_knn", "--evaluate_probe"):
        assert 0.0 <= run(mode, "true") <= 100.0
    out = capsys.readouterr().out
    assert "k-NN top-1: {10: " in out and "linear probe top-1: " in out
