"""Port classification fine-tune (dinomc_tpu_torch/train/cls_trainer.py,
cli/eurosat.py, the EuroSAT transform, data and checkpoints) and the
learning check's k-NN against the JAX package.

Both packages start from the JAX package's weights, carried across with
``ckpt/from_jax.load_jax_params``, in f32 (``compute_dtype="float32"``, as
``tests/test_classification.py`` runs the JAX side), and see the same crop
boxes and flips (the JAX draws, replayed). Bounds are
tests/test_step_oracle.py's: per-step loss 1e-5 and parameters 5e-4 after
3 optimizer steps; logits 1e-5 of their largest; the augmentation's 1e-5;
SGD 1e-6.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.ckpt import torch_export
from dinomc_tpu.ckpt import torch_import as jimport
from dinomc_tpu.data import classification as jdata
from dinomc_tpu.eval.knn import knn_accuracy as jknn_accuracy
from dinomc_tpu.models import swin as jsw
from dinomc_tpu.ops import augment as jaug
from dinomc_tpu.train import cls_trainer as jcls
from dinomc_tpu.train import dino_trainer as jdino
from dinomc_tpu.train import optim as joptim
from dinomc_tpu.utils.synthetic import make_texture_dataset
from dinomc_tpu_torch.ckpt import torch_import as timport
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli import eurosat
from dinomc_tpu_torch.data import classification as tdata
from dinomc_tpu_torch.models import swin as tsw
from dinomc_tpu_torch.ops import augment as taug
from dinomc_tpu_torch.train import cls_trainer as tcls
from dinomc_tpu_torch.train import dino_trainer as tdino
from dinomc_tpu_torch.train import optim as toptim
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401
from test_torch_augment import _jax_boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, RAW, CROP, C = 4, 40, 32, 5
SCALE = (0.08, 1.0)
LRS, WD = (0.05, 0.03, 0.01), 1e-4


def test_sgd_update_matches_jax_per_tensor():
    """Momentum buffers and values under the wd mask, over steps where the
    frozen set changes: a frozen tensor keeps its value and its buffer."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (4,), "c": (2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    wd_m = {"a": 1.0, "b": 0.0, "c": 1.0}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = joptim.sgd_init(jp)
    tp = {k: t(v) for k, v in p0.items()}
    ts = toptim.sgd_init(tp)
    for i, frozen in enumerate([{"a": 1.0, "b": 0.0, "c": 0.0}, {"a": 0.0, "b": 1.0, "c": 0.0},
                                {"a": 0.0, "b": 0.0, "c": 0.0}, {"a": 0.0, "b": 0.0, "c": 1.0}]):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        lr, wd = 0.1 * (i + 1), 0.05
        jp, js = joptim.sgd_update(
            {k: jnp.asarray(v) for k, v in g.items()}, js, jp, jnp.float32(lr), jnp.float32(wd),
            {k: jnp.float32(v) for k, v in wd_m.items()},
            frozen_mask={k: jnp.float32(v) for k, v in frozen.items()})
        toptim.sgd_update({k: t(v) for k, v in g.items()}, ts, tp, lr, wd, wd_m,
                          frozen_mask=frozen)
    for k in shapes:
        np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]), atol=1e-6)
        np.testing.assert_allclose(n(ts["mu"][k]), np.asarray(js["mu"][k]), atol=1e-6)


def test_lars_is_registered_and_builds_a_train_state():
    """LARS is ported (its parity tests are in tests/test_torch_convnet_step.py):
    ``OPTIMIZERS['lars']`` builds a train state with one momentum buffer."""
    assert toptim.OPTIMIZERS["lars"] == (toptim.lars_init, toptim.lars_update)
    state = tdino.init_dino_train_state(tdino.DinoConfig(arch="vit_test", patch_size=4,
                                                         out_dim=16, optimizer="lars"))
    assert set(state.opt_state) == {"mu"}


def test_lars_still_raises_with_its_roadmap_item():
    """LARS takes an XCiT encoder too (ported, tests/test_torch_xcit.py):
    XCiT-S/8 builds a LARS train state with one momentum buffer a
    parameter, a block's temperature included."""
    state = tdino.init_dino_train_state(tdino.DinoConfig(arch="xcit_small_12", out_dim=16,
                                                         optimizer="lars"))
    params = dict(state.student.named_parameters())
    assert set(state.opt_state) == {"mu"} and set(state.opt_state["mu"]) == set(params)
    assert state.opt_state["mu"]["backbone.blocks.11.temp"].shape == (8,)


def _train_view(key, images):
    """The EuroSAT train transform in both packages on the same draws:
    JAX's own calls, and the port's on JAX's boxes and flips."""
    k1, k2 = jax.random.split(key)
    x = jnp.asarray(images)
    ref = jaug.normalize(jaug.random_hflip(k2, jaug.random_resized_crop(k1, x, CROP, SCALE)))
    boxes = t(_jax_boxes(k1, B, RAW, RAW, SCALE))
    flips = t(jax.random.bernoulli(k2, 0.5, (B, 1, 1, 1)).reshape(-1), torch.bool)
    ours = taug.eurosat_train_view(t(images), (boxes, flips), CROP)
    return ref, ours


def test_eurosat_transform_matches_jax_on_the_same_draws():
    images = np.random.default_rng(1).uniform(size=(B, RAW, RAW, 3)).astype(np.float32)
    for seed in range(3):
        ref, ours = _train_view(jax.random.PRNGKey(seed), images)
        np.testing.assert_allclose(n(ours), np.asarray(ref), atol=1e-5)
    flips = taug.draw_hflip(torch.Generator().manual_seed(0), 1000, p=0.5)
    assert flips.dtype == torch.bool and 400 < int(flips.sum()) < 600
    boxes, flips = taug.draw_eurosat_view(torch.Generator().manual_seed(0), 1000, RAW, RAW)
    assert taug.EUROSAT_SCALE == SCALE and boxes.shape == (1000, 4) and flips.shape == (1000,)
    area = boxes[:, 0] * boxes[:, 1] / RAW**2
    assert float(area.min()) >= SCALE[0] * 0.99 and float(area.max()) <= SCALE[1]


def _state_dict(params, arch):
    """A JAX {'backbone', 'fc'} tree in the port's naming and layout."""
    params = jax.device_get(params)
    export = torch_export.swin_state_dict if arch == "swin_t" else torch_export.vit_state_dict
    sd = export(params["backbone"], "backbone.")
    sd.update({f"fc.{k}": np.asarray(v) for k, v in params["fc"].items()})
    return sd


def _configs(arch, **kw):
    common = dict(arch=arch, patch_size=8, num_classes=C, compute_dtype="float32", **kw)
    return jcls.ClsConfig(**common), tcls.ClsConfig(**common)


def _states(jcfg, tcfg):
    jstate = jcls.init_cls_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = tcls.init_cls_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    return jstate, tstate


@pytest.mark.parametrize("arch,mode", [
    ("vit_test", "plain"), ("vit_test", "freeze_backbone"), ("vit_test", "multilabel"),
    ("vit_test", "label_smoothing"), ("swin_t", "plain"),
])
def test_three_cls_steps_match_jax(arch, mode, monkeypatch):
    """3 SGD steps of ``cls_train_step`` against JAX's, from its weights and
    on its crops and flips: loss and accuracy per step, every parameter
    after, then ``cls_predict``'s logits (1e-5 of their largest). A frozen
    backbone stays bit-identical. Swin-T keeps its widths (the JAX
    classifier is 768 wide) and two blocks a stage, a shifted one in each."""
    if arch == "swin_t":
        for mod in (jsw, tsw):
            monkeypatch.setattr(mod, "swin_t", lambda mod=mod, **kw: mod.SwinConfig(
                depths=(2, 2, 2, 2), **kw))
    kw = {"freeze_backbone": {"freeze_backbone": True}, "multilabel": {"multilabel": True},
          "label_smoothing": {"label_smoothing": 0.1}}.get(mode, {})
    jcfg, tcfg = _configs(arch, **kw)
    jstate, tstate = _states(jcfg, tcfg)
    bb0 = {k: v.clone() for k, v in tstate.model.state_dict().items() if k.startswith("backbone.")}
    rng = np.random.default_rng(2)
    for step, lr in enumerate(LRS):
        images = rng.uniform(size=(B, RAW, RAW, 3)).astype(np.float32)
        if mode == "multilabel":
            labels = (rng.uniform(size=(B, C)) < 0.4).astype(np.float32)
        else:
            labels = rng.integers(0, C, B)
        xj, xt = _train_view(jax.random.PRNGKey(10 + step), images)
        jstate, jm = jcls.cls_train_step(jstate, xj, jnp.asarray(labels), jnp.float32(lr),
                                         jnp.float32(WD), jcfg)
        tm = tcls.cls_train_step(tstate, xt, torch.from_numpy(labels), lr, WD, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0,
                                   err_msg=f"loss at step {step}")
        assert float(tm["acc"]) == float(jm["acc"])
    assert tstate.step == int(jstate.step) == len(LRS)
    assert_state_dicts_close(tstate.model.state_dict(), _state_dict(jstate.params, arch), 5e-4)
    x = rng.standard_normal((B, CROP, CROP, 3)).astype(np.float32)
    want = np.asarray(jcls.cls_predict(jstate.params, jstate.bn_state, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(n(tcls.cls_predict(tstate.model, t(x), tcfg)), want,
                               atol=1e-5 * np.abs(want).max())
    if mode == "freeze_backbone":
        assert all(torch.equal(tstate.model.state_dict()[k], v) for k, v in bb0.items())
        assert set(tstate.opt_state["mu"]) >= {"fc.kernel"}
        assert all(float(m.abs().max()) == 0.0 for k, m in tstate.opt_state["mu"].items()
                   if k.startswith("backbone."))


def test_unported_encoders_name_their_roadmap_item():
    """The convnets are ported (``resnet50`` is 2048 wide), and so is XCiT:
    XCiT-S/8 builds a classifier on its 384-wide CLS output, XCiT-M 512."""
    assert tcls.ClsConfig(arch="resnet50").encoder().embed_dim == 2048
    assert tcls.ClsConfig(arch="xcit_medium_24").encoder().embed_dim == 512
    state = tcls.init_cls_train_state(tcls.ClsConfig(arch="xcit_small_12"))
    assert type(state.model["backbone"]).__name__ == "XCiT"
    assert state.model["fc"].kernel.shape == (384, 10)


def _images(seed, size=CROP):
    return np.random.default_rng(seed).standard_normal((3, size, size, 3)).astype(np.float32)


def test_a_pth_written_by_the_port_is_read_by_jax_and_back(tmp_path):
    """The reference fine-tuned layout both ways: a file the port writes
    gives JAX's ``load_cls_checkpoint`` the port's logits, and a file the
    JAX package writes gives the port JAX's logits (atol 1e-5)."""
    jcfg, tcfg = _configs("vit_test")
    jstate, _ = _states(jcfg, tcfg)
    ours = tcls.init_cls_train_state(tcfg, seed=3).model
    assert timport.classifier_name(ours["backbone"]) == "head"
    x = _images(4)
    timport.save_cls_checkpoint(str(tmp_path / "ours.pth"), ours, epoch=2, best_acc=50.0)
    params, bn = jimport.load_cls_checkpoint(str(tmp_path / "ours.pth"), "vit_test")
    np.testing.assert_allclose(
        np.asarray(jcls.cls_predict(jax.tree_util.tree_map(jnp.asarray, params), bn,
                                    jnp.asarray(x), jcfg)),
        n(tcls.cls_predict(ours, t(x), tcfg)), atol=1e-5)

    torch_export.export_cls_checkpoint(str(tmp_path / "ref.pth"), "vit_test",
                                       jax.device_get(jstate.params))
    timport.load_cls_checkpoint(ours, str(tmp_path / "ref.pth"))
    np.testing.assert_allclose(
        n(tcls.cls_predict(ours, t(x), tcfg)),
        np.asarray(jcls.cls_predict(jstate.params, jstate.bn_state, jnp.asarray(x), jcfg)),
        atol=1e-5)


def test_image_folder_and_center_crop_are_the_originals(tmp_path):
    rng = np.random.default_rng(5)
    for c, name in enumerate(("Forest", "AnnualCrop")):
        (tmp_path / name).mkdir()
        for i in range(2 + c):
            img = rng.integers(0, 256, (30 + i, 40 - i, 3), dtype=np.uint8)
            Image.fromarray(img).save(tmp_path / name / f"{name}_{i}.png")
    (tmp_path / "Forest" / "notes.txt").write_text("not an image")
    ours = tdata.ImageFolderDataset(str(tmp_path), image_size=36)
    ref = jdata.ImageFolderDataset(str(tmp_path), image_size=36)
    assert ours.classes == ref.classes and ours.samples == ref.samples and len(ours) == 5
    for i in range(len(ref)):
        (xo, yo), (xr, yr) = ours[i], ref[i]
        assert yo == yr
        np.testing.assert_array_equal(xo, xr)
    batch = np.stack([ours[i][0] for i in range(len(ours))])
    np.testing.assert_array_equal(tdata.center_crop(batch, 24), jdata.center_crop(batch, 24))


# --- the CLI, on the CPU --------------------------------------------------

CLI = ["--arch", "vit_tiny", "--patch_size", "16", "--data_path", "synthetic",
       "--device", "cpu", "--print_freq", "1"]


def _cli(out_dir, *extra):
    args = eurosat.get_args_parser().parse_args(CLI + ["--output_dir", str(out_dir), *extra])
    return eurosat.run(args)


def _log(out_dir):
    return [json.loads(line) for line in (out_dir / "log.txt").read_text().splitlines()]


def test_cli_trains_evaluates_and_resumes(tmp_path, capsys):
    best = _cli(tmp_path, "--epochs", "1", "--max_steps", "2", "--batch_size_per_gpu", "16")
    assert 0.0 <= best <= 100.0
    assert [r["epoch"] for r in _log(tmp_path)] == [0]
    assert CheckpointManager(str(tmp_path / "checkpoints")).steps() == [0]
    # --evaluate restores this run's best checkpoint and scores it again
    assert _cli(tmp_path, "--evaluate", "true", "--batch_size_per_gpu", "16") == best
    for mode in ("--evaluate_knn", "--evaluate_probe"):
        assert 0.0 <= _cli(tmp_path, mode, "true", "--batch_size_per_gpu", "16") <= 100.0
    out = capsys.readouterr().out
    assert "k-NN top-1: {10: " in out and "linear probe top-1: " in out
    # a rerun with more epochs resumes after epoch 0, at step 2
    _cli(tmp_path, "--epochs", "2", "--max_steps", "3", "--batch_size_per_gpu", "16")
    assert "resumed from checkpoint at epoch 0" in capsys.readouterr().out
    assert [r["epoch"] for r in _log(tmp_path)] == [0, 1]
    state = tcls.init_cls_train_state(tcls.ClsConfig(arch="vit_tiny", patch_size=16))
    CheckpointManager(str(tmp_path / "checkpoints")).restore(state)
    assert state.step == 3


def test_cli_top1_comes_from_the_confusion_matrix(tmp_path):
    """32 val images in batches of 12, 12 and 8 (drop_last=False): top-1 is
    the share of all 32 images, not the mean of the three batches'."""
    _cli(tmp_path, "--epochs", "1", "--max_steps", "1", "--batch_size_per_gpu", "12")
    top1 = _cli(tmp_path, "--evaluate", "true", "--batch_size_per_gpu", "12")
    cfg = tcls.ClsConfig(arch="vit_tiny", patch_size=16)
    state = tcls.init_cls_train_state(cfg)
    CheckpointManager(str(tmp_path / "checkpoints")).restore(state)
    correct, sizes = [], []
    for images, labels in eurosat._batches(eurosat._SyntheticCls(32), 12, False, 0,
                                           drop_last=False):
        pred = tcls.cls_predict(state.model, taug.normalize(torch.from_numpy(images)), cfg)
        correct.append(int((pred.argmax(-1).numpy() == labels).sum()))
        sizes.append(len(labels))
    assert sizes == [12, 12, 8]
    assert top1 == 100.0 * sum(correct) / 32


def test_cli_evaluates_a_finetuned_pth(tmp_path, capsys):
    cfg = tcls.ClsConfig(arch="vit_tiny", patch_size=16)
    model = tcls.init_cls_train_state(cfg, seed=7).model
    path = str(tmp_path / "finetuned.pth")
    timport.save_cls_checkpoint(path, model)
    top1 = _cli(tmp_path, "--evaluate", "true", "--pretrained_weights", path)
    assert "loaded fine-tuned torch model (incl. classifier)" in capsys.readouterr().out
    images, labels = next(eurosat._batches(eurosat._SyntheticCls(32), 32, False, 0))
    pred = tcls.cls_predict(model, taug.normalize(torch.from_numpy(images)), cfg).argmax(-1)
    assert top1 == 100.0 * float((pred.numpy() == labels).sum()) / 32


def test_cli_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="smaller than the batch"):
        _cli(tmp_path, "--batch_size_per_gpu", "128")
    # XCiT runs since it was ported (here a two-layer stand-in at its width,
    # as tests/test_torch_xcit.py has it); --pretrained_weights with it is
    # refused, as the JAX package has no importer for it either
    from dinomc_tpu_torch.models import xcit as txc

    monkeypatch.setitem(txc.XCIT_FACTORIES, "xcit_small_12", lambda patch_size=16, **kw:
                        txc.XCiTConfig(patch_size=patch_size, depth=2, cls_attn_layers=1, **kw))
    top1 = _cli(tmp_path / "xcit", "--arch", "xcit_small_12", "--epochs", "1", "--max_steps", "1")
    assert 0.0 <= top1 <= 100.0
    with pytest.raises(ValueError, match="no torch importer for XCiT"):
        _cli(tmp_path / "xcit_pth", "--arch", "xcit_small_12", "--pretrained_weights",
             str(tmp_path / "any.pth"))
    if not torch.cuda.is_available():  # no fallback to the CPU
        args = eurosat.get_args_parser().parse_args(["--arch", "vit_tiny"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eurosat.run(args)


# --- the learning check ---------------------------------------------------

def _learning_script():
    path = os.path.join(REPO, "scripts", "validate_learning_torch.py")
    spec = importlib.util.spec_from_file_location("validate_learning_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_learning_script_knn_before_is_the_jax_scripts(monkeypatch, capsys):
    """``--steps 0`` at vit_test, the port's teacher loaded from the JAX
    package's init: the k-NN before pretraining equals what
    scripts/validate_learning.py's ``knn_acc`` computes from the same
    weights (its recipe and feature resize). Both run in f32: in the
    recipe's bf16 the two packages round features apart by a bf16 ulp,
    which moves a neighbour. With no step run there is no endpoint, so the
    gate fails: exit 1."""
    script = _learning_script()
    args = script.get_args_parser().parse_args(
        ["--steps", "0", "--arch", "vit_test", "--n_per_class", "8", "--device", "cpu"])
    jcfg = jdino.DinoConfig(arch="vit_test", patch_size=16, out_dim=1024, niter_per_ep=50,
                            global_crop_size=96, drop_path_rate=0.0, freeze_last_layer=1,
                            compute_dtype="float32")
    jstate = jdino.init_dino_train_state(jax.random.PRNGKey(0), jcfg)
    init = tdino.init_dino_train_state

    def from_jax(cfg, seed=0, device="cpu"):
        state = init(cfg, seed, device)
        load_jax_params(state, jax.device_get(jstate))
        return state

    monkeypatch.setattr(tdino, "init_dino_train_state", from_jax)
    monkeypatch.setattr(tdino, "DinoConfig",
                        functools.partial(tdino.DinoConfig, compute_dtype="float32"))
    assert script.main(["--steps", "0", "--arch", "vit_test", "--n_per_class", "8",
                        "--device", "cpu"]) == 1
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    images, labels = make_texture_dataset(n_per_class=args.n_per_class, seed=0, family="v1")
    n_all, n_train = len(images), int(len(images) * 0.8)
    enc = jcfg.encoder(student=False)
    x = jax.image.resize(jnp.asarray(images), (n_all, 96, 96, 3), "bilinear")
    f, _ = enc.apply(jstate.teacher["backbone"], jstate.teacher_state, x, False, None)
    want = jknn_accuracy(f[:n_train], jnp.asarray(labels[:n_train]), f[n_train:],
                         jnp.asarray(labels[n_train:]), ks=(5,), num_classes=8)[5]
    assert result["knn_before"] == want
    assert result["ok"] is False and result["endpoint_knn"] == []


def test_learning_script_refuses_the_convnets():
    """The script refuses a convnet it has no recipe for: ``--arch`` takes
    the JAX script's choices, which hold resnet_test and resnet50 but not
    wide_resnet50_2 (argparse exits 2)."""
    script = _learning_script()
    with pytest.raises(SystemExit) as exit_:
        script.main(["--arch", "wide_resnet50_2", "--device", "cpu"])
    assert exit_.value.code == 2


def test_learning_script_runs_the_convnet_recipe(monkeypatch, capsys):
    """``--arch resnet_test`` runs the JAX script's convnet recipe (LARS, BN in the head, base lr
    0.3 * batch / 256, weight decay 1e-6). With ``--steps 0`` it reports
    the k-NN before pretraining and, with no endpoint, exits 1."""
    script = _learning_script()
    seen = {}
    init, schedules = tdino.init_dino_train_state, tdino.DinoSchedules

    def spy_init(cfg, seed=0, device="cpu"):
        seen["cfg"] = cfg
        return init(cfg, seed, device)

    def spy_schedules(**kw):
        seen["sch"] = schedules(**kw)
        return seen["sch"]

    monkeypatch.setattr(tdino, "init_dino_train_state", spy_init)
    monkeypatch.setattr(tdino, "DinoSchedules", spy_schedules)
    assert script.main(["--steps", "0", "--arch", "resnet_test", "--n_per_class", "4",
                        "--batch", "32", "--device", "cpu"]) == 1
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= result["knn_before"] <= 100.0 and result["arch"] == "resnet_test"
    assert seen["cfg"].optimizer == "lars" and seen["cfg"].use_bn_in_head
    assert float(seen["sch"].lr.max()) == pytest.approx(0.3 * 32 / 256)
    assert np.all(seen["sch"].wd == np.float32(1e-6))
