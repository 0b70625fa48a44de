"""The port's own copies of host-side modules, held to their originals in
the JAX package, and the rule that the port imports nothing of it.

The port keeps numpy/PyTorch copies of what it took from jax-free modules
of ``dinomc_tpu``: the state-dict exporters (``ckpt/state_dicts.py``), the
reference-checkpoint import (``ckpt/torch_import.py``), the CSV, W&B and
TensorBoard loggers, ``Tee`` and ``Timer``, ``core/config.py``, the pretraining host readers and the packed-corpus writer
(``data/{seco,packed,native_loader}.py``, ``cli/pack_data.py``; the band
readers, ``MCTemporal``, the writer and the temporal packed readers are
held in tests/test_torch_pack_bands.py), the synthetic texture worlds and Voronoi scenes
(``utils/synthetic.py``), the numpy half of ``eval/retrieval.py``, the
BigEarthNet-19 nomenclature and LMDB reader of
``data/classification.py`` and ``data/loader.random_subset``. The same
inputs go through both; the outputs must be equal: state dicts key for key
and value for value, the same images decoded, the same CSV written, the
same arrays drawn.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.ckpt import torch_export, torch_import as jimport
from dinomc_tpu.data import classification as jcls_data
from dinomc_tpu.data import loader as jloader
from dinomc_tpu.data import native_loader as jnative
from dinomc_tpu.data import packed as jpacked
from dinomc_tpu.data import seco as jseco
from dinomc_tpu.eval import retrieval as jret
from dinomc_tpu.models import dino_head as jhead
from dinomc_tpu.models import resnet as jrn
from dinomc_tpu.models import upernet as jup
from dinomc_tpu.models import vit as jvit
from dinomc_tpu.utils import logging as jlog
from dinomc_tpu.utils import synthetic as jsyn
from dinomc_tpu_torch.ckpt import state_dicts
from dinomc_tpu_torch.ckpt import torch_import as timport
from dinomc_tpu_torch.data import classification as tcls_data
from dinomc_tpu_torch.data import loader as tloader
from dinomc_tpu_torch.data import native_loader as tnative
from dinomc_tpu_torch.data import packed as tpacked
from dinomc_tpu_torch.data import seco as tseco
from dinomc_tpu_torch.eval import retrieval as tret
from dinomc_tpu_torch.models import vit as tvit
from dinomc_tpu_torch.utils import logging as tlog
from dinomc_tpu_torch.utils import synthetic as tsyn
from _torch_port import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _assert_same(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k
        assert np.array_equal(ours[k], ref[k]), k


def _vit_tree():
    cfg = jvit.vit_test(patch_size=4, img_size=16)
    return jax.device_get(jvit.init_vit(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("prefix", ["", "backbone."])
def test_vit_and_head_state_dicts_are_the_exporters(prefix):
    _assert_same(state_dicts.vit_state_dict(_vit_tree(), prefix),
                 torch_export.vit_state_dict(_vit_tree(), prefix))
    head = jax.device_get(jhead.init_dino_head(jax.random.PRNGKey(1), jhead.DINOHeadConfig(
        in_dim=32, out_dim=64)))
    _assert_same(state_dicts.dino_head_state_dict(head, prefix),
                 torch_export.dino_head_state_dict(head, prefix))


@pytest.mark.parametrize("prefix,num_classes", [("", 0), ("backbone.", 0), ("", 7)])
def test_resnet_state_dict_is_the_exporter(prefix, num_classes):
    cfg = jrn.resnet_test(num_classes=num_classes)
    params, state = jax.device_get(jrn.init_resnet(jax.random.PRNGKey(3), cfg))
    _assert_same(state_dicts.resnet_state_dict(params, state, prefix),
                 torch_export.resnet_state_dict(params, state, prefix))


@pytest.mark.parametrize("neck", [False, True])
def test_upernet_state_dict_is_the_exporter(neck):
    cfg = jup.UPerNetConfig(num_classes=6, arch="vit_test", patch_size=4, out_indices=(0, 1, 2, 2),
                            channels=32, aux_channels=16, use_fpn_neck=neck)
    params, state = jax.device_get(jup.init_upernet(jax.random.PRNGKey(2), cfg))
    _assert_same(state_dicts.upernet_state_dict(params, state),
                 torch_export.upernet_state_dict(params, state))


@pytest.mark.parametrize("layout", ["dino", "bare", "ddp_state_dict"])
def test_torch_import_loads_what_the_jax_import_reads(tmp_path, layout):
    """A reference checkpoint in three layouts: the port's ``load_backbone``
    puts into a ViT exactly the tensors the JAX package's
    ``load_dino_backbone`` (strip, select, map) reads from it."""
    src = tvit.VisionTransformer(tvit.vit_test(img_size=16), torch.Generator().manual_seed(3))
    sd = src.state_dict()
    if layout == "dino":
        ckpt, key = {"teacher": {f"backbone.{k}": v for k, v in sd.items()}
                     | {"head.mlp.0.weight": torch.zeros(3, 3)}, "epoch": 1}, "teacher"
    elif layout == "bare":
        ckpt, key = dict(sd), None
    else:
        ckpt, key = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}, "teacher"
    path = tmp_path / "ckpt.pth"
    torch.save(ckpt, path)
    got = tvit.VisionTransformer(tvit.vit_test(img_size=16))
    timport.load_backbone(got, str(path), checkpoint_key=key)
    tree = jimport.load_dino_backbone(str(path), checkpoint_key=key, depth=3)
    ref = torch_export.vit_state_dict(tree)
    _assert_same({k: got.state_dict()[k].numpy() for k in ref}, ref)


def test_torch_import_names_what_is_missing(tmp_path):
    vit = tvit.VisionTransformer(tvit.vit_test(img_size=16))
    sd = {k: v for k, v in vit.state_dict().items() if k != "pos_embed"}
    torch.save({"teacher": sd}, tmp_path / "x.pth")
    with pytest.raises(KeyError, match=r"no tensor for \['pos_embed'\]"):
        timport.load_backbone(vit, str(tmp_path / "x.pth"))


def test_epoch_csv_and_wandb_logger_are_the_originals(tmp_path):
    rows = [(0, {"miou": 0.5, "acc": 0.75}, {"iou": [0.1, 0.9]}),
            (1, {"miou": 0.625, "acc": 0.8}, {"iou": [0.25, 1.0]})]
    for pkg, name in ((tlog, "ours.csv"), (jlog, "ref.csv")):
        for epoch, scalars, per_class in rows:
            pkg.write_epoch_csv(str(tmp_path / name), epoch, scalars, per_class=per_class,
                                class_names=["a", "b"])
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "ref.csv").read_text()
    off = tlog.WandbLogger("project", enabled=False)
    assert not off.active and not jlog.WandbLogger("project", enabled=False).active
    off.log({"x": 1.0})
    off.finish()


@pytest.fixture
def seco_tree(tmp_path):
    """Three locations of two PNG and JPEG images each, odd sizes."""
    rng = np.random.default_rng(4)
    root = tmp_path / "seco"
    for loc in range(3):
        d = root / f"loc{loc}"
        d.mkdir(parents=True)
        for j, ext in enumerate((".png", ".jpg")):
            img = rng.integers(0, 256, (30 + loc, 40 - loc, 3), dtype=np.uint8)
            Image.fromarray(img).save(d / f"t{j}{ext}")
    return root


def test_core_config_is_the_original(monkeypatch):
    """The presets, and the workspace paths with and without their
    ``DINOMC_*`` overrides."""
    import dataclasses

    from dinomc_tpu.core import config as jcfg
    from dinomc_tpu_torch.core import config as tcfg

    assert {k: dataclasses.asdict(v) for k, v in tcfg.VIT_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.VIT_PRESETS.items()}
    assert dataclasses.asdict(tcfg.SEG_TRAIN_PRESET) == dataclasses.asdict(jcfg.SEG_TRAIN_PRESET)
    for env in ({}, {"DINOMC_DATA_ROOT": "/d", "DINOMC_WEIGHTS_ROOT": "/w"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ours, ref = tcfg.Workspace(), jcfg.Workspace()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for call in (lambda w: w.dataset_dir("uavid"), lambda w: w.dataset_dir("udd6", 512),
                     lambda w: w.split_dir("potsdam", "val", 224), lambda w: w.pretrain_dir("r"),
                     lambda w: w.seg_dir("r"), lambda w: w.reference_weights("dino_mc/a.pth")):
            assert call(ours) == call(ref)


def test_tensorboard_tee_and_timer_are_the_originals(tmp_path, monkeypatch, capsys):
    """``TensorBoardLogger`` writes where the original writes and no-ops where
    it no-ops (its writer's package made unimportable); ``Tee`` mirrors
    stdout into the same file; ``Timer`` counts the same."""
    import sys

    for name, pkg in (("ours", tlog), ("ref", jlog)):
        tb = pkg.TensorBoardLogger(str(tmp_path / f"tb_{name}"))
        tb.scalar("loss", 1.5, 0)
        tb.image("img", np.zeros((4, 4, 3), np.float32), 0)
        tb.close()
    assert sorted(p.name.split(".")[0] for p in (tmp_path / "tb_ours").iterdir()) == \
        sorted(p.name.split(".")[0] for p in (tmp_path / "tb_ref").iterdir())
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    off = [pkg.TensorBoardLogger(str(tmp_path / "off")) for pkg in (tlog, jlog)]
    assert [lg.active for lg in off] == [False, False]
    off[0].scalar("x", 1.0, 0)
    off[0].close()

    for name, pkg in (("ours", tlog), ("ref", jlog)):
        with pkg.Tee(str(tmp_path / f"{name}.log")):
            print("line one")
            print("line", 2)
    assert (tmp_path / "ours.log").read_text() == (tmp_path / "ref.log").read_text() == \
        "line one\nline 2\n"
    assert capsys.readouterr().out == "line one\nline 2\n" * 2

    timers = [pkg.Timer(total=10) for pkg in (tlog, jlog)]
    assert [tm.eta for tm in timers] == [0.0, 0.0]
    for tm in timers:
        tm.update(4)
        assert tm.done == 4 and tm.elapsed >= 0 and tm.eta >= 0


def test_native_batch_decoder_is_the_original(seco_tree):
    """``decode_batch`` over every file of the tree at one size, and its
    ``None`` when a file does not decode, as the original's."""
    if not tnative.available():
        pytest.skip("the native image loader is not built here")
    files = sorted(str(p) for p in seco_tree.rglob("*.*"))
    ours, ref = tnative.decode_batch(files, 20, 16, 2), jnative.decode_batch(files, 20, 16, 2)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == (len(files), 20, 16, 3)
    np.testing.assert_array_equal(ours, ref)
    for f, img in zip(files, ours):
        np.testing.assert_array_equal(img, tnative.decode(f, 20, 16))
    bad = files + [str(seco_tree / "missing.png")]
    assert tnative.decode_batch(bad, 20, 16) is None and jnative.decode_batch(bad, 20, 16) is None


def test_host_readers_decode_what_the_originals_decode(seco_tree, tmp_path):
    assert tnative.available() == jnative.available()
    files = sorted(str(p) for p in seco_tree.rglob("*.*"))
    for f in files:
        for size in (None, 24):
            np.testing.assert_array_equal(tseco.read_image(f, size=size),
                                          jseco.read_image(f, size=size), err_msg=f"{f} {size}")
        if tnative.available():
            np.testing.assert_array_equal(tnative.decode(f, 20, 16), jnative.decode(f, 20, 16))
    for ours, ref in ((tseco.MCBase(str(seco_tree), image_size=24, seed=5),
                       jseco.MCBase(str(seco_tree), image_size=24, seed=5)),
                      (tseco.FlatImageFolder(str(seco_tree), image_size=24),
                       jseco.FlatImageFolder(str(seco_tree), image_size=24))):
        assert ours.samples == ref.samples and len(ours) == len(ref)
        for i in range(len(ref)):
            np.testing.assert_array_equal(ours[i], ref[i])

    out = tmp_path / "packed"
    jpacked.pack_dataset(str(seco_tree), str(out), size=16, records_per_shard=4)
    assert tpacked.is_packed(str(out)) and not tpacked.is_packed(str(seco_tree))
    for as_float in (False, True):
        ours = tpacked.PackedMC(str(out), seed=6, as_float=as_float)
        ref = jpacked.PackedMC(str(out), seed=6, as_float=as_float)
        assert ours.samples == ref.samples
        for i in range(len(ref)):
            np.testing.assert_array_equal(ours[i], ref[i])
    np.testing.assert_array_equal(tpacked.PackedReader(str(out)).batch([0, 5, 3]),
                                  jpacked.PackedReader(str(out)).batch([0, 5, 3]))


@pytest.mark.parametrize("family", ["v1", "v2", "v2m"])
@pytest.mark.parametrize("seed", [0, 1])
def test_texture_worlds_are_the_originals(family, seed):
    """Every family, at the learning check's 128 px and an odd size."""
    for size, n_per_class in ((128, 2), (37, 3)):
        ours = tsyn.make_texture_dataset(n_per_class, size, seed=seed, family=family)
        ref = jsyn.make_texture_dataset(n_per_class, size, seed=seed, family=family)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tsyn.NUM_CLASSES == jsyn.NUM_CLASSES and set(tsyn.TEXTURES) == set(jsyn.TEXTURES)


@pytest.mark.parametrize("family", ["v1", "v2", "v2m"])
@pytest.mark.parametrize("drift", ["color", "full"])
def test_change_pairs_and_seg_scenes_are_the_originals(family, drift):
    """The OSCD learning world's pairs and the Voronoi seg scenes, on the
    same seeds, at an odd size and with more changed cells than seeds."""
    for seed, size, n_seeds, n_change in ((0, 64, 6, 2), (3, 37, 4, 9)):
        ours = tsyn.make_change_pair(size, np.random.RandomState(seed), n_seeds=n_seeds,
                                     n_change=n_change, family=family, drift=drift)
        ref = jsyn.make_change_pair(size, np.random.RandomState(seed), n_seeds=n_seeds,
                                    n_change=n_change, family=family, drift=drift)
        ours += tsyn.make_seg_scene(size, np.random.RandomState(seed), n_seeds=n_seeds,
                                    family=family)
        ref += jsyn.make_seg_scene(size, np.random.RandomState(seed), n_seeds=n_seeds,
                                   family=family)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("whit", [None, 0.5])
def test_pca_is_the_original(whit):
    x = np.random.default_rng(10).standard_normal((40, 12)) @ np.diag(np.arange(1, 13))
    ours, ref = tret.PCA(dim=5, whit=whit).fit(x), jret.PCA(dim=5, whit=whit).fit(x)
    np.testing.assert_array_equal(ours.apply(x[:7]), ref.apply(x[:7]))


def test_retrieval_map_is_the_original():
    """Revisited-Oxford mAP with junk entries, an empty query and kappas."""
    rng = np.random.default_rng(11)
    ranks = np.stack([rng.permutation(30) for _ in range(4)], axis=1)  # (n_db, n_queries)
    gnd = [{"ok": [1, 5, 9], "junk": [2]}, {"ok": [0], "junk": []}, {"ok": []},
           {"ok": list(range(10, 20)), "junk": [3, 4]}]
    ours = tret.compute_map(ranks, gnd, kappas=(1, 5, 10))
    ref = jret.compute_map(ranks, gnd, kappas=(1, 5, 10))
    assert ours[0] == ref[0]
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    assert tret.compute_ap(np.array([0, 3, 7]), 4) == jret.compute_ap(np.array([0, 3, 7]), 4)


def test_ben19_nomenclature_is_the_original():
    """The 19 groups in order, and CLC-43 names to multi-hot: kept, merged,
    dropped, repeated, unknown and none."""
    assert tcls_data.BEN19_GROUPS == jcls_data.BEN19_GROUPS
    assert tcls_data.BEN19_CLASSES == jcls_data.BEN19_CLASSES
    clc = [name for group in jcls_data.BEN19_GROUPS.values() for name in group]
    rng = np.random.default_rng(12)
    cases = [[], ["Pastures"], ["Salines", "Salt marshes"], ["Pastures", "Pastures"],
             ["Airports", "Road and rail networks and associated land", "not a class"]]
    cases += [list(rng.choice(clc + ["Airports"], k)) for k in (1, 3, 6, 10)]
    for labels in cases:
        ours = tcls_data.clc_labels_to_multihot(labels)
        ref = jcls_data.clc_labels_to_multihot(labels)
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == (19,)
        np.testing.assert_array_equal(ours, ref, err_msg=str(labels))


@pytest.mark.parametrize("n,frac,seed", [(64, 0.5, 0), (1000, 0.1, 42), (7, 0.3, 3), (5, 1.0, 1),
                                         (10, 0.04, 2)])
def test_random_subset_is_the_original(n, frac, seed):
    ours, ref = tloader.random_subset(n, frac, seed=seed), jloader.random_subset(n, frac, seed=seed)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tloader.random_subset(n, frac), jloader.random_subset(n, frac))


def test_lmdb_reader_raises_as_the_original_without_lmdb(tmp_path, monkeypatch):
    """Both refuse with the same ``ImportError`` where ``lmdb`` cannot be
    imported (it is made unimportable here, wherever it is installed)."""
    import sys

    monkeypatch.setitem(sys.modules, "lmdb", None)
    msgs = []
    for mod in (tcls_data, jcls_data):
        with pytest.raises(ImportError, match="requires the 'lmdb' package") as err:
            mod.LMDBDataset(str(tmp_path / "x.lmdb"))
        msgs.append(str(err.value))
        with pytest.raises(ImportError):
            mod.make_lmdb([1], str(tmp_path / "y.lmdb"))
    assert msgs[0] == msgs[1]


def _imports_of_the_jax_package(path: Path):
    """(line, module) of every ``import dinomc_tpu...`` / ``from dinomc_tpu...``
    in a file, at any depth (inside functions too); the port itself excepted."""
    hits = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        hits += [(node.lineno, m) for m in names if m.split(".")[0] in ("dinomc_tpu", "jax")]
    return hits


def test_port_never_imports_the_jax_package():
    """An AST scan of every .py of the port, chip_smoke.py and the port's
    learning check."""
    files = sorted((REPO / "dinomc_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "validate_learning_torch.py",
        REPO / "scripts" / "oscd_learning_torch.py"]
    assert len(files) > 30
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"dinomc_tpu_torch/cli/{m}.py" for m in ("predict", "evaluate_stitched", "oscd",
                                                      "bigearthnet")} <= names
    assert "dinomc_tpu_torch/models/xcit.py" in names
    assert "dinomc_tpu_torch/cli/pack_data.py" in names
    assert {f"dinomc_tpu_torch/{m}.py" for m in (
        "cli/convert_ckpt", "cli/attention_video", "ckpt/torch_export", "ckpt/export",
        "ops/hopper/custom_ops", "utils/video_generation", "utils/profiling", "core/config",
    )} | {"scripts/oscd_learning_torch.py"} <= names
    found = {str(f.relative_to(REPO)): hits for f in files if (hits := _imports_of_the_jax_package(f))}
    assert not found, found


def test_the_scan_sees_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom dinomc_tpu_torch.ops import attention\n"
                   "def f():\n    from dinomc_tpu.data import packed\n    import jax.numpy\n")
    assert _imports_of_the_jax_package(src) == [(4, "dinomc_tpu.data"), (5, "jax.numpy")]
