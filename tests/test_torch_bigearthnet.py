"""Port BigEarthNet-19 (dinomc_tpu_torch/data/classification.py's
BigEarthNet half, cli/bigearthnet.py) against the JAX package, on the CPU.

The patch-folder reader decodes the same files to the same arrays and
multi-hot labels as the JAX package's (exactly: both read through the same
PIL calls); the CLI's flags are the JAX CLI's plus ``--device``; the CLI
fine-tunes on synthetic data, scores a micro-mAP over a val pass whose last
batch is partial, keeps its best checkpoint and resumes from it.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.cli import bigearthnet as jben
from dinomc_tpu.data import classification as jdata
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.cli import bigearthnet as tben
from dinomc_tpu_torch.data import classification as tdata
from dinomc_tpu_torch.eval.metrics import micro_map
from dinomc_tpu_torch.ops import augment as taug
from dinomc_tpu_torch.train import cls_trainer as tcls
from _torch_port import n, one_torch_thread  # noqa: F401

LABELS = [  # CLC-43 names: kept, merged into one BEN-19 class, or dropped
    ["Pastures", "Coniferous forest"],
    ["Continuous urban fabric", "Discontinuous urban fabric", "Sea and ocean"],
    ["Road and rail networks and associated land", "Mixed forest"],  # the first is dropped
    [],
    ["Salines", "Peatbogs", "Rice fields", "Olive groves"],
]


def write_patches(root, labels, size, seed, bands=("B02", "B03", "B04")):
    """A BigEarthNet patch-folder tree: a folder a patch with one PNG a band
    (``<patch>_B0x.png``) and ``<patch>_labels_metadata.json``."""
    rng = np.random.default_rng(seed)
    for i, names in enumerate(labels):
        name = f"S2A_MSIL2A_{i:04d}"
        d = os.path.join(root, name)
        os.makedirs(d)
        for band in bands:
            img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{name}_{band}.png"))
        with open(os.path.join(d, f"{name}_labels_metadata.json"), "w") as f:
            json.dump({"labels": names}, f)


@pytest.fixture
def ben_tree(tmp_path):
    root = str(tmp_path / "ben")
    write_patches(root, LABELS, 30, seed=0)
    # a patch whose images carry no band name, and whose json is named otherwise
    odd = os.path.join(root, "zz_odd")
    os.makedirs(odd)
    Image.fromarray(np.full((17, 23, 3), 90, np.uint8)).save(os.path.join(odd, "b.png"))
    Image.fromarray(np.full((17, 23, 3), 200, np.uint8)).save(os.path.join(odd, "a.png"))
    with open(os.path.join(odd, "meta.json"), "w") as f:
        json.dump({"labels": ["Vineyards"]}, f)
    return root


@pytest.mark.parametrize("size", [30, 24])
def test_folder_reads_what_the_jax_reader_reads(ben_tree, size):
    """Patches, images (B02 alone, as the original decodes ``(rgb or
    files)[0]``; the first image where no file names a band) and multi-hot
    labels, element for element."""
    ours = tdata.BigEarthNetFolder(ben_tree, image_size=size)
    ref = jdata.BigEarthNetFolder(ben_tree, image_size=size)
    assert ours.patches == ref.patches and len(ours) == len(ref) == len(LABELS) + 1
    for i in range(len(ref)):
        (xo, yo), (xr, yr) = ours[i], ref[i]
        assert xo.dtype == xr.dtype == np.float32 and xo.shape == (size, size, 3)
        np.testing.assert_array_equal(xo, xr)
        np.testing.assert_array_equal(yo, yr)
    b02 = os.path.join(ours.patches[0], os.path.basename(ours.patches[0]) + "_B02.png")
    expect = np.asarray(Image.open(b02).convert("RGB"), np.float32) / 255.0
    if size == 30:
        np.testing.assert_array_equal(ours[0][0], expect)
    assert ours[len(LABELS)][1].sum() == 1.0 and ours[len(LABELS)][0].max() == np.float32(200 / 255)


def test_cli_flags_are_the_jax_clis_plus_device():
    def flags(mod):
        return {a.dest: (a.default, a.choices, a.nargs, a.required)
                for a in mod.get_args_parser()._actions}

    ours, ref = flags(tben), flags(jben)
    assert ours.pop("device") == ("cuda", None, None, False)
    assert ours == ref


def test_synthetic_data_is_the_jax_clis():
    ours, ref = tben._SyntheticML(64, 64), jben._SyntheticML(64, 64)
    assert len(ours) == len(ref) == 64
    for i in (0, 5, 63):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)


# --- the CLI, on the CPU --------------------------------------------------

CLI = ["--arch", "vit_tiny", "--patch_size", "16", "--data_path", "synthetic",
       "--device", "cpu", "--print_freq", "1", "--batch_size_per_gpu", "24"]


def _cli(out_dir, *extra):
    args = tben.get_args_parser().parse_args(CLI + ["--output_dir", str(out_dir), *extra])
    return tben.run(args)


def _log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_scores_every_val_sample_and_resumes(tmp_path, capsys):
    """64 synthetic samples at B = 24: 2 train steps an epoch; val batches
    of 24, 24 and 16, every sample scored. The best mAP is that of the kept
    checkpoint's model over all 64; a rerun with more epochs resumes from
    it at the next epoch and trains on from its step."""
    out = tmp_path / "run"
    best = _cli(out, "--epochs", "1")
    assert math.isfinite(best) and 0.0 <= best <= 100.0
    assert [r["epoch"] for r in _log(out)] == [0] and _log(out)[0]["micro_map"] == best

    cfg = tcls.ClsConfig(arch="vit_tiny", patch_size=16, num_classes=19, multilabel=True)
    state = tcls.init_cls_train_state(cfg, seed=0)
    mgr = CheckpointManager(out / "checkpoints", max_to_keep=1, best_mode="max")
    assert mgr.steps() == [0] and mgr.restore(state) and state.step == 2
    ds = tben._SyntheticML(64, 64)
    images = np.stack([ds[i][0] for i in range(64)])
    labels = np.stack([ds[i][1] for i in range(64)])
    scores = torch.sigmoid(tcls.cls_predict(state.model, taug.normalize(torch.from_numpy(images)),
                                            cfg))
    assert best == pytest.approx(micro_map(n(scores), labels) * 100.0, abs=1e-9)

    capsys.readouterr()
    again = _cli(out, "--epochs", "2")
    assert "resumed from checkpoint at epoch 0" in capsys.readouterr().out
    assert [r["epoch"] for r in _log(out)] == [0, 1] and 0.0 <= again <= 100.0
    kept = mgr.steps()  # the better of the two epochs, the newer of equal ones
    assert kept in ([0], [1]) and mgr.restore(state) and state.step == {0: 2, 1: 4}[kept[0]]


def test_train_frac_and_the_small_train_set_refusal(tmp_path):
    """``--train_frac`` keeps ``random_subset``'s seeded fraction: half of
    64 is one batch of 32, trained; a quarter is smaller than the batch and
    refused, as the JAX CLI refuses it."""
    best = _cli(tmp_path / "half", "--batch_size_per_gpu", "32", "--train_frac", "0.5",
                "--epochs", "1")
    assert 0.0 <= best <= 100.0
    with pytest.raises(SystemExit, match="smaller than the batch"):
        _cli(tmp_path / "quarter", "--batch_size_per_gpu", "32", "--train_frac", "0.25")


def test_cli_runs_on_a_patch_folder_with_a_resnet(tmp_path):
    """The default ``--arch`` (a micro ResNet here) on a patch-folder tree of
    120 px band files, as the chip check writes it: 8 patches, B = 4, one
    epoch of 2 steps and a val pass."""
    root = str(tmp_path / "tree")
    rng = np.random.default_rng(1)
    names = [n_ for group in tdata.BEN19_GROUPS.values() for n_ in group]
    write_patches(root, [list(rng.choice(names, 3)) for _ in range(8)], 120, seed=2)
    args = tben.get_args_parser().parse_args([
        "--data_path", root, "--device", "cpu", "--batch_size_per_gpu", "4", "--epochs", "1",
        "--output_dir", str(tmp_path / "out"), "--print_freq", "1"])
    assert args.arch == "resnet50" and args.image_size == 120
    args.arch = "resnet_test"
    best = tben.run(args)
    assert 0.0 <= best <= 100.0 and _log(tmp_path / "out")[0]["micro_map"] == best


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tben.get_args_parser().parse_args(["--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tben.run(args)
