"""The port's segmentation entry point (dinomc_tpu_torch/cli/train_seg.py) on
the CPU: a short synthetic run writes its logs and best checkpoint, a rerun
resumes from it, unported options name their ROADMAP item, a reference
``.pth`` backbone loads, and the CLI never imports jax."""

import csv
import json
import os
import subprocess
import sys
import weakref

import pytest
import torch

from dinomc_tpu_torch.cli.train_seg import get_args_parser, train_seg
from dinomc_tpu_torch.train import seg_trainer
from _torch_port import one_torch_thread, write_seg_folder  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--arch", "vit_tiny", "--patch_size", "8", "--image_size", "32",
        "--batch_size", "2", "--print_freq", "1"]


def _args(out_dir, *extra):
    return get_args_parser().parse_args(BASE + ["--output_dir", str(out_dir), *extra])


def test_train_then_resume(tmp_path):
    first = train_seg(_args(tmp_path, "--epochs", "2", "--max_steps", "2"))
    assert len(first.losses) == 2 and all(torch.isfinite(torch.tensor(first.losses)))
    assert 0.0 <= first.scores["miou"] <= 1.0 and first.best_miou == first.scores["miou"]
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ckpts == ["ckpt_00000000.pth", "metrics.json"]

    second = train_seg(_args(tmp_path, "--epochs", "2", "--max_steps", "4"))
    assert second.state.step == 4 and len(second.losses) == 2
    with open(tmp_path / "log.txt") as f:
        epochs = [json.loads(line)["epoch"] for line in f]
    assert epochs == [0, 1]
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"] and "iou/Building" in rows[0]
    kept = [p for p in os.listdir(tmp_path / "checkpoints") if p.endswith(".pth")]
    assert len(kept) == 1  # best mIoU only


def test_pending_losses_never_exceed_print_freq(tmp_path, monkeypatch):
    """The CLI holds a step's loss tensor only until the next print step: of
    the loss tensors the steps returned, at most --print_freq are alive at
    any step; the summary keeps one loss a step."""
    real, refs, alive = seg_trainer.seg_train_step, [], []

    def step(*args, **kwargs):
        alive.append(sum(r() is not None for r in refs))
        m = real(*args, **kwargs)
        refs.append(weakref.ref(m["loss"]))
        return m

    monkeypatch.setattr(seg_trainer, "seg_train_step", step)
    out = train_seg(_args(tmp_path, "--epochs", "1", "--max_steps", "5", "--print_freq", "2"))
    assert len(out.losses) == 5 and all(torch.isfinite(torch.tensor(out.losses)))
    assert len(alive) == 5 and max(alive) <= 2, alive


@pytest.mark.parametrize("flags", [["--seq_parallel", "2"], ["--pretrained_ckpt", "some_orbax_dir"]])
def test_unported_options_name_their_roadmap_item(tmp_path, flags):
    """--seq_parallel 2 in one process (world size 1) cannot divide the
    world size: a ValueError names it, as the JAX CLI's assert does (the
    two-rank run is in tests/test_torch_mp_cli.py); an orbax directory, done
    with in the port, names the converters that make a .pth."""
    if "--seq_parallel" in flags:
        with pytest.raises(ValueError, match="--seq_parallel 2 must divide the world size 1"):
            train_seg(_args(tmp_path, *flags))
        return
    with pytest.raises(NotImplementedError, match="cli.convert_ckpt"):
        train_seg(_args(tmp_path, *flags))


def test_pretrained_pth_backbone_loads(tmp_path):
    """A DINO checkpoint ({'teacher': {'backbone.*', 'head.*'}}) goes through
    the port's ``ckpt/torch_import.load_backbone`` into its ViT."""
    src = train_seg(_args(tmp_path / "a", "--epochs", "1", "--max_steps", "1",
                          "--train_backbone", "true")).state.model.backbone.vit
    sd = {f"backbone.{k}": v for k, v in src.state_dict().items()}
    sd["head.mlp.0.weight"] = torch.zeros(3, 3)
    torch.save({"teacher": sd}, tmp_path / "dino.pth")
    got = train_seg(_args(tmp_path / "b", "--epochs", "1", "--max_steps", "1",
                          "--pretrained_ckpt", str(tmp_path / "dino.pth")))
    vit = got.state.model.backbone.vit  # frozen backbone: still the loaded weights
    for k, v in src.state_dict().items():
        assert torch.equal(vit.state_dict()[k], v), k


def test_image_folder_dataset(tmp_path):
    """--data_root with train/{images,masks} and val/{images,masks}."""
    from dinomc_tpu_torch.data.seg_datasets import UDD6

    for split, n in (("train", 4), ("val", 2)):
        write_seg_folder(tmp_path / "data" / split, n, 40, UDD6, seed=len(split))
    out = train_seg(_args(tmp_path / "run", "--dataset", "udd6", "--data_root",
                          str(tmp_path / "data"), "--epochs", "1"))
    assert len(out.losses) == 2 and all(torch.isfinite(torch.tensor(out.losses)))
    assert out.scores["iou"].shape == (UDD6.num_classes,)


def test_cli_never_imports_jax():
    code = (
        "import sys\n"
        "import dinomc_tpu_torch.cli.train_seg as m\n"
        "import dinomc_tpu_torch.ckpt.checkpoint, dinomc_tpu_torch.data.seg_datasets\n"
        "import dinomc_tpu_torch.eval.metrics, dinomc_tpu_torch.train.seg_trainer\n"
        "import dinomc_tpu_torch.ckpt.torch_import, dinomc_tpu_torch.utils.logging\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'dinomc_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
