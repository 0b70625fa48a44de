"""``scripts/oscd_learning_torch.py``, the port's OSCD learning run, at
smoke size on the CPU, as tests/test_cli_smoke.py runs the JAX script.

The world is built on disk in the OSCD city layout, both frozen-encoder legs
train, and the result JSON carries every key the JAX script's result has
(read from that script's source) with the same world. A second run takes
one ResNet-50 DINO step at batch 4 before the legs, so the pretrain ->
convert -> load wiring runs too. Its F1 numbers at this size say nothing
about learning; the card's run at the defaults does (PERF.md).
"""

import ast
import importlib.util
import json
import os
from pathlib import Path

import pytest

from _torch_port import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMOKE = ["--cities", "2", "--val_cities", "1", "--epochs", "2", "--batch_size", "2",
         "--smoke", "--device", "cpu"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "oscd_learning_torch", REPO / "scripts" / "oscd_learning_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_result_keys():
    """The keys of the ``result`` dict literal in scripts/oscd_learning.py,
    and of its ``world`` entry."""
    tree = ast.parse((REPO / "scripts" / "oscd_learning.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            keys = {k.value: v for k, v in zip(node.value.keys, node.value.values)}
            return set(keys), {k.value for k in keys["world"].keys}
    raise AssertionError("no result dict in scripts/oscd_learning.py")


def test_smoke_from_random_init(tmp_path, capsys):
    assert _script().main(["--workdir", str(tmp_path), "--pretrain_steps", "0",
                           "--backbone", "resnet_test", *SMOKE]) == 0
    result = json.loads((tmp_path / "oscd_learning.json").read_text())
    keys, world = _jax_result_keys()
    assert keys <= set(result) and world == set(result["world"])
    assert result["metric"] == "oscd_learning_best_f1"
    assert len(result["trajectory_f1_pretrained"]) == len(result["trajectory_f1_random"]) == 2
    assert result["world"]["train_cities"] == 2 and result["world"]["val_cities"] == 1
    assert os.path.exists(tmp_path / "oscd" / "syncity_000" / "cm.png")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def test_one_pretraining_step_feeds_the_pretrained_leg(tmp_path, capsys):
    """ResNet-50, one DINO step at batch 4 on an 8-image corpus: the teacher
    is converted to a reference ``.pth`` and loaded by the pretrained leg."""
    assert _script().main(["--workdir", str(tmp_path), "--pretrain_steps", "1",
                           "--pretrain_batch", "4", "--corpus", "8", "--epochs", "1",
                           *SMOKE[:4], *SMOKE[6:]]) == 0
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 'teacher_rn50.pth'}" in out
    assert f"loaded pretrained encoder from {tmp_path / 'teacher_rn50.pth'}" in out
    assert (tmp_path / "dino" / "checkpoints" / "ckpt_00000001.pth").exists()
    result = json.loads((tmp_path / "oscd_learning.json").read_text())
    assert result["pretrain_steps"] == 1 and len(result["trajectory_f1_pretrained"]) == 1


def test_the_gate_exits_1_when_it_fails(tmp_path):
    """Without ``--smoke`` an unreachable bar fails the run with exit 1."""
    assert _script().main(["--workdir", str(tmp_path), "--pretrain_steps", "0",
                           "--backbone", "resnet_test", "--f1_bar", "101",
                           *[a for a in SMOKE if a != "--smoke"]]) == 1


def test_cuda_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script().main(["--workdir", str(tmp_path), "--device", "cuda"])
