"""The port's pretraining and segmentation CLIs under ``python -m
torch.distributed.run --standalone --nproc_per_node 2`` on the CPU (gloo):
``train_dino --model_parallel 2`` (head tensor parallelism), ``train_dino
--fsdp true`` (ZeRO over a data axis of 2) and ``train_seg --seq_parallel 2``
(ring attention over 2 ranks) each run two steps and exit 0, and only rank 0
writes the checkpoints and the logs; ``predict`` and ``evaluate_stitched``
with ``--seq_parallel 2`` give the one-process run's prediction and scores.
The five launches run at once.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_mp import REPO

DINO = ["--device", "cpu", "--data_path", "synthetic", "--arch", "vit_tiny", "--patch_size",
        "16", "--out_dim", "256", "--batch_size_per_gpu", "2", "--num_workers", "1",
        "--print_freq", "1", "--max_steps", "2"]
SEG = ["--device", "cpu", "--dataset", "uavid", "--data_root", "synthetic", "--arch",
       "vit_tiny", "--patch_size", "16", "--image_size", "64", "--batch_size", "2",
       "--max_steps", "2", "--epochs", "1", "--print_freq", "1"]
TILED = ["--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--model_size", "64",
         "--seq_parallel", "2"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchrun")
    image = str(tmp / "image.png")
    Image.fromarray((np.random.RandomState(0).rand(96, 128, 3) * 255).astype("uint8")).save(image)
    runs = {
        "tp": ("train_dino", DINO + ["--model_parallel", "2"]),
        "fsdp": ("train_dino", DINO + ["--fsdp", "true"]),
        "seq": ("train_seg", SEG + ["--seq_parallel", "2"]),
        "predict": ("predict", TILED + ["--image", image, "--grid", "2", "2", "--out",
                                        str(tmp / "pred.png")]),
        "stitched": ("evaluate_stitched", TILED + ["--export_logits_dir",
                                                   str(tmp / "logits")]),
    }
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = {}
    for name, (cli, flags) in runs.items():
        out = str(tmp / name)
        if cli in ("train_dino", "train_seg"):
            flags = flags + ["--output_dir", out]
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", f"dinomc_tpu_torch.cli.{cli}", *flags],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    try:
        for name, (out, p) in procs.items():
            text, _ = p.communicate(timeout=300)
            done[name] = (out, p.returncode, text)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
    done["tmp"], done["image"] = tmp, image
    yield done
    shutil.rmtree(tmp)  # the runs' checkpoints


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_train_dino_two_ranks(launches, name):
    """Two steps at world 2; rank 0 alone writes one checkpoint (whole
    tensors: the last layer's moments at out_dim 256) and one log line."""
    out, code, text = launches[name]
    assert code == 0, text[-6000:]
    assert "mesh {'data': " in text
    files = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert files == ["ckpt_00000002.pth"], files
    saved = torch.load(os.path.join(out, "checkpoints", files[0]), weights_only=True)
    assert saved["step"] == 2
    assert saved["opt_state"]["mu"]["head.last_layer.weight_v"].shape == (256, 256)
    assert saved["opt_state"]["mu"]["backbone.blocks.0.attn.qkv.weight"].shape == (576, 192)
    lines = open(os.path.join(out, "log.txt")).read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["step"] == 2
    assert text.count("done: 2 steps") == 2  # each rank's summary


def test_train_seg_seq_parallel_two_ranks(launches):
    """``--seq_parallel 2``: the ring over both ranks, two steps and a
    validation pass; rank 0 alone writes the CSV row and the checkpoint."""
    out, code, text = launches["seq"]
    assert code == 0, text[-6000:]
    assert "sequence-parallel backbone: mesh {'data': 1, 'seq': 2, 'model': 1}" in text
    rows = open(os.path.join(out, "metrics.csv")).read().splitlines()
    assert len(rows) == 2  # header + epoch 0
    assert sorted(os.listdir(os.path.join(out, "checkpoints")))[0].startswith("ckpt_")
    assert len(open(os.path.join(out, "log.txt")).read().splitlines()) == 1


def test_predict_seq_parallel_two_ranks(launches):
    """``predict --grid 2 2 --seq_parallel 2``: rank 0 writes the colour
    mask, the one-process run's (f32 on the CPU; the ring's online softmax
    reassociates, so a pixel may tie differently: 99% agree)."""
    from dinomc_tpu_torch.cli import predict

    _, code, text = launches["predict"]
    assert code == 0, text[-6000:]
    assert text.count("saved color mask") == 1  # rank 0 alone
    args = predict.get_args_parser().parse_args(
        TILED[:-2] + ["--image", launches["image"], "--grid", "2", "2",
                      "--out", str(launches["tmp"] / "pred_one.png")])
    predict.run(args)
    ours = np.asarray(Image.open(launches["tmp"] / "pred.png"))
    ref = np.asarray(Image.open(launches["tmp"] / "pred_one.png"))
    assert ours.shape == ref.shape == (96, 128, 3)
    assert (ours == ref).all(-1).mean() >= 0.99


def test_evaluate_stitched_seq_parallel_two_ranks(launches):
    """``evaluate_stitched --seq_parallel 2`` on the synthetic frames: both
    ranks score them, rank 0 alone exports the per-patch logits."""
    _, code, text = launches["stitched"]
    assert code == 0, text[-6000:]
    assert text.count("images: 2  mIoU") == 1  # printed by rank 0 alone
    files = sorted(os.listdir(launches["tmp"] / "logits"))
    assert files[0] == "patches_metadata.json" and len(files) == 9  # 2 frames x 2 x 2 + 1
