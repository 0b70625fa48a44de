"""Port pretraining entry point (dinomc_tpu_torch/cli/train_dino.py) on the
CPU, with its checkpoints (ckpt/checkpoint.py) and host loader
(data/loader.py)."""

import json
import math
import weakref

import jax
import numpy as np
import pytest
import torch

from dinomc_tpu.data.loader import ShardedSampler as JShardedSampler
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.data.loader import PrefetchLoader, ShardedSampler
from dinomc_tpu_torch.train import dino_trainer as ttr
from _torch_port import n, one_torch_thread  # noqa: F401
from PIL import Image

SMOKE = [
    "--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--out_dim", "256",
    "--batch_size_per_gpu", "2", "--num_workers", "1", "--print_freq", "1",
]


def _args(tmp_path, *extra):
    return get_args_parser().parse_args(SMOKE + ["--output_dir", str(tmp_path), *extra])


def test_train_then_resume(tmp_path):
    first = train_dino(_args(tmp_path, "--max_steps", "2"))
    assert len(first.losses) == 2 and all(math.isfinite(x) for x in first.losses)
    assert first.step_ms == []  # device timing only on CUDA
    ckpts = CheckpointManager(tmp_path / "checkpoints")
    assert ckpts.steps() == [2]
    saved = torch.load(ckpts.path(2), weights_only=True)
    assert saved["step"] == 2
    assert (tmp_path / "log.txt").read_text().count("\n") == 1

    second = train_dino(_args(tmp_path, "--max_steps", "3"))
    assert len(second.losses) == 1 and math.isfinite(second.losses[0])
    assert second.state.step == 3
    assert ckpts.steps() == [2, 3]
    # the resumed run restored the AdamW counts before stepping on
    assert second.state.opt_state["count"]["backbone.cls_token"] == 3


def _image_folder(root, count, size=64):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(count):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / f"img_{i}.png")
    return str(root)


def test_epoch_line_holds_the_last_print_steps_loss(tmp_path):
    """Two epochs of two steps at --print_freq 2: each epoch's last step is
    not a print step, so log.txt holds the loss of the epoch's first step,
    the last one printed, as the JAX CLI writes it; the summary still has
    one loss a step."""
    data = _image_folder(tmp_path / "images", 4)
    out = train_dino(_args(tmp_path / "run", "--data_path", data, "--epochs", "2",
                           "--print_freq", "2"))
    assert len(out.losses) == 4 and len(set(out.losses)) == 4
    lines = [json.loads(x) for x in (tmp_path / "run" / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert [x["train_loss"] for x in lines] == [out.losses[0], out.losses[2]]


def test_pending_losses_never_exceed_print_freq(tmp_path, monkeypatch):
    """The CLI holds a step's loss tensor only until the next print step: of
    the loss tensors the steps returned, at most --print_freq are alive at
    any step, however long the run."""
    real, refs, alive = ttr.dino_train_step_accum, [], []

    def step(*args, **kwargs):
        alive.append(sum(r() is not None for r in refs))
        metrics = real(*args, **kwargs)
        refs.append(weakref.ref(metrics["loss"]))
        return metrics

    monkeypatch.setattr(ttr, "dino_train_step_accum", step)
    out = train_dino(_args(tmp_path, "--max_steps", "7", "--print_freq", "3"))
    assert len(out.losses) == 7 and all(math.isfinite(x) for x in out.losses)
    assert len(alive) == 7 and max(alive) <= 3, alive


@pytest.mark.parametrize("flags", [
    ["--data_mode", "tp", "--model_parallel", "2"], ["--model_parallel", "2"], ["--fsdp", "true"],
    ["--grad_accum_steps", "2", "--fsdp", "true"],
    ["--bands", "B4", "B3", "B2", "--model_parallel", "4"],
    # the convnets, LARS, XCiT, DINO-TP, --bands and --grad_accum_steps are
    # ported: with them, what is not is still refused
    ["--arch", "resnet50", "--model_parallel", "2"],
    ["--optimizer", "lars", "--fsdp", "true"],
    ["--arch", "xcit_small_12", "--model_parallel", "2"],
], ids=lambda f: f[0].lstrip("-") + "-" + f[1])
def test_unported_options_name_their_roadmap_item(tmp_path, flags):
    """A case's id is its first flag; in every case but [model_parallel-2]
    and [fsdp-true] the option refused is the multi-device one that follows
    a ported option. The refusal names queue 1 #17."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue 1 #17"):
        train_dino(_args(tmp_path, "--max_steps", "1", *flags))


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_dino(_args(tmp_path, "--max_steps", "1", "--device", "cuda"))


def test_checkpoint_round_trip_and_rotation(tmp_path):
    cfg = ttr.DinoConfig(arch="vit_test", patch_size=4, out_dim=32, global_crop_size=16)
    state = ttr.init_dino_train_state(cfg, seed=1)
    with torch.no_grad():
        for p in state.student.parameters():
            p.add_(0.5)
    state.opt_state["count"] = {k: 7 for k in state.opt_state["count"]}
    state.center = torch.arange(32, dtype=torch.float32)
    state.step = 9
    mgr = CheckpointManager(tmp_path, max_to_keep=2, keep_period=10)
    for step in (9, 10, 11, 12):
        state.step = step
        mgr.save(step, state)
    assert mgr.steps() == [10, 11, 12]  # 9 rotated out, 10 kept by period
    fresh = ttr.init_dino_train_state(cfg, seed=2)
    assert mgr.restore(fresh)
    assert fresh.step == 12
    for a, b in zip(fresh.student.state_dict().values(), state.student.state_dict().values()):
        assert torch.equal(a, b)
    assert fresh.opt_state["count"] == state.opt_state["count"]
    assert torch.equal(fresh.center, state.center)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    assert not CheckpointManager(tmp_path / "empty").restore(fresh)


def test_jax_train_state_loads_into_the_port():
    jcfg = jtr.DinoConfig(arch="vit_test", patch_size=4, out_dim=32, global_crop_size=16)
    tcfg = ttr.DinoConfig(arch="vit_test", patch_size=4, out_dim=32, global_crop_size=16)
    jstate = jtr.init_dino_train_state(jax.random.PRNGKey(3), jcfg)
    jstate = jstate.replace(center=jstate.center + 0.25, step=jstate.step + 4)
    tstate = ttr.init_dino_train_state(tcfg, seed=0)
    load_jax_params(tstate, jax.device_get(jstate))
    assert tstate.step == 4
    np.testing.assert_array_equal(n(tstate.center), 0.25)
    np.testing.assert_array_equal(
        n(tstate.student["backbone"].patch_embed.proj.bias),
        np.asarray(jstate.student["backbone"]["patch_embed"]["bias"]))
    np.testing.assert_array_equal(
        n(tstate.teacher["head"].last_layer.weight_v),
        np.asarray(jstate.teacher["head"]["last_layer"]["v"]).T)


@pytest.mark.parametrize("n_items,shards", [(10, 1), (11, 3), (2, 4)])
def test_sharded_sampler_matches_jax(n_items, shards):
    for shard in range(shards):
        ours = ShardedSampler(n_items, 2, num_shards=shards, shard_id=shard, seed=4)
        ref = JShardedSampler(n_items, 2, num_shards=shards, shard_id=shard, seed=4)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert [b.tolist() for b in ours] == [b.tolist() for b in ref]
            assert len(ours) == len(ref)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 13:
            raise ValueError("bad item 13")
        return np.full((2, 2, 3), i, np.uint8)


def test_prefetch_loader_order_and_errors():
    loader = PrefetchLoader(_Items(12), ShardedSampler(12, 4, shuffle=False), prefetch=1,
                            num_threads=3)
    batches = list(loader)
    assert [b[:, 0, 0, 0].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    assert all(b.dtype == torch.uint8 and b.device.type == "cpu" for b in batches)
    broken = PrefetchLoader(_Items(16), ShardedSampler(16, 4, shuffle=False), num_threads=1)
    with pytest.raises(ValueError, match="bad item 13"):
        list(broken)
