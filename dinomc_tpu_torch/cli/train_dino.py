"""DINO-MC / DINO-TP self-supervised pretraining entry point (PyTorch).

Counterpart of ``dinomc_tpu/cli/train_dino.py``; parity target
``main_dino_mc.py`` (flags ``:46-151``, flow ``:154-416``). The flags are the
JAX CLI's plus ``--device``. Per step: draw and apply the on-device
multi-crop augmentation (``ops/augment.py``: ``multicrop_augment``, or
``multicrop_augment_tp`` under ``--data_mode tp``), then
``dino_train_step_accum`` over ``--grad_accum_steps`` microbatches (one is
``dino_train_step``, bit for bit).
Checkpoints are ``torch.save`` files with restart-from-latest
(``ckpt/checkpoint.py``); rerunning with the same ``--output_dir`` resumes.

Run ``python -m dinomc_tpu_torch.cli.train_dino --help``; ``--data_path
synthetic`` needs no dataset; ``--data_path`` also takes a SeCo-style tree
(a directory a location), a flat image folder or a packed corpus
(``cli/pack_data.py``). Every ``--arch`` of the JAX CLI runs, XCiT
(``xcit_small_12``, ``xcit_medium_24``) at the default ``--patch_size 8``
too, under its own remat (``--remat_policy`` is the ViT's). ``--data_mode
tp`` (DINO-TP: three timestamps a location, three global crops) runs from
synthetic data, image trees and packed corpora; ``--bands B4 B3 B2`` reads
multispectral Sentinel-2 bands.

Multi-card runs: ``torchrun --nproc_per_node N -m
dinomc_tpu_torch.cli.train_dino ...`` runs one process a card (NCCL; gloo
with ``--device cpu``), as the JAX CLI's flow does
(``dinomc_tpu/cli/train_dino.py:167-176,215-222``): the ranks form a
``data x model`` mesh (``--model_parallel M`` must divide the world size,
and splits the DINO head's last layer over M ranks), each rank loads its
shard of the data (``ShardedSampler``), the global batch is
``--batch_size_per_gpu`` times the world size and scales the lr, and every
rank draws the global batch's augmentation and keeps its rows. ``--fsdp
true`` splits the optimizer moments of the sizeable tensors over the data
axis (ZeRO); at data size 1 it is plain training, as in JAX. Logs and
checkpoints come from rank 0 only. Without torchrun's environment the
process runs alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from typing import List

import numpy as np

from dinomc_tpu_torch.cli.common import bool_flag
from dinomc_tpu_torch.models.vit import REMAT_POLICIES


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DINO-MC (PyTorch)", add_help=False)
    # model
    p.add_argument("--arch", default="vit_small", type=str,
                   choices=["vit_tiny", "vit_small", "vit_base", "resnet50",
                            "wide_resnet50_2", "swin_t", "xcit_small_12", "xcit_medium_24"])
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--out_dim", default=65536, type=int)
    p.add_argument("--norm_last_layer", default=True, type=bool_flag)
    p.add_argument("--momentum_teacher", default=0.996, type=float)
    p.add_argument("--use_bn_in_head", default=False, type=bool_flag)
    p.add_argument("--data_mode", default="mc", type=str, choices=["dino", "mc", "tp"])
    # teacher temperature
    p.add_argument("--warmup_teacher_temp", default=0.04, type=float)
    p.add_argument("--teacher_temp", default=0.04, type=float)
    p.add_argument("--warmup_teacher_temp_epochs", default=0, type=int)
    # optimization
    p.add_argument("--use_fp16", default=True, type=bool_flag,
                   help="accepted for parity; the port computes in bf16")
    p.add_argument("--weight_decay", default=0.04, type=float)
    p.add_argument("--weight_decay_end", default=0.4, type=float)
    p.add_argument("--clip_grad", default=3.0, type=float)
    p.add_argument("--batch_size_per_gpu", default=8, type=int)
    p.add_argument("--epochs", default=300, type=int)
    p.add_argument("--freeze_last_layer", default=1, type=int)
    p.add_argument("--lr", default=0.0005, type=float)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd", "lars"])
    p.add_argument("--drop_path_rate", default=0.1, type=float)
    # multi-crop
    p.add_argument("--global_crops_scale", type=float, nargs="+", default=(0.32, 1.0))
    p.add_argument("--global_crops_number", type=int, default=2)
    p.add_argument("--local_crops_number", type=int, default=6)
    p.add_argument("--size_crops", type=int, nargs="+", default=[184, 164, 144, 124, 104, 84])
    p.add_argument("--local_crops_scale", type=float, nargs="+", default=(0.05, 0.32))
    # misc
    p.add_argument("--data_path", default="synthetic", type=str,
                   help="SeCo-style root dir, a flat image folder, packed shards, "
                        "or 'synthetic' for a smoke run")
    p.add_argument("--image_size", default=256, type=int,
                   help="host-side decode/resize resolution before device aug")
    p.add_argument("--bands", default=None, type=str, nargs="+",
                   help="multispectral pretraining: exactly 3 Sentinel-2 band names "
                        "(e.g. --bands B4 B3 B2) read from multi-band tifs or per-band "
                        "{B}.tif directories, quantile-normalized; default plain RGB")
    p.add_argument("--output_dir", default="output_dir", type=str)
    p.add_argument("--saveckp_freq", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--max_steps", default=0, type=int,
                   help="stop after N optimizer steps (0 = full run)")
    p.add_argument("--model_parallel", default=1, type=int)
    p.add_argument("--fsdp", default=False, type=bool_flag)
    p.add_argument("--grad_accum_steps", default=1, type=int,
                   help="split each batch into N sequential microbatches and apply one "
                        "optimizer step on the averaged gradients; batch_size_per_gpu "
                        "must be divisible by N")
    p.add_argument("--remat_policy", default="attn", type=str,
                   choices=sorted(REMAT_POLICIES),
                   help="ViT selective rematerialization: which block "
                        "activations the backward keeps instead of recomputing "
                        "(all compute the same numbers; see models/vit.py)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the step runs on (cuda, cuda:N or cpu)")
    return p


def rank_rows(draw, rank: int, rows: int):
    """This rank's rows [rank * rows, (rank + 1) * rows) of every tensor in
    a ``CropDraw`` list or a ``TPDraw`` drawn for the global batch."""
    def cut(t):
        return t.narrow(0, rank * rows, rows)

    if isinstance(draw, list):
        return [dataclasses.replace(d, boxes=cut(d.boxes), params=cut(d.params)) for d in draw]
    return dataclasses.replace(
        draw, global_boxes=[cut(b) for b in draw.global_boxes],
        photo=[cut(p) for p in draw.photo], local_boxes=[cut(b) for b in draw.local_boxes])


class _SyntheticImages:
    """Random-image dataset for smoke runs (no datasets needed): (S, S, 3)
    items, or (4, S, S, 3) ``temporal`` ones."""

    def __init__(self, n: int, size: int, temporal: bool):
        self.n, self.size, self.temporal = n, size, temporal

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        if self.temporal:
            return rng.rand(4, self.size, self.size, 3).astype(np.float32)
        return rng.rand(self.size, self.size, 3).astype(np.float32)


def _dataset(args, world: int = 1):
    """The JAX CLI's routing (``dinomc_tpu/cli/train_dino.py:187-211``):
    synthetic; a packed corpus; ``MCTemporal`` for tp; ``MCBase``, then a
    flat image folder."""
    from dinomc_tpu_torch.data import packed
    from dinomc_tpu_torch.data.seco import FlatImageFolder, MCBase, MCTemporal

    temporal = args.data_mode == "tp"
    bands = args.bands
    if bands is not None:
        assert len(bands) == 3, (
            f"--bands takes exactly 3 band names (got {bands}): the "
            "augmentation chain (color jitter/grayscale/solarize) is "
            "defined on 3 channels, as the reference's RGB transforms are"
        )
    if args.data_path == "synthetic":
        return _SyntheticImages(max(args.batch_size_per_gpu * world * 4, 64), args.image_size,
                                temporal)
    if packed.is_packed(args.data_path):
        # decode-once shards: uint8 across PCIe, f32/255 on the device
        if temporal:
            return packed.PackedMCTemporal(args.data_path, seed=args.seed)
        return packed.PackedMC(args.data_path, seed=args.seed)
    if temporal:
        return MCTemporal(args.data_path, image_size=args.image_size, bands=bands)
    try:
        dataset = MCBase(args.data_path, image_size=args.image_size, bands=bands)
        if len(dataset) == 0:
            raise FileNotFoundError(args.data_path)
        return dataset
    except (FileNotFoundError, NotADirectoryError):
        return FlatImageFolder(args.data_path, image_size=args.image_size)


@dataclasses.dataclass
class TrainSummary:
    """What a run returns: the per-step losses, the per-step device times
    (ms, CUDA events around augmentation + step; empty on the CPU) and the
    final train state."""

    losses: List[float]
    step_ms: List[float]
    state: object

    @property
    def last_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


def build_config(args, niter_per_ep: int):
    from dinomc_tpu_torch.ops.augment import MultiCropConfig
    from dinomc_tpu_torch.train.dino_trainer import DinoConfig

    size_crops = list(args.size_crops)
    if len(size_crops) > args.local_crops_number:
        size_crops = size_crops[len(size_crops) - args.local_crops_number:]
    mc_cfg = MultiCropConfig(
        global_size=224,
        global_scale=tuple(args.global_crops_scale),
        local_sizes=tuple(size_crops),
        local_scale=tuple(args.local_crops_scale),
    )
    cfg = DinoConfig(
        arch=args.arch,
        patch_size=args.patch_size,
        out_dim=args.out_dim,
        norm_last_layer=args.norm_last_layer,
        use_bn_in_head=args.use_bn_in_head,
        drop_path_rate=args.drop_path_rate,
        clip_grad=args.clip_grad,
        freeze_last_layer=args.freeze_last_layer,
        optimizer=args.optimizer,
        niter_per_ep=niter_per_ep,
        remat_policy=args.remat_policy,
    )
    return mc_cfg, cfg


def build_schedules(args, global_batch: int, niter_per_ep: int):
    from dinomc_tpu_torch.core import schedules
    from dinomc_tpu_torch.train.dino_trainer import DinoSchedules

    return DinoSchedules(
        lr=schedules.cosine_scheduler(
            schedules.linear_scaled_lr(args.lr, global_batch), args.min_lr,
            args.epochs, niter_per_ep, warmup_epochs=args.warmup_epochs,
        ),
        wd=schedules.cosine_scheduler(
            args.weight_decay, args.weight_decay_end, args.epochs, niter_per_ep
        ),
        teacher_momentum=schedules.cosine_scheduler(
            args.momentum_teacher, 1.0, args.epochs, niter_per_ep
        ),
        teacher_temp=schedules.teacher_temp_schedule(
            args.warmup_teacher_temp, args.teacher_temp,
            args.warmup_teacher_temp_epochs, args.epochs,
        ),
    )


def train_dino(args) -> TrainSummary:
    """Run pretraining, in torchrun's process group where there is one
    (``cli/common.in_process_group``)."""
    from dinomc_tpu_torch.cli.common import in_process_group

    return in_process_group(_train_dino, args)


def _train_dino(args) -> TrainSummary:
    import torch

    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.cli.common import StepLog, set_seed
    from dinomc_tpu_torch.data.loader import PrefetchLoader, ShardedSampler
    from dinomc_tpu_torch.ops.augment import (
        draw_multicrop, draw_multicrop_tp, multicrop_augment, multicrop_augment_tp,
    )
    from dinomc_tpu_torch.train.dino_trainer import (
        dino_train_step_accum, init_dino_train_state,
    )
    from dinomc_tpu_torch.core.mesh import make_mesh, shard_dino_state
    from dinomc_tpu_torch.parallel import distributed as pd
    from dinomc_tpu_torch.utils.logging import JsonlLogger, MetricLogger

    world, rank = pd.get_world_size(), pd.get_rank()
    tp = max(1, args.model_parallel)
    if world % tp:
        raise ValueError(f"--model_parallel {tp} must divide the world size {world} "
                         "(the number of processes torchrun starts)")
    device = pd.process_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    set_seed(args.seed + rank)
    mesh = make_mesh(data=world // tp, model=tp)
    temporal = args.data_mode == "tp"
    accum = max(1, args.grad_accum_steps)
    assert args.batch_size_per_gpu % accum == 0, (
        f"grad_accum_steps={accum} must divide batch_size_per_gpu={args.batch_size_per_gpu}"
    )

    dataset = _dataset(args, world)
    b = args.batch_size_per_gpu
    global_batch = b * world
    sampler = ShardedSampler(len(dataset), b, num_shards=world, shard_id=rank, seed=args.seed)
    loader = PrefetchLoader(dataset, sampler, device=device, prefetch=2,
                            num_threads=max(1, args.num_workers))
    niter_per_ep = max(len(loader), 1)
    mc_cfg, cfg = build_config(args, niter_per_ep)
    sch = build_schedules(args, global_batch, niter_per_ep)

    state = init_dino_train_state(cfg, args.seed, device)
    ckpt = CheckpointManager(
        f"{args.output_dir}/checkpoints", max_to_keep=2,
        keep_period=args.saveckp_freq * niter_per_ep if args.saveckp_freq else None,
    )
    start_epoch = 0
    if ckpt.restore(state):
        start_epoch = state.step // niter_per_ep
        print(f"resumed from step {state.step} (epoch {start_epoch})")
    # head-TP placements over 'model' (+ ZeRO over 'data' with --fsdp);
    # nothing is split at model_parallel 1 without --fsdp, or alone
    shard_dino_state(mesh, state, fsdp=args.fsdp)
    if world > 1:
        print(f"mesh {mesh.shape}, global batch {global_batch}")

    logger = JsonlLogger(f"{args.output_dir}/log.txt") if pd.is_main_process() else None
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    steps = StepLog(timed=device.type == "cuda")
    last_loss = float("nan")  # the last print step's, carried across epochs
    done = False
    for epoch in range(start_epoch, args.epochs):
        sampler.set_epoch(epoch)
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)
        metric_logger = MetricLogger()
        for it, batch in enumerate(
            metric_logger.log_every(loader, args.print_freq, f"Epoch [{epoch}]")
        ):
            start = steps.begin()
            B, (H, W) = batch.shape[0], batch.shape[-3:-1]
            # every rank draws for the global batch and keeps its rows
            if temporal:  # (B, 4, H, W, 3)
                draws = draw_multicrop_tp(aug_gen, B * world, H, W, mc_cfg, device=device)
                g, locals_ = multicrop_augment_tp(batch, rank_rows(draws, rank, B), mc_cfg,
                                                  batch_first=True)
            else:
                draws = draw_multicrop(aug_gen, B * world, H, W, mc_cfg, device=device)
                g, locals_ = multicrop_augment(batch, rank_rows(draws, rank, B), mc_cfg)
            metrics = dino_train_step_accum(state, g, locals_, sch, cfg, accum=accum)
            steps.end(metrics["loss"], start)
            if it % args.print_freq == 0:
                last_loss = float(metrics["loss"])  # host sync
                steps.flush()
                if not math.isfinite(last_loss):
                    # NaN guard (main_dino_mc.py:378-380)
                    print(f"Loss is {last_loss}, stopping training")
                    sys.exit(1)
                metric_logger.update(loss=last_loss, lr=metrics["lr"], wd=metrics["wd"])
            if args.max_steps and state.step >= args.max_steps:
                done = True
                break
        metric_logger.synchronize_between_processes()
        ckpt.save(state.step, state)
        if logger is not None:
            logger.write({"epoch": epoch, "train_loss": last_loss, "step": state.step,
                          "time": time.time()})
        if done:
            break
    steps.flush()
    return TrainSummary(losses=steps.losses, step_ms=steps.step_ms, state=state)


def main():
    args = argparse.ArgumentParser("DINO-MC", parents=[get_args_parser()]).parse_args()
    summary = train_dino(args)
    print(f"done: {len(summary.losses)} steps, last loss {summary.last_loss:.6f}")


if __name__ == "__main__":
    main()
