#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python scripts/profile_torch_step.py [--out_dir output_dir/profile] [--arch swin_t]
    python scripts/profile_torch_step.py --remat_policy off --mlp_impl fused
    python scripts/profile_torch_step.py --task seg [--train_backbone]

``--task dino`` (the default) drives the port's DINO-MC step
(``dinomc_tpu_torch``) at ViT-S/8 (or Swin-T with ``--arch swin_t``),
out_dim 65536, batch 8, under the ViT's ``--remat_policy`` (the CLI's, or
``off`` for ``ViTConfig.remat=False``) and ``--mlp_impl``; ``--task seg``
its UPerNet fine-tune step at ViT-S/8, 512 px (4097 tokens), batch 4, 8
classes, decoder-only unless ``--train_backbone``. Weights come from a
seed and random images are made on the device; the CLIs' flag defaults
apply, but not their loaders and logging. After 3 warm-up steps it takes
two windows:

1. **unprofiled**, 5 steps: CUDA events split each step into
   augmentation, forward and backward (DINO: teacher + student), and the
   optimizer (DINO: clip + AdamW + EMA; seg: AdamW); the host clock, with
   the device synchronized, times the whole step. Medians are reported.
2. **profiled**, 3 steps under ``torch.profiler``. From the
   exported trace: device busy time, the union of kernel, memcpy and memset
   intervals (user annotations are not device work and are left out); the
   traced span, from the first device event to the last; and the traced
   idle share, 1 - busy / span. The tracer costs host time, which lengthens
   the span and not the kernels, so the profiled wall time per step is
   printed beside the unprofiled one, and the idle share of an unprofiled
   step is derived as 1 - busy per step / unprofiled wall per step.

Also counted per profiled step: device kernels, pageable host-to-device
copies, stream synchronizations, launches of each hand-written kernel, and
the device time of each (from the trace, by kernel function name).
Writes ``summary.json``, ``ops.txt`` (the profiler's operator table) and
``trace.json.gz`` into ``--out_dir``, and prints the summary.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dinomc_tpu_torch.models.vit import MLP_IMPLS, REMAT_POLICIES  # noqa: E402
from dinomc_tpu_torch.ops.hopper import _build  # noqa: E402

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
WARMUP, STEPS, PROFILE_STEPS = 3, 5, 3
# hand-written kernels, by the prefix of their CUDA function names
KERNEL_FUNCS = ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel",
                "long_fwd_kernel", "long_dq_kernel", "long_dkv_kernel", "gray_partials_kernel",
                "photometric_kernel", "win_fwd_kernel", "win_bwd_kernel",
                "win_dbias_reduce_kernel", "wins_fwd_kernel", "wins_bwd_kernel",
                "wins_dbias_reduce_kernel", "fused_mlp_kernel")


def _busy_and_span(events):
    """Union length and first-to-last span (ms) of device intervals."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur_a, cur_b = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy / 1e3, (max(b for _, b in iv) - iv[0][0]) / 1e3


def _dino_step(dev, arch: str, remat_policy: str, mlp_impl: str):
    """The DINO-MC step at batch 8; returns (step(ev), batch, split names)."""
    import dataclasses

    from dinomc_tpu_torch.cli.train_dino import build_config, build_schedules, get_args_parser
    from dinomc_tpu_torch.ops.augment import draw_multicrop, multicrop_augment
    from dinomc_tpu_torch.train.dino_trainer import (
        _finish_step, dino_loss_and_grads, init_dino_train_state,
    )

    batch = 8
    args = get_args_parser().parse_args([
        "--arch", arch, "--patch_size", "8", "--out_dim", "65536",
        "--batch_size_per_gpu", str(batch),
        "--remat_policy", "attn" if remat_policy == "off" else remat_policy,
    ])
    niter = 1000
    mc_cfg, cfg = build_config(args, niter)
    sch = build_schedules(args, batch, niter)
    state = init_dino_train_state(cfg, args.seed, dev)
    if arch != "swin_t":
        for model in (state.student, state.teacher):
            model["backbone"].cfg = dataclasses.replace(
                model["backbone"].cfg, remat=remat_policy != "off", mlp_impl=mlp_impl)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    images = torch.rand(batch, args.image_size, args.image_size, 3, generator=gen, device=dev)

    def step(ev):
        ev[0].record()
        draws = draw_multicrop(gen, batch, args.image_size, args.image_size, mc_cfg, device=dev)
        g, locs = multicrop_augment(images, draws, mc_cfg)
        ev[1].record()
        it, epoch = state.step, state.step // niter
        loss, grads, center = dino_loss_and_grads(
            state, g, locs, float(sch.teacher_temp[epoch]), state.generator, cfg)
        ev[2].record()
        _finish_step(state, grads, loss, center, float(sch.lr[it]), float(sch.wd[it]),
                     float(sch.teacher_momentum[it]), epoch, cfg)
        ev[3].record()

    return step, batch, ("aug", "fwd_bwd", "clip_adamw_ema")


def _seg_step(dev, train_backbone: bool):
    """The UPerNet fine-tune step at 512 px, batch 4; as ``_dino_step``."""
    from dinomc_tpu_torch.cli.train_seg import get_args_parser
    from dinomc_tpu_torch.data import seg_datasets as sd
    from dinomc_tpu_torch.models.upernet import UPerNetConfig
    from dinomc_tpu_torch.train.seg_trainer import (
        SegConfig, finish_seg_step, init_seg_train_state, seg_loss_and_grads,
    )

    batch, size = 4, 512
    args = get_args_parser().parse_args([])
    spec = sd.SPECS["uavid"]
    cfg = SegConfig(model=UPerNetConfig(num_classes=spec.num_classes),
                    train_backbone=train_backbone)
    state = init_seg_train_state(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    images = torch.rand(batch, size, size, 3, generator=gen, device=dev)
    masks = torch.randint(0, spec.num_classes, (batch, size, size), generator=gen, device=dev)

    def step(ev):
        ev[0].record()
        draws = sd.draw_seg_augment(gen, batch, spec, dev)
        imgs, msks = sd.augment_batch(images, masks, spec, draws)
        ev[1].record()
        _, _, grads = seg_loss_and_grads(state, imgs, msks, cfg)
        ev[2].record()
        finish_seg_step(state, grads, args.lr, args.weight_decay, cfg)
        ev[3].record()

    return step, batch, ("aug", "fwd_bwd", "adamw")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out_dir", default="output_dir/profile")
    p.add_argument("--task", default="dino", choices=["dino", "seg"])
    p.add_argument("--train_backbone", action="store_true",
                   help="seg: train the ViT too (default: decoder-only)")
    p.add_argument("--arch", default="vit_small", choices=["vit_small", "swin_t"],
                   help="dino: the encoder (ViT-S/8 or Swin-T)")
    p.add_argument("--remat_policy", default="attn", choices=["off", *sorted(REMAT_POLICIES)],
                   help="dino, ViT: the block remat policy ('off': no remat)")
    p.add_argument("--mlp_impl", default="dense", choices=list(MLP_IMPLS),
                   help="dino, ViT: the MLP form ('fused': K11)")
    opt = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: torch sees no CUDA device")
    os.makedirs(opt.out_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)

    dev = torch.device("cuda")
    if opt.task == "seg":
        step_ev, batch, parts = _seg_step(dev, opt.train_backbone)
    else:
        step_ev, batch, parts = _dino_step(dev, opt.arch, opt.remat_policy, opt.mlp_impl)

    def step(ev=None):
        step_ev(ev or [torch.cuda.Event() for _ in range(4)])

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()

    split, wall = [], []
    for _ in range(STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        step(ev)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    med = [statistics.median(x) for x in zip(*split)]

    _build.LAUNCHES.clear()
    trace = os.path.join(opt.out_dir, "trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    launches = dict(_build.LAUNCHES)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    with open(trace, "rb") as f, gzip.open(trace + ".gz", "wb") as z:
        shutil.copyfileobj(f, z)
    os.remove(trace)
    with open(os.path.join(opt.out_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))

    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy, span = _busy_and_span(dev_events)
    n = PROFILE_STEPS
    per_step = lambda pred: sum(1 for e in events if pred(e)) / n  # noqa: E731
    kernel_ms = {
        f: sum(e["dur"] for e in dev_events if f in e["name"]) / 1e3 / n
        for f in KERNEL_FUNCS
    }
    summary = {
        "card": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "task": opt.task + ("+backbone" if opt.train_backbone else "")
        + (f" {opt.arch}" if opt.task == "dino" else "")
        + (f" remat={opt.remat_policy} mlp={opt.mlp_impl}" if opt.task == "dino" else ""),
        "batch": batch,
        "unprofiled_ms": {
            **dict(zip(parts, med)),
            "events_total": sum(med), "wall": statistics.median(wall),
            "wall_all": wall,
        },
        "images_per_s": batch / (statistics.median(wall) / 1e3),
        "profiled": {
            "steps": n,
            "wall_ms_per_step": prof_wall,
            "device_busy_ms_per_step": busy / n,
            "span_ms_per_step": span / n,
            "traced_idle_share": 1.0 - busy / span,
            "kernels_per_step": per_step(lambda e: e.get("cat") == "kernel"),
            "pageable_htod_per_step": per_step(
                lambda e: e.get("cat") == "gpu_memcpy" and "Pageable -> Device" in e["name"]),
            "stream_syncs_per_step": per_step(lambda e: e["name"] == "cudaStreamSynchronize"),
            "launches": launches,
            "kernel_ms_per_step": {k: v for k, v in kernel_ms.items() if v},
        },
        "derived_unprofiled_idle_share": 1.0 - (busy / n) / statistics.median(wall),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    with open(os.path.join(opt.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
