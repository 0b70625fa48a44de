"""Segmentation fine-tuning entry point (UPerNet on DINO features), PyTorch.

Counterpart of ``dinomc_tpu/cli/train_seg.py``; parity target the
reference's ``train_dino_mc_seg.py`` / ``train_deit_seg.py`` /
``train_deit_seg_udd6.py`` (``train_dino_mc_seg.py:27-208``): AdamW
(3e-4, wd 1e-4) on a per-iteration cosine schedule, DiceCE loss,
decoder-only fine-tuning by default, per-epoch validation with the
per-class table, the best-mIoU checkpoint, and per-epoch CSV and JSONL
logs. The flags are the JAX CLI's plus ``--device``. Rerunning with the same
``--output_dir`` resumes from its newest checkpoint.

``--pretrained_ckpt`` takes a reference ``.pth`` (loaded by
``ckpt/torch_import.load_backbone`` with ``--checkpoint_key``, ``none`` for
Facebook DINO/DeiT files); ``--data_root
synthetic`` needs no dataset. Not ported yet, and refused with a pointer to
ROADMAP.md: an orbax checkpoint directory as ``--pretrained_ckpt``, and
``--seq_parallel > 1``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
from typing import List

import numpy as np

from dinomc_tpu_torch.cli.common import bool_flag


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("seg-finetune (PyTorch)", add_help=False)
    p.add_argument("--dataset", default="uavid",
                   choices=["uavid", "udd6", "potsdam", "loveda"])
    p.add_argument("--data_root", default="synthetic", type=str,
                   help="dir with train/{images,masks} and val/{images,masks}, "
                        "or 'synthetic'")
    p.add_argument("--arch", default="vit_small",
                   choices=["vit_tiny", "vit_small", "vit_base"])
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--pretrained_ckpt", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--train_backbone", default=False, type=bool_flag)
    p.add_argument("--train_decoder", default=True, type=bool_flag)
    p.add_argument("--use_aux_loss", default=False, type=bool_flag)
    p.add_argument("--use_fpn_neck", default=False, type=bool_flag)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--output_dir", default="seg_output", type=str)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--seq_parallel", default=1, type=int,
                   help="not ported yet: only 1 is accepted")
    p.add_argument("--wandb", default=False, type=bool_flag,
                   help="log per-epoch metrics to Weights & Biases (no-op "
                        "when the wandb package / login is unavailable)")
    p.add_argument("--wandb_project", default="dinomc_tpu_seg", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the step runs on (cuda, cuda:N or cpu)")
    return p


class _SyntheticSeg:
    """Random images and masks for smoke runs (no dataset needed)."""

    def __init__(self, n, size, num_classes):
        self.n, self.size, self.C = n, size, num_classes

    def __len__(self):
        return self.n

    def batches(self, batch_size, shuffle=False, seed=0, drop_last=True):
        rng = np.random.RandomState(seed)
        for _ in range(max(self.n // batch_size, 1)):
            imgs = rng.rand(batch_size, self.size, self.size, 3).astype(np.float32)
            masks = rng.randint(0, self.C, (batch_size, self.size, self.size))
            yield imgs, masks.astype(np.int32)


@dataclasses.dataclass
class SegSummary:
    """What a run returns: per-step losses, per-step device times (ms, CUDA
    events around augmentation + step; empty on the CPU), the last epoch's
    validation scores, the best mIoU and the final train state."""

    losses: List[float]
    step_ms: List[float]
    scores: dict
    best_miou: float
    state: object


def _refuse_unported(args) -> None:
    if args.seq_parallel > 1:
        raise NotImplementedError(
            "--seq_parallel > 1 is not ported yet (ROADMAP.md queue 1 #17, multi-device)")
    if args.pretrained_ckpt and not args.pretrained_ckpt.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"--pretrained_ckpt {args.pretrained_ckpt}: orbax checkpoint directories are "
            "not read by the port yet (ROADMAP.md queue 1 #18); pass a .pth file")


def _datasets(args, spec):
    from dinomc_tpu_torch.data.seg_datasets import SegSampleIndex

    if args.data_root == "synthetic":
        return (_SyntheticSeg(16, args.image_size, spec.num_classes),
                _SyntheticSeg(8, args.image_size, spec.num_classes))
    return tuple(
        SegSampleIndex(os.path.join(args.data_root, split, "images"),
                       os.path.join(args.data_root, split, "masks"),
                       spec, image_size=args.image_size)
        for split in ("train", "val")
    )


def _load_pretrained(state, args) -> None:
    from dinomc_tpu_torch.ckpt.torch_import import load_backbone

    key = None if args.checkpoint_key.lower() == "none" else args.checkpoint_key
    load_backbone(state.model.backbone.vit, args.pretrained_ckpt, checkpoint_key=key)
    print(f"loaded pretrained backbone from {args.pretrained_ckpt}")


def train_seg(args) -> SegSummary:
    import torch

    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.cli.common import StepLog, set_seed
    from dinomc_tpu_torch.core.schedules import cosine_scheduler
    from dinomc_tpu_torch.data import seg_datasets as sd
    from dinomc_tpu_torch.eval import metrics as M
    from dinomc_tpu_torch.models.upernet import UPerNetConfig
    from dinomc_tpu_torch.train.seg_trainer import (
        SegConfig, init_seg_train_state, seg_predict, seg_train_step,
    )
    from dinomc_tpu_torch.utils.logging import JsonlLogger, MetricLogger, WandbLogger, write_epoch_csv

    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    set_seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    spec = sd.SPECS[args.dataset]
    train_ds, val_ds = _datasets(args, spec)

    cfg = SegConfig(
        model=UPerNetConfig(
            num_classes=spec.num_classes, arch=args.arch, patch_size=args.patch_size,
            use_fpn_neck=args.use_fpn_neck,
        ),
        train_backbone=args.train_backbone,
        train_decoder=args.train_decoder,
        use_aux_loss=args.use_aux_loss,
        ignore_index=spec.ignore_index,
    )
    state = init_seg_train_state(cfg, args.seed, device)
    if args.pretrained_ckpt:
        _load_pretrained(state, args)

    niter = max(len(train_ds) // args.batch_size, 1)
    lrs = cosine_scheduler(args.lr, 1e-6, args.epochs, niter)
    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints", max_to_keep=1, best_mode="max")
    logger = JsonlLogger(f"{args.output_dir}/log.txt")
    wb = WandbLogger(args.wandb_project, name=f"{args.dataset}_{args.arch}",
                     config=vars(args), enabled=bool(args.wandb))
    aug_gen = torch.Generator(device=device).manual_seed(args.seed)
    best_miou, start_epoch = 0.0, 0
    # resume from this run's newest checkpoint (the reference seg trainers
    # cannot resume: best-only torch.save, train_dino_mc_seg.py:187-197)
    if ckpt.restore(state):
        start_epoch = min(ckpt.latest_step() + 1, args.epochs)
        print(f"resumed from checkpoint at epoch {start_epoch - 1}")

    steps, scores = StepLog(timed=device.type == "cuda"), {}
    for epoch in range(start_epoch, args.epochs):
        ml = MetricLogger()
        batches = train_ds.batches(args.batch_size, shuffle=True, seed=epoch)
        for images, masks in ml.log_every(batches, args.print_freq, f"Epoch [{epoch}]",
                                          total=niter):
            imgs = torch.from_numpy(images).to(device, non_blocking=True)
            msks = torch.from_numpy(masks).long().to(device, non_blocking=True)
            start = steps.begin()
            draws = sd.draw_seg_augment(aug_gen, imgs.shape[0], spec, device)
            imgs, msks = sd.augment_batch(imgs, msks, spec, draws)
            m = seg_train_step(state, imgs, msks, float(lrs[min(state.step, len(lrs) - 1)]),
                               args.weight_decay, cfg)
            steps.end(m["loss"], start)
            if state.step % args.print_freq == 0:
                loss = float(m["loss"])  # host sync
                steps.flush()
                if not math.isfinite(loss):
                    print(f"Loss is {loss}, stopping training")
                    sys.exit(1)
                ml.update(loss=loss, acc=float(m["pixel_acc"]))
            if args.max_steps and state.step >= args.max_steps:
                break

        # validation (per-class CM metrics, train_dino_mc_seg.py:129-164)
        stats = M.seg_stats_init(spec.num_classes, device)
        for images, masks in val_ds.batches(args.batch_size, seed=0):
            imgs, _ = sd.augment_batch(torch.from_numpy(images).to(device), None, spec)
            logits = seg_predict(state.model, imgs)
            stats = M.seg_stats_update(stats, logits.argmax(-1), torch.from_numpy(masks).to(device))
        scores = M.seg_stats_finalize(stats)
        print(M.format_class_metrics_table(spec.classes, scores))
        logger.write({"epoch": epoch, "miou": scores["miou"], "mf1": scores["mf1"],
                      "acc": scores["acc"]})
        if wb.active:
            # per-class IoU/F1 panels, as the reference logs them
            # (train_dino_mc_seg.py:171-185)
            wb.log({"epoch": epoch, "val/miou": scores["miou"], "val/mf1": scores["mf1"],
                    "val/acc": scores["acc"],
                    **{f"val/iou_{c}": v for c, v in zip(spec.classes, scores["iou"])},
                    **{f"val/f1_{c}": v for c, v in zip(spec.classes, scores["f1"])}},
                   step=epoch)
        write_epoch_csv(
            f"{args.output_dir}/metrics.csv", epoch,
            {"miou": scores["miou"], "mf1": scores["mf1"], "acc": scores["acc"]},
            per_class={"iou": scores["iou"], "f1": scores["f1"]},
            class_names=spec.classes,
        )
        if scores["miou"] >= best_miou:
            best_miou = scores["miou"]
            ckpt.save(epoch, state, metric=scores["miou"])
        if args.max_steps and state.step >= args.max_steps:
            break
    wb.finish()
    steps.flush()
    print(f"best mIoU: {best_miou:.4f}")
    return SegSummary(
        losses=steps.losses,
        step_ms=steps.step_ms,
        scores=scores,
        best_miou=best_miou,
        state=state,
    )


def main():
    args = argparse.ArgumentParser("seg", parents=[get_args_parser()]).parse_args()
    train_seg(args)


if __name__ == "__main__":
    main()
