"""BigEarthNet-19 multi-label classification entry point (PyTorch).

Counterpart of ``dinomc_tpu/cli/bigearthnet.py``; parity target
``main_bigearthnet.py``: an end-to-end fine-tune with
``MultiLabelSoftMarginLoss`` (``train/cls_trainer.cls_train_step`` with
``multilabel``, SGD with linearly scaled lr and cosine annealing), a
micro-mAP of the sigmoid scores over every (sample, class) decision of a
val pass that keeps its last partial batch (``:223-225,262``), the
patch-folder, LMDB or synthetic dataset, ``--train_frac`` fractional
subsets (the BigEarthNet-10% rows, ``:88-90``), best-mAP checkpoints and
restart from this run's newest checkpoint. A train batch is flipped and
normalized on the device.

The flags are the JAX CLI's plus ``--device``; ``--data_path synthetic``
needs no dataset. One device: the JAX CLI's data parallelism over every
chip (``make_mesh``) is not ported yet, and a torchrun launch of several
processes is refused (ROADMAP.md queue 1 #17). The default
``--arch resnet50`` runs with its BatchNorm, batch statistics in the train
step and running statistics in the val pass; XCiT's LPI BatchNorm reads
each val batch's statistics, as in the JAX package. ``--pretrained_weights``
takes a reference ``.pth`` (``cli/common.load_pretrained_backbone``).

Run ``python -m dinomc_tpu_torch.cli.bigearthnet --help``.
"""

from __future__ import annotations

import argparse

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("BigEarthNet (PyTorch)", add_help=False)
    p.add_argument("--arch", default="resnet50",
                   choices=["vit_tiny", "vit_small", "vit_base", "resnet50",
                            "wide_resnet50_2", "swin_t", "xcit_small_12", "xcit_medium_24"])
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--data_path", default="synthetic", type=str,
                   help="BigEarthNet patch-folder root, .lmdb path, or 'synthetic'")
    p.add_argument("--val_path", default="", type=str)
    p.add_argument("--train_frac", default=1.0, type=float)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("--batch_size_per_gpu", default=32, type=int)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--image_size", default=120, type=int)
    p.add_argument("--output_dir", default="ben_output", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the run uses (cuda, cuda:N or cpu)")
    return p


class _SyntheticML:
    def __init__(self, n, size=64, num_classes=19):
        self.n, self.size, self.C = n, size, num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        y = (rng.rand(self.C) > 0.8).astype(np.float32)
        return rng.rand(self.size, self.size, 3).astype(np.float32), y


def _batches(ds, indices, batch_size, shuffle, seed, drop_last=True):
    order = np.array(indices)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    end = len(order) - len(order) % batch_size if drop_last else len(order)
    for s in range(0, end, batch_size):
        items = [ds[int(i)] for i in order[s : s + batch_size]]
        yield np.stack([x for x, _ in items]), np.stack([y for _, y in items])


def run(args) -> float:
    """Fine-tune, score each epoch, keep the best; returns the best micro-mAP (%)."""
    import torch

    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.cli.common import ensure_dir, load_pretrained_backbone, set_seed
    from dinomc_tpu_torch.core.schedules import cosine_scheduler, linear_scaled_lr
    from dinomc_tpu_torch.data.classification import BigEarthNetFolder, LMDBDataset
    from dinomc_tpu_torch.data.loader import random_subset
    from dinomc_tpu_torch.eval.metrics import micro_map
    from dinomc_tpu_torch.ops import augment as aug
    from dinomc_tpu_torch.train.cls_trainer import (
        ClsConfig,
        cls_predict,
        cls_train_step,
        init_cls_train_state,
    )
    from dinomc_tpu_torch.utils.logging import JsonlLogger, MetricLogger

    from dinomc_tpu_torch.cli.common import refuse_multi_process

    refuse_multi_process("cli.bigearthnet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    set_seed(args.seed)
    ensure_dir(args.output_dir)
    global_batch = args.batch_size_per_gpu  # one device (ROADMAP.md queue 1 #17)

    def load_ds(path):
        if path == "synthetic":
            return _SyntheticML(64, 64)
        if path.endswith(".lmdb"):
            return LMDBDataset(path)
        return BigEarthNetFolder(path, image_size=args.image_size)

    train_ds = load_ds(args.data_path)
    val_ds = load_ds(args.val_path or args.data_path)
    idx = np.arange(len(train_ds))
    if args.train_frac < 1.0:  # the BigEarthNet-10% path
        idx = random_subset(len(train_ds), args.train_frac, seed=args.seed)
    if len(idx) < global_batch:
        # drop_last=True on a train set smaller than one batch yields ZERO
        # batches an epoch: fail loudly instead of training nothing
        raise SystemExit(
            f"train set ({len(idx)} samples) smaller than the batch "
            f"({global_batch} = --batch_size_per_gpu on one device); "
            "lower --batch_size_per_gpu")

    cfg = ClsConfig(arch=args.arch, patch_size=args.patch_size, num_classes=19, multilabel=True)
    state = init_cls_train_state(cfg, args.seed, device)
    if args.pretrained_weights:
        load_pretrained_backbone(state.model["backbone"], args.pretrained_weights,
                                 args.checkpoint_key)

    def evaluate() -> float:
        scores, labels = [], []
        for images, y in _batches(val_ds, np.arange(len(val_ds)), global_batch, False, 0,
                                  drop_last=False):
            x = aug.normalize(torch.from_numpy(images).to(device))
            scores.append(torch.sigmoid(cls_predict(state.model, x, cfg)).cpu().numpy())
            labels.append(y)
        return micro_map(np.concatenate(scores), np.concatenate(labels)) * 100.0

    niter = max(len(idx) // global_batch, 1)
    lrs = cosine_scheduler(linear_scaled_lr(args.lr, global_batch), 1e-6, args.epochs, niter)
    lrs = lrs.astype(np.float32)
    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints", max_to_keep=1, best_mode="max")
    logger = JsonlLogger(f"{args.output_dir}/log.txt")
    flip_gen = torch.Generator(device=device).manual_seed(args.seed)
    it, best, start_epoch = 0, 0.0, 0
    # restart_from_checkpoint parity (main_bigearthnet.py:134-151): resume
    # from the one checkpoint kept, the best epoch's
    if ckpt.restore(state):
        it = state.step
        start_epoch = min(ckpt.latest_step() + 1, args.epochs)
        print(f"resumed from checkpoint at epoch {start_epoch - 1}")
    for epoch in range(start_epoch, args.epochs):
        ml = MetricLogger()
        for images, y in ml.log_every(
            _batches(train_ds, idx, global_batch, True, epoch), args.print_freq,
            f"Epoch [{epoch}]", total=niter,
        ):
            x = torch.from_numpy(images).to(device)
            x = aug.normalize(aug.random_hflip(x, aug.draw_hflip(flip_gen, len(x), device=device)))
            m = cls_train_step(state, x, torch.from_numpy(y).to(device),
                               float(lrs[min(it, len(lrs) - 1)]), 0.0, cfg)
            it += 1
            if it % args.print_freq == 0:
                ml.update(loss=float(m["loss"]))
            if args.max_steps and it >= args.max_steps:
                break
        mAP = evaluate()
        print(f"epoch {epoch}: micro mAP {mAP:.2f}")
        logger.write({"epoch": epoch, "micro_map": mAP})
        if mAP >= best:
            best = mAP
            ckpt.save(epoch, state, metric=mAP)
        if args.max_steps and it >= args.max_steps:
            break
    print(f"best micro mAP: {best:.2f}")
    return best


def main():
    args = argparse.ArgumentParser("bigearthnet", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
