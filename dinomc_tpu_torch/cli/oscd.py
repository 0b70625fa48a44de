"""OSCD change-detection entry point (PyTorch).

Counterpart of ``dinomc_tpu/cli/oscd.py``; parity target ``main_oscd.py``:
``SiamSegment`` over a frozen pretrained ResNet encoder, BCE or dice_bce,
Adam(lr) with ExponentialLR(0.95) an epoch, binary precision / recall / F1 /
IoU at sigmoid > 0.5 over every validation tile, per-epoch
(img1 | img2 | gt | pred) panels under ``<output_dir>/panels`` (the
reference's TensorBoard panels, ``main_oscd.py:54-78``) and the best-F1
checkpoint (``main_oscd.py:28-185``). Rerunning with the same
``--output_dir`` resumes from its checkpoint, the best one, and starts from
its F1 (the JAX CLI starts a resumed run's best F1 from 0).

``--data_path`` is an OSCD root of ``<city>/{imgs_1,imgs_2,cm}`` split by the
official city lists (an 80/20 tile split when no city matches them), or
``synthetic``. ``--pretrained_weights`` is a reference ResNet ``.pth`` (a
DINO teacher under ``--checkpoint_key``, BatchNorm statistics included),
loaded into the encoder by ``ckpt/torch_import.load_backbone``; a JAX orbax
directory raises with the routes to a ``.pth`` (``cli/common.orbax_refusal``:
a port checkpoint through ``cli/convert_ckpt``, an orbax directory through the
JAX CLI ``python -m dinomc_tpu.cli.convert_ckpt``). The flags are the JAX
CLI's plus ``--device``; one device, so ``--batch_size`` is the batch (the
JAX CLI's data parallelism over every chip is ROADMAP.md queue 1 #17; a
torchrun launch of several processes is refused).

Run ``python -m dinomc_tpu_torch.cli.oscd --data_path synthetic``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List

import numpy as np

from dinomc_tpu_torch.cli.common import bool_flag


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("OSCD (PyTorch)", add_help=False)
    p.add_argument("--backbone", default="resnet50",
                   choices=["resnet50", "wide_resnet50_2"])
    p.add_argument("--data_path", default="synthetic", type=str,
                   help="OSCD root with <city>/{imgs_1,imgs_2,cm}, or 'synthetic'")
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--loss", default="bce", choices=["bce", "dice_bce"])
    p.add_argument("--train_cities", default="", type=str,
                   help="comma-separated city dirs; default: the official "
                        "OSCD 14-city train split")
    p.add_argument("--val_cities", default="", type=str,
                   help="comma-separated city dirs; default: the official "
                        "OSCD 10-city test split")
    p.add_argument("--freeze_encoder", default=True, type=bool_flag)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--output_dir", default="oscd_output", type=str)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--print_freq", default=5, type=int)
    p.add_argument("--panel_samples", default=8, type=int,
                   help="val samples visualized per epoch under "
                        "<output_dir>/panels (img1|img2|gt|pred strips, "
                        "the reference's per-sample TensorBoard panels, "
                        "main_oscd.py:54-78); 0 disables")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the run uses (cuda, cuda:N or cpu)")
    return p


def iter_index_batches(indices, global_batch, n_dev, shuffle, seed, trim=True):
    """Yield index chunks of up to ``global_batch``.

    trim=True (train): stop at the last full batch and trim each chunk to an
    ``n_dev`` multiple. trim=False (eval): go on to ``len(indices)``, so the
    last partial batch is yielded: the evaluation scores every sample.
    """
    order = np.array(indices)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    bs = global_batch
    end = len(order) if not trim else max(len(order) - len(order) % bs, bs)
    for s in range(0, end, bs):
        chunk = order[s : s + bs]
        if trim:
            chunk = chunk[: len(chunk) - len(chunk) % n_dev]
        if len(chunk) == 0:
            break
        yield chunk


class _SyntheticPairs:
    def __init__(self, n, size=96):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        x1 = rng.rand(self.size, self.size, 3).astype(np.float32)
        change = (rng.rand(self.size, self.size) > 0.9).astype(np.float32)
        x2 = np.clip(x1 + change[..., None] * 0.5, 0, 1).astype(np.float32)
        return x1, x2, change


@dataclasses.dataclass
class OSCDSummary:
    """What a run returns: the best validation F1 (%), each evaluated
    epoch's record (epoch, step, precision, recall, F1, IoU in %), per-step
    losses and device ms (CUDA events around upload + step; empty on the
    CPU), the epoch the run started at, and the final train state."""

    best_f1: float
    epochs: List[dict]
    losses: List[float]
    step_ms: List[float]
    start_epoch: int
    state: object


def _datasets(args):
    """(train dataset, train indices, val dataset, val indices)."""
    from pathlib import Path

    from dinomc_tpu_torch.data.oscd import TEST_CITIES, TRAIN_CITIES, OSCDTiles

    if args.data_path == "synthetic":
        train_ds = val_ds = _SyntheticPairs(32)
    else:
        # split by CITY (the official 14/10 protocol): an index split would
        # put tiles of one city on both sides
        train_c = args.train_cities.split(",") if args.train_cities else TRAIN_CITIES
        val_c = args.val_cities.split(",") if args.val_cities else TEST_CITIES
        present = {p.name for p in Path(args.data_path).iterdir() if p.is_dir()}
        if present & set(train_c) and present & set(val_c):
            train_ds = OSCDTiles(args.data_path, cities=train_c)
            val_ds = OSCDTiles(args.data_path, cities=val_c)
            print(f"city split: {len(train_ds)} train / {len(val_ds)} val tiles")
            return train_ds, np.arange(len(train_ds)), val_ds, np.arange(len(val_ds))
        print("city names match no OSCD split; using 80/20 tile split")
        train_ds = val_ds = OSCDTiles(args.data_path)
    n_val = max(len(train_ds) // 5, 1)
    n = len(train_ds)
    return train_ds, np.arange(n - n_val), val_ds, np.arange(n - n_val, n)


def run(args) -> OSCDSummary:
    import torch

    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.cli.common import StepLog, ensure_dir, load_pretrained_backbone, set_seed
    from dinomc_tpu_torch.data.oscd import collate_pairs
    from dinomc_tpu_torch.models.siamese import SiameseConfig
    from dinomc_tpu_torch.train.oscd_trainer import (
        OSCDConfig, exponential_lr, init_oscd_train_state, oscd_predict, oscd_train_step,
    )
    from dinomc_tpu_torch.utils.logging import JsonlLogger, MetricLogger
    from dinomc_tpu_torch.utils.visualization import save_change_panel

    from dinomc_tpu_torch.cli.common import refuse_multi_process

    refuse_multi_process("cli.oscd")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    set_seed(args.seed)
    ensure_dir(args.output_dir)
    n_dev = 1  # one device (ROADMAP.md queue 1 #17)
    global_batch = args.batch_size
    train_ds, train_idx, val_ds, val_idx = _datasets(args)
    if len(train_idx) < n_dev:
        raise SystemExit(f"train set ({len(train_idx)} tiles) is empty: every epoch "
                         "would train nothing")

    def batches(ds, indices, shuffle, seed, trim=True):
        for chunk in iter_index_batches(indices, global_batch, n_dev, shuffle, seed, trim):
            yield collate_pairs([ds[int(i)] for i in chunk])

    def upload(*arrays):
        return [torch.from_numpy(a).to(device, non_blocking=True) for a in arrays]

    cfg = OSCDConfig(
        model=SiameseConfig(arch=args.backbone, freeze_encoder=args.freeze_encoder),
        loss=args.loss,
    )
    state = init_oscd_train_state(cfg, args.seed, device)
    if args.pretrained_weights:
        # reference convnet DINO checkpoints (main_oscd.py loads RN50 / WRN
        # teachers): torchvision state dicts with their BatchNorm statistics
        load_pretrained_backbone(state.model.encoder, args.pretrained_weights,
                                 args.checkpoint_key)
        print(f"loaded pretrained encoder from {args.pretrained_weights}")

    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints", max_to_keep=1, best_mode="max")
    logger = JsonlLogger(f"{args.output_dir}/log.txt")

    def evaluate(epoch):
        """Precision, recall, F1 and IoU (%) over every validation tile."""
        panel_dir = None
        if args.panel_samples > 0:
            panel_dir = ensure_dir(f"{args.output_dir}/panels/epoch_{epoch:03d}")
        n_panels = 0
        counts = torch.zeros(3, dtype=torch.int64, device=device)  # tp, fp, fn
        for x1, x2, m in batches(val_ds, val_idx, False, 0, trim=False):
            x1d, x2d, md = upload(x1, x2, m)
            pred = torch.sigmoid(oscd_predict(state.model, x1d, x2d)) > 0.5
            gt = md > 0.5
            counts += torch.stack([(pred & gt).sum(), (pred & ~gt).sum(), (~pred & gt).sum()])
            if panel_dir is not None and n_panels < args.panel_samples:
                k = min(len(x1), args.panel_samples - n_panels)
                pk = pred[:k].float().cpu().numpy()
                for i in range(k):
                    save_change_panel(f"{panel_dir}/sample_{n_panels:02d}.png", x1[i], x2[i],
                                      (m[i] > 0.5).astype(np.float32), pk[i])
                    n_panels += 1
        tp, fp, fn = (float(c) for c in counts.cpu())
        prec = tp / max(tp + fp, 1.0)
        rec = tp / max(tp + fn, 1.0)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        iou = tp / max(tp + fp + fn, 1.0)
        return prec * 100, rec * 100, f1 * 100, iou * 100

    it, best_f1, start_epoch, records = 0, 0.0, 0, []
    # resume from this run's checkpoint (the reference's Lightning
    # ModelCheckpoint keeps the best weights only, main_oscd.py:173-180)
    if ckpt.restore(state):
        it = state.step
        start_epoch = min(ckpt.latest_step() + 1, args.epochs)
        best_f1 = max(ckpt.metrics().values(), default=0.0)
        print(f"resumed from checkpoint at epoch {start_epoch - 1}")
    steps = StepLog(timed=device.type == "cuda")
    for epoch in range(start_epoch, args.epochs):
        lr = exponential_lr(args.lr, epoch)
        ml = MetricLogger()
        for x1, x2, m in ml.log_every(
            batches(train_ds, train_idx, True, epoch), args.print_freq, f"Epoch [{epoch}]",
            total=max(len(train_idx) // global_batch, 1),
        ):
            start = steps.begin()
            metrics = oscd_train_step(state, *upload(x1, x2, m), lr, cfg)
            steps.end(metrics["loss"], start)
            it += 1
            if it % args.print_freq == 0:
                steps.flush()
                ml.update(loss=float(metrics["loss"]), f1=float(metrics["f1"]))
            if args.max_steps and it >= args.max_steps:
                break
        prec, rec, f1, iou = evaluate(epoch)
        print(f"epoch {epoch}: P {prec:.2f} R {rec:.2f} F1 {f1:.2f} IoU {iou:.2f}")
        record = {"epoch": epoch, "precision": prec, "recall": rec, "f1": f1, "iou": iou}
        logger.write(record)
        records.append({**record, "step": state.step})
        if f1 >= best_f1:
            best_f1 = f1
            ckpt.save(epoch, state, metric=f1)
        if args.max_steps and it >= args.max_steps:
            break
    steps.flush()
    print(f"best F1: {best_f1:.2f}")
    return OSCDSummary(best_f1=best_f1, epochs=records, losses=steps.losses,
                       step_ms=steps.step_ms, start_epoch=start_epoch, state=state)


def main():
    args = argparse.ArgumentParser("oscd", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
