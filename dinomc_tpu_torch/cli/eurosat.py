"""EuroSAT land-use classification entry point (PyTorch).

Counterpart of ``dinomc_tpu/cli/eurosat.py``; parity target
``main_eurosat.py``: an end-to-end fine-tune (backbone and a 10-class
classifier, SGD with linearly scaled lr and cosine annealing,
``main_eurosat.py:101-107``), the train transform RandomResizedCrop(224) +
flip, the val transform Resize(256) -> CenterCrop(224) (``:57-98``),
best-accuracy checkpoints, and ``--evaluate``: top-1 and per-class
precision / recall / F1 from the confusion matrix (``:198-248``), of a
fine-tuned ``.pth`` that carries its classifier, else of this run's best
checkpoint. ``--evaluate_knn`` and ``--evaluate_probe`` run the k-NN and
linear-probe protocols on the frozen backbone.

The flags are the JAX CLI's plus ``--device``; ``--data_path synthetic``
needs no dataset. One device: the JAX CLI's data parallelism over every
chip (``make_mesh``) is not ported yet, and a torchrun launch of several
processes is refused (ROADMAP.md queue 1 #17). The
default ``--arch resnet50`` and ``wide_resnet50_2`` run with their
BatchNorm: batch statistics in the train step, running statistics in the
evaluations and the k-NN and probe features. XCiT runs with its LPI
BatchNorm on each batch's statistics, in the evaluations and the features
too (batches of ``--batch_size_per_gpu``, as in the JAX CLI);
``--pretrained_weights`` with it is refused, as in the JAX CLI: no
reference XCiT ``.pth`` maps onto either package's XCiT.

Run ``python -m dinomc_tpu_torch.cli.eurosat --help``.
"""

from __future__ import annotations

import argparse

import numpy as np

from dinomc_tpu_torch.cli.common import bool_flag


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("EuroSAT (PyTorch)", add_help=False)
    p.add_argument("--arch", default="resnet50",
                   choices=["vit_tiny", "vit_small", "vit_base", "resnet50",
                            "wide_resnet50_2", "swin_t", "xcit_small_12", "xcit_medium_24"])
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--data_path", default="synthetic", type=str,
                   help="root with train/ and val/ ImageFolder trees, or 'synthetic'")
    p.add_argument("--num_labels", default=10, type=int)
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--checkpoint_key", default="teacher", type=str)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--batch_size_per_gpu", default=32, type=int)
    p.add_argument("--lr", default=0.001, type=float,
                   help="scaled by global_batch/256 like the reference")
    p.add_argument("--evaluate", default=False, type=bool_flag)
    p.add_argument("--evaluate_knn", default=False, type=bool_flag)
    p.add_argument("--evaluate_probe", default=False, type=bool_flag)
    p.add_argument("--output_dir", default="eurosat_output", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the run uses (cuda, cuda:N or cpu)")
    return p


class _SyntheticCls:
    classes = [f"c{i}" for i in range(10)]

    def __init__(self, n, size=64, num_classes=10):
        self.n, self.size, self.C = n, size, num_classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.rand(self.size, self.size, 3).astype(np.float32), i % self.C


def _batches(ds, batch_size, shuffle, seed, drop_last=True):
    order = np.arange(len(ds))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    end = len(order) - len(order) % batch_size if drop_last else len(order)
    for s in range(0, end, batch_size):
        items = [ds[int(i)] for i in order[s : s + batch_size]]
        yield np.stack([x for x, _ in items]), np.asarray([y for _, y in items])


def run(args) -> float:
    import torch

    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.cli.common import ensure_dir, load_pretrained_backbone, set_seed
    from dinomc_tpu_torch.core.schedules import cosine_scheduler, linear_scaled_lr
    from dinomc_tpu_torch.data.classification import ImageFolderDataset, center_crop
    from dinomc_tpu_torch.eval import metrics as M
    from dinomc_tpu_torch.eval.knn import extract_features, knn_accuracy
    from dinomc_tpu_torch.eval.linear_probe import train_linear_probe
    from dinomc_tpu_torch.ops import augment as aug
    from dinomc_tpu_torch.train.cls_trainer import (
        ClsConfig,
        cls_predict,
        cls_train_step,
        init_cls_train_state,
    )
    from dinomc_tpu_torch.utils.logging import JsonlLogger, MetricLogger

    from dinomc_tpu_torch.cli.common import refuse_multi_process

    refuse_multi_process("cli.eurosat")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    set_seed(args.seed)
    ensure_dir(args.output_dir)
    global_batch = args.batch_size_per_gpu  # one device (ROADMAP.md queue 1 #17)

    if args.data_path == "synthetic":
        train_ds = _SyntheticCls(64, 64, args.num_labels)
        val_ds = _SyntheticCls(32, 64, args.num_labels)
        train_size = val_size = 64
    else:
        train_ds = ImageFolderDataset(f"{args.data_path}/train", image_size=256)
        val_ds = ImageFolderDataset(f"{args.data_path}/val", image_size=256)
        train_size, val_size = 224, 224

    cfg = ClsConfig(arch=args.arch, patch_size=args.patch_size, num_classes=args.num_labels)
    state = init_cls_train_state(cfg, args.seed, device)
    if args.pretrained_weights:
        load_pretrained_backbone(state.model["backbone"], args.pretrained_weights,
                                 args.checkpoint_key)

    def val_images(images):
        if images.shape[1] > val_size:
            images = center_crop(images, val_size)
        return aug.normalize(torch.from_numpy(np.ascontiguousarray(images)).to(device))

    def feats_fn(images):
        return cfg.encoder().apply(state.model["backbone"], val_images(images))

    if args.evaluate_knn or args.evaluate_probe:
        trf, trl = extract_features(feats_fn, _batches(train_ds, global_batch, False, 0))
        tef, tel = extract_features(feats_fn, _batches(val_ds, global_batch, False, 0))
        if args.evaluate_knn:
            accs = knn_accuracy(trf, trl, tef, tel, ks=(10, 20), num_classes=args.num_labels)
            print(f"k-NN top-1: {accs}")
            return max(accs.values())
        out = train_linear_probe(trf, trl, tef, tel, num_classes=args.num_labels, epochs=50)
        print(f"linear probe top-1: {out['top1']:.2f}")
        return out["top1"]

    def evaluate() -> float:
        cm = torch.zeros((args.num_labels, args.num_labels), dtype=torch.int64, device=device)
        for images, labels in _batches(val_ds, global_batch, False, 0, drop_last=False):
            logits = cls_predict(state.model, val_images(images), cfg)
            cm += M.confusion_matrix(logits.argmax(-1), torch.from_numpy(labels).to(device),
                                     args.num_labels)
        scores = M.cm2score(cm)
        # top-1 from the accumulated confusion matrix: sample-weighted, so a
        # smaller remainder batch (drop_last=False) is not overweighted the
        # way a mean of per-batch accuracies would be
        top1 = 100.0 * float(cm.diagonal().sum()) / max(float(cm.sum()), 1.0)
        print(f"top1 {top1:.2f}  per-class P/R/F1:")
        for i in range(args.num_labels):
            print(f"  class {i}: {float(scores['precision'][i]):.3f} "
                  f"{float(scores['recall'][i]):.3f} {float(scores['f1'][i]):.3f}")
        return top1

    if args.evaluate:
        # the reference's --evaluate loads a FINE-TUNED full model (the
        # checkpoint's 'state_dict' with its classifier, main_eurosat.py:71-80);
        # without one, score this run's best fine-tune checkpoint
        if args.pretrained_weights.endswith((".pth", ".pt", ".pth.tar")):
            from dinomc_tpu_torch.ckpt.torch_import import (
                load_cls_checkpoint,
                load_torch_state_dict,
            )

            sd = load_torch_state_dict(args.pretrained_weights, "state_dict")
            if "head.weight" in sd or "fc.weight" in sd:
                load_cls_checkpoint(state.model, args.pretrained_weights)
                print("loaded fine-tuned torch model (incl. classifier)")
                return evaluate()
        CheckpointManager(f"{args.output_dir}/checkpoints", max_to_keep=1,
                          best_mode="max").restore(state)
        return evaluate()

    if len(train_ds) < global_batch:
        # drop_last=True on a train set smaller than one batch yields ZERO
        # batches an epoch: fail loudly instead of training nothing
        raise SystemExit(
            f"train set ({len(train_ds)} samples) smaller than the batch "
            f"({global_batch} = --batch_size_per_gpu on one device); "
            "lower --batch_size_per_gpu")
    niter = max(sum(1 for _ in _batches(train_ds, global_batch, False, 0)), 1)
    lrs = cosine_scheduler(linear_scaled_lr(args.lr, global_batch), 1e-6, args.epochs, niter)
    lrs = lrs.astype(np.float32)
    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints", max_to_keep=1, best_mode="max")
    logger = JsonlLogger(f"{args.output_dir}/log.txt")
    aug_gen = torch.Generator(device=device).manual_seed(args.seed)
    it, best, start_epoch = 0, 0.0, 0
    # restart_from_checkpoint parity (main_eurosat.py:109-114): resume from
    # this run's newest checkpoint (a requeue reruns the same command)
    if ckpt.restore(state):
        it = state.step
        start_epoch = min(ckpt.latest_step() + 1, args.epochs)
        print(f"resumed from checkpoint at epoch {start_epoch - 1}")
    for epoch in range(start_epoch, args.epochs):
        ml = MetricLogger()
        for images, labels in ml.log_every(
            _batches(train_ds, global_batch, True, epoch), args.print_freq,
            f"Epoch [{epoch}]", total=niter,
        ):
            x = torch.from_numpy(images).to(device)
            # RandomResizedCrop(224) + flip (main_eurosat.py:57-63), draws first
            x = aug.eurosat_train_view(
                x, aug.draw_eurosat_view(aug_gen, *x.shape[:3], device=device), train_size)
            m = cls_train_step(state, x, torch.from_numpy(labels).to(device),
                               float(lrs[min(it, len(lrs) - 1)]), 0.0, cfg)
            it += 1
            if it % args.print_freq == 0:
                ml.update(loss=float(m["loss"]), acc=float(m["acc"]))
            if args.max_steps and it >= args.max_steps:
                break
        acc = evaluate()
        logger.write({"epoch": epoch, "val_acc": acc})
        if acc >= best:
            best = acc
            ckpt.save(epoch, state, metric=acc)
        if args.max_steps and it >= args.max_steps:
            break
    print(f"best val acc: {best:.2f}")
    return best


def main():
    args = argparse.ArgumentParser("eurosat", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
