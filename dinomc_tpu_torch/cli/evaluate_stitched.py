"""Tiled inference and stitched full-resolution evaluation (PyTorch).

Counterpart of ``dinomc_tpu/cli/evaluate_stitched.py``. It replaces the
reference's three stages (``utils/patch_cropper.py`` tiling,
``inference_*_patched_dataset.py`` per-patch ``.npy`` logits, ``evaluate.py``
stitching and streaming mIoU) with one command: each full-resolution frame
is tiled on the device, the model runs on the batch of tiles, the logits are
stitched into the frame's canvas, and per-class IoU / F1 and accuracy are
accumulated (``eval/metrics``' streaming statistics). ``--export_logits_dir``
also writes per-patch CHW ``.npy`` files and ``patches_metadata.json`` in the
reference's format (``eval/tiled_inference.stitch_from_files`` reads them
back).

``--data_root`` is a directory of ``{images,masks}`` pairs, loaded at their
native resolution, or ``synthetic`` (two 448 px frames from seed 0).
``--ckpt`` is as in ``cli/predict.py``: a reference ``.pth`` or a port
``train_seg`` checkpoint directory. The flags are the JAX CLI's plus
``--device``; ``--seq_parallel S`` under ``torchrun`` splits the backbone's
tokens over S ranks (as ``cli/predict.py``; rank 0 writes the exported
logits); a JAX orbax directory raises with the routes to a ``.pth``
(``cli/common.orbax_refusal``).
Each frame's canvas is copied to the host once, and only with
``--export_logits_dir``.

Run ``python -m dinomc_tpu_torch.cli.evaluate_stitched --data_root DIR``.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("stitched-eval (PyTorch)", add_help=False)
    p.add_argument("--dataset", default="uavid",
                   choices=["uavid", "udd6", "potsdam", "loveda"])
    p.add_argument("--data_root", default="synthetic", type=str,
                   help="dir with {images,masks} of FULL-RES pairs, or 'synthetic'")
    p.add_argument("--ckpt", default="", type=str,
                   help="a reference seg .pth, or a train_seg checkpoint directory")
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--grid", type=int, nargs=2, default=(2, 2))
    p.add_argument("--overlap_ratio", default=0.0, type=float)
    p.add_argument("--model_size", default=224, type=int)
    p.add_argument("--stitch_mode", default="paste", choices=["paste", "mean"])
    p.add_argument("--full_res", type=int, nargs=2, default=None,
                   help="resize stitched logits/GT to this (H, W); default native")
    p.add_argument("--export_logits_dir", default="", type=str)
    p.add_argument("--limit", default=0, type=int)
    p.add_argument("--seq_parallel", default=1, type=int,
                   help="ranks the backbone's tokens are split over (ring attention); "
                        "must divide the world size")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the model runs on (cuda, cuda:N or cpu)")
    return p


def _samples(args, spec):
    """(stem, image (H, W, 3) f32 [0, 1], mask (H, W) int32) at native size."""
    from dinomc_tpu_torch.data.seg_datasets import SegSampleIndex

    if args.data_root == "synthetic":
        rng = np.random.RandomState(0)
        for i in range(2):
            img = rng.rand(448, 448, 3).astype(np.float32)
            mask = rng.randint(0, spec.num_classes, (448, 448)).astype(np.int32)
            yield f"synthetic_{i}", img, mask
        return
    ds = SegSampleIndex(os.path.join(args.data_root, "images"),
                        os.path.join(args.data_root, "masks"), spec, image_size=None)
    for i in range(len(ds)):
        img, mask = ds.load(i, size=None)
        yield ds.stems[i], img, mask


def run(args, on_frame: Optional[Callable] = None):
    """Scores of the stitched evaluation. ``on_frame(stem, logits)``, if
    given, sees each frame's (H, W, C) logit canvas on the device. Runs in
    torchrun's process group where there is one."""
    from dinomc_tpu_torch.cli.common import in_process_group

    return in_process_group(_run, args, on_frame)


def _run(args, on_frame: Optional[Callable] = None):
    import torch

    from dinomc_tpu_torch.cli.common import seq_mesh
    from dinomc_tpu_torch.parallel import distributed as pd

    from dinomc_tpu_torch.cli.predict import load_seg_model
    from dinomc_tpu_torch.data import seg_datasets as sd
    from dinomc_tpu_torch.data.patching import (
        coords_to_metadata, custom_grid_coords, grid_coords, save_metadata,
    )
    from dinomc_tpu_torch.eval import metrics as M
    from dinomc_tpu_torch.eval.tiled_inference import tiled_predict
    from dinomc_tpu_torch.ops.augment import normalize, resize
    from dinomc_tpu_torch.train.seg_trainer import seg_predict

    mesh = seq_mesh(args.seq_parallel)
    device = pd.process_device(args.device)
    spec = sd.SPECS[args.dataset]
    model = load_seg_model(args, spec, device)
    export = args.export_logits_dir if pd.is_main_process() else ""

    def predict_fn(x):
        return seg_predict(model, x, mesh)

    stats = M.seg_stats_init(spec.num_classes, device)
    meta = {}
    n = 0
    for stem, img, mask in _samples(args, spec):
        H, W = img.shape[:2]
        x = normalize(torch.from_numpy(img).to(device), spec.mean, spec.std)
        mask = torch.from_numpy(mask).to(device)
        logits = tiled_predict(predict_fn, x, tuple(args.grid), args.model_size,
                               args.overlap_ratio, args.stitch_mode)
        if args.full_res is not None:
            fh, fw = args.full_res
            logits = resize(logits[None], (fh, fw), "bicubic")[0]
            mask = resize(mask[None, ..., None], (fh, fw), "nearest")[0, ..., 0]
        stats = M.seg_stats_update(stats, logits.argmax(-1), mask)
        if on_frame is not None:
            on_frame(stem, logits)

        if export:
            os.makedirs(export, exist_ok=True)
            if args.overlap_ratio > 0:
                coords = grid_coords(H, W, tuple(args.grid), args.overlap_ratio)
            else:
                coords = custom_grid_coords(H, W, *args.grid)
            meta.update(coords_to_metadata(coords, stem, cols=args.grid[1]))
            canvas = logits.cpu().numpy()  # the one copy of the frame to the host
            for ci, (y0, y1, x0, x1) in enumerate(coords):
                r, c = ci // args.grid[1], ci % args.grid[1]
                np.save(os.path.join(export, f"{stem}_{r}_{c}.npy"),
                        canvas[y0:y1, x0:x1].transpose(2, 0, 1))
        n += 1
        if args.limit and n >= args.limit:
            break

    if export:
        save_metadata(meta, os.path.join(export, "patches_metadata.json"))
    scores = M.seg_stats_finalize(stats)
    print(M.format_class_metrics_table(spec.classes, scores))
    print(f"images: {n}  mIoU {scores['miou']*100:.4f}  mF1 {scores['mf1']*100:.4f}  "
          f"acc {scores['acc']*100:.4f}")
    return scores


def main():
    args = argparse.ArgumentParser("evaluate_stitched", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
