"""Single-image segmentation prediction and visualization (PyTorch).

Counterpart of ``dinomc_tpu/cli/predict.py``; parity target the reference's
``inference_segmentation.py``, which is broken (it imports a nonexistent
``UPerNetDinoVit``, reads a nonexistent config entry and uses an undefined
``save_path``). This is the working equivalent: load a seg model, predict one
image, whole or tiled with ``--grid``, and save a colour mask and, with
``--figure``, a legend figure.

``--ckpt`` takes a reference mmseg ``.pth`` (``train_dino_mc_seg.py:190-197``
layout; its decoder widths are read from the file), or a directory of the
port's own ``train_seg`` checkpoints (``<output_dir>/checkpoints``, the
counterpart of the JAX package's orbax seg state); without it the weights
come from seed 0. The flags are the JAX CLI's plus ``--device``.
``--seq_parallel S`` under ``torchrun`` runs the backbone sequence-parallel
over S ranks (S must divide the world size; the JAX CLI's layout,
``dinomc_tpu/cli/predict.py:80-90``), and rank 0 writes the outputs. A JAX
orbax directory as ``--ckpt`` is refused with the routes to a ``.pth``
(``cli/common.orbax_refusal``).

Run ``python -m dinomc_tpu_torch.cli.predict --image frame.png --grid 2 2``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("predict (PyTorch)", add_help=False)
    p.add_argument("--image", required=True, type=str)
    p.add_argument("--dataset", default="uavid",
                   choices=["uavid", "udd6", "potsdam", "loveda"])
    p.add_argument("--ckpt", default="", type=str)
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--model_size", default=224, type=int)
    p.add_argument("--grid", type=int, nargs=2, default=None,
                   help="tile the image with this grid; default: whole-image")
    p.add_argument("--out", default="prediction.png", type=str)
    p.add_argument("--figure", default="", type=str,
                   help="also save a side-by-side legend figure here")
    p.add_argument("--seq_parallel", default=1, type=int,
                   help="ranks the backbone's tokens are split over (ring attention); "
                        "must divide the world size")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the model runs on (cuda, cuda:N or cpu)")
    return p


def load_seg_model(args, spec, device):
    """The UPerNet of ``--arch``/``--patch_size`` for ``spec``'s classes on
    ``device``, in eval use: weights from a reference ``.pth``, from the
    newest checkpoint of a port ``train_seg`` checkpoint directory, or from
    seed 0."""
    import torch

    from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
    from dinomc_tpu_torch.ckpt.torch_import import (load_upernet_checkpoint,
                                                    read_upernet_state_dict, upernet_widths)
    from dinomc_tpu_torch.cli.common import orbax_refusal
    from dinomc_tpu_torch.models.upernet import UPerNetConfig
    from dinomc_tpu_torch.train.seg_trainer import SegConfig, init_seg_train_state

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    sd = read_upernet_state_dict(args.ckpt) if args.ckpt.endswith((".pth", ".pt")) else None
    cfg = SegConfig(model=UPerNetConfig(
        num_classes=spec.num_classes, arch=args.arch, patch_size=args.patch_size,
        **(upernet_widths(sd) if sd is not None else {})))
    state = init_seg_train_state(cfg, 0, device)
    if sd is not None:
        load_upernet_checkpoint(state.model, sd)
        print(f"imported torch seg checkpoint from {args.ckpt}")
    elif args.ckpt:
        # checked before CheckpointManager, which would create a missing directory
        if not os.path.isdir(args.ckpt):
            raise FileNotFoundError(f"--ckpt {args.ckpt}: no such .pth file or directory")
        files = os.listdir(args.ckpt)
        if files and not any(f.startswith("ckpt_") and f.endswith(".pth") for f in files):
            raise orbax_refusal(f"--ckpt {args.ckpt} (no ckpt_*.pth in it)")
        if not CheckpointManager(args.ckpt).restore(state):
            raise FileNotFoundError(f"--ckpt {args.ckpt}: holds no checkpoint")
        print(f"restored seg checkpoint from {args.ckpt}")
    return state.model


def run(args):
    """Predict ``--image``, in torchrun's process group where there is one."""
    from dinomc_tpu_torch.cli.common import in_process_group

    return in_process_group(_run, args)


def _run(args):
    import torch
    from PIL import Image

    from dinomc_tpu_torch.cli.common import seq_mesh
    from dinomc_tpu_torch.parallel import distributed as pd
    from dinomc_tpu_torch.data import seg_datasets as sd
    from dinomc_tpu_torch.eval.tiled_inference import tiled_predict
    from dinomc_tpu_torch.ops.augment import normalize, resize
    from dinomc_tpu_torch.train.seg_trainer import seg_predict
    from dinomc_tpu_torch.utils.visualization import save_segmentation_figure

    mesh = seq_mesh(args.seq_parallel)
    device = pd.process_device(args.device)
    spec = sd.SPECS[args.dataset]
    model = load_seg_model(args, spec, device)

    img = np.asarray(Image.open(args.image).convert("RGB"), np.float32) / 255.0
    x = normalize(torch.from_numpy(img).to(device), spec.mean, spec.std)

    def predict_fn(batch):
        return seg_predict(model, batch, mesh)

    if args.grid:
        logits = tiled_predict(predict_fn, x, tuple(args.grid), args.model_size)
    else:
        s = args.model_size
        logits = predict_fn(resize(x[None], (s, s), "bicubic"))
        logits = resize(logits, img.shape[:2], "bicubic")[0]
    pred = logits.argmax(-1).to(torch.uint8).cpu().numpy()

    if not pd.is_main_process():
        return pred
    Image.fromarray(sd.class_to_rgb(pred, spec)).save(args.out)
    print(f"saved color mask to {args.out}")
    if args.figure:
        save_segmentation_figure(img, pred, spec.classes, spec.palette, args.figure)
        print(f"saved figure to {args.figure}")
    return pred


def main():
    args = argparse.ArgumentParser("predict", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
