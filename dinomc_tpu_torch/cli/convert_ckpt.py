"""Convert the port's train-state checkpoints to reference-format ``.pth``.

Counterpart of ``dinomc_tpu/cli/convert_ckpt.py``, with the same flags. It
reads a ``ckpt/checkpoint.CheckpointManager`` directory (the newest
``ckpt_<step>.pth`` unless ``--step`` is given) or one ``ckpt_*.pth`` file,
tells the state's kind apart by its keys as the JAX CLI does (``student``,
``teacher`` and ``center``: DINO; a one-model ``model`` with a classifier:
cls; with a UPerNet decoder: seg; anything else: backbone) and writes it
through ``ckpt/torch_export.py``, which the reference's
``load_pretrained_weights`` (``utils/utils.py:75-119``) and the port's
``ckpt/torch_import.py`` read. Host-only: no ``--device``.

A JAX orbax directory is refused: orbax needs jax, and the JAX CLI
(``python -m dinomc_tpu.cli.convert_ckpt``, in the JAX environment) turns
one into a ``.pth``.

Usage:
    python -m dinomc_tpu_torch.cli.convert_ckpt --ckpt runs/mc/checkpoints \\
        --arch vit_small --out vit_mc.pth
    python -m dinomc_tpu_torch.cli.convert_ckpt --ckpt runs/mc/checkpoints \\
        --step 3000 --what backbone --source teacher --out teacher.pth
"""

from __future__ import annotations

import argparse
import os
import re

from dinomc_tpu_torch.cli.common import ORBAX_HINT

_NAME = re.compile(r"^ckpt_(\d+)\.pth$")


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("convert_ckpt (port checkpoint -> torch)", add_help=False)
    p.add_argument("--ckpt", required=True, type=str,
                   help="the port's CheckpointManager directory (ckpt_<step>.pth files) "
                        "or one ckpt_*.pth file")
    p.add_argument("--step", default=None, type=int,
                   help="step to export (default: latest)")
    p.add_argument("--arch", default="vit_small", type=str,
                   help="encoder architecture the state belongs to")
    p.add_argument("--what", default="auto",
                   choices=["auto", "dino", "seg", "cls", "backbone"],
                   help="'dino': full student+teacher pretrain checkpoint "
                        "(reference main_dino_mc.py layout); 'seg': UPerNet "
                        "seg checkpoint (reference train_dino_mc_seg.py "
                        "layout); 'cls': fine-tuned classifier (reference "
                        "main_eurosat.py layout); 'backbone': minimal "
                        "{key: backbone} file; 'auto' picks from the state")
    p.add_argument("--source", default="teacher", choices=["teacher", "student"],
                   help="which tower feeds a --what backbone export")
    p.add_argument("--checkpoint_key", default="teacher", type=str,
                   help="top-level key wrapping a --what backbone export "
                        "('none' for a bare state dict)")
    p.add_argument("--out", required=True, type=str)
    return p


def resolve_checkpoint(path: str, step=None) -> str:
    """A CheckpointManager directory -> the chosen step's file; a file is
    returned as it is. A directory with no ``ckpt_*.pth`` is refused."""
    if not os.path.isdir(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"--ckpt {path}: no such file or directory")
        return path
    steps = sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(path)) if m)
    if not steps:
        raise ValueError(f"--ckpt {path}: holds no port checkpoint (ckpt_<step>.pth); "
                         + ORBAX_HINT)
    chosen = int(step) if step is not None else steps[-1]
    if chosen not in steps:
        raise FileNotFoundError(f"step {chosen} not in {path} (have {steps})")
    return os.path.join(path, f"ckpt_{chosen:08d}.pth")


def kind_of(saved: dict) -> str:
    """What ``--what auto`` picks for a saved state (the JAX CLI's rule)."""
    if all(k in saved for k in ("student", "teacher", "center")):
        return "dino"
    model = saved.get("model") if isinstance(saved.get("model"), dict) else {}
    if "fc.kernel" in model:
        return "cls"
    if "decode_head.conv_seg.weight" in model:
        return "seg"
    return "backbone"


def run(args) -> str:
    import torch

    from dinomc_tpu_torch.ckpt import torch_export as tex

    path = resolve_checkpoint(args.ckpt, args.step)
    # weights_only: a port checkpoint holds tensors, ints and dicts only
    saved = torch.load(path, map_location="cpu", weights_only=True)
    kind = kind_of(saved)
    what = kind if args.what == "auto" else args.what
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    epoch = int(saved.get("step", 0))

    if what == "cls":
        if kind != "cls":
            raise ValueError(f"{path} is not a classification train state")
        out = tex.export_cls_checkpoint(args.out, args.arch, saved["model"], epoch=epoch)
    elif what == "seg":
        if kind != "seg":
            raise ValueError(f"{path} is not a seg train state")
        out = tex.export_seg_checkpoint(args.out, saved["model"], epoch=epoch)
    elif what == "dino":
        if kind != "dino":
            raise ValueError(f"{path} is not a DINO train state; use --what backbone "
                             "for bare state dicts")
        out = tex.export_dino_checkpoint(args.out, args.arch, saved["student"],
                                         saved["teacher"], epoch=epoch, center=saved["center"])
    else:
        if kind == "dino":
            sd = tex.strip_prefix(saved[args.source], "backbone.")
        elif "model" in saved:
            model = saved["model"]
            # a UPerNet's ViT sits under backbone.vit.
            sd = tex.strip_prefix(model, "backbone.vit.") or tex.strip_prefix(model, "backbone.")
        else:
            sd = tex.strip_prefix(saved, "backbone.") or saved
        key = None if args.checkpoint_key in ("", "none") else args.checkpoint_key
        out = tex.export_backbone(args.out, args.arch, sd, checkpoint_key=key)
    print(f"wrote {out}")
    return out


def main():
    args = argparse.ArgumentParser("convert_ckpt", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
