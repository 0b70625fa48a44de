#!/usr/bin/env python3
"""OSCD change-detection learning run of the PyTorch port.

Counterpart of ``scripts/oscd_learning.py``, with its flags, defaults,
world and result JSON, plus ``--device``. It builds a synthetic change-pair
world (``dinomc_tpu_torch.utils.synthetic.make_change_pair``: before/after
texture scenes where every cell's appearance drifts between acquisitions and
only the changed cells' texture class differs, so pixel differencing fails
by construction), DINO-pretrains the convnet encoder on the same texture
distribution (``cli.train_dino``: LARS, BN head, out_dim 1024, 2 locals of
64/48 px, 128 px images), converts the teacher's backbone to a reference
``.pth`` (``cli.convert_ckpt --what backbone --source teacher``), then
trains ``cli.oscd`` with the frozen pretrained encoder and, as the control,
with a frozen random one. The margin between the two isolates what the
pretraining taught. The pretraining runs ``ceil(steps * batch / corpus)``
epochs, so it takes ``--pretrain_steps`` steps (the JAX script's floor runs
2992 of its 3000).

The gate: the pretrained leg's best F1 at least ``--f1_bar`` and at least
the control's plus ``--margin``; exit 1 when it fails (not with
``--smoke``).

Run (one GPU): ``python scripts/oscd_learning_torch.py``. Smoke on the CPU
(``--pretrain_steps 0`` runs both legs from random init):
    python scripts/oscd_learning_torch.py --cities 2 --val_cities 1 \\
        --epochs 2 --pretrain_steps 0 --smoke --device cpu
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_world(root, n_cities, n_val, scene, family, seed=0,
                n_seeds=8, n_change=1, drift="color"):
    from PIL import Image

    from dinomc_tpu_torch.utils.synthetic import make_change_pair

    rng = np.random.RandomState(seed)
    names = []
    for i in range(n_cities + n_val):
        name = f"syncity_{i:03d}"
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        img1, img2, mask = make_change_pair(
            scene, rng, family=family, n_seeds=n_seeds, n_change=n_change, drift=drift)
        Image.fromarray((img1 * 255).astype(np.uint8)).save(f"{d}/t1.png")
        Image.fromarray((img2 * 255).astype(np.uint8)).save(f"{d}/t2.png")
        Image.fromarray((mask * 255).astype(np.uint8)).save(f"{d}/cm.png")
        names.append(name)
    return names[:n_cities], names[n_cities:]


def build_corpus(root, n, family, seed=1):
    """Single-texture pretrain corpus from the same distribution."""
    from PIL import Image

    from dinomc_tpu_torch.utils.synthetic import TEXTURES, colorize

    gen = TEXTURES[family]
    rng = np.random.RandomState(seed)
    for i in range(n):
        d = os.path.join(root, f"{i:05d}")
        os.makedirs(d, exist_ok=True)
        img = colorize(gen(i % 8, 128, rng), rng)
        Image.fromarray((img * 255).astype(np.uint8)).save(f"{d}/t0.png")


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default="", type=str)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--family", default="v1", choices=["v1", "v2"])
    ap.add_argument("--cities", default=24, type=int)
    ap.add_argument("--val_cities", default=8, type=int)
    ap.add_argument("--scene", default=288, type=int,
                    help="city scene size (tiled into 96 px triplets)")
    ap.add_argument("--corpus", default=512, type=int)
    ap.add_argument("--pretrain_steps", default=3000, type=int)
    ap.add_argument("--pretrain_batch", default=32, type=int)
    ap.add_argument("--epochs", default=60, type=int)
    ap.add_argument("--n_seeds", default=8, type=int, help="Voronoi cells per city scene")
    ap.add_argument("--n_change", default=1, type=int,
                    help="changed cells per pair; 1-of-8 cells ~= 12%% change pixels, "
                         "keeping the all-positive trivial baseline (F1 ~= 2p/(1+p) ~= 22) "
                         "far below a real detector")
    ap.add_argument("--batch_size", default=16, type=int)
    ap.add_argument("--drift", default="color", choices=["color", "full"],
                    help="acquisition drift in unchanged cells (make_change_pair): "
                         "'color' keeps structure, 'full' re-renders everything")
    ap.add_argument("--loss", default="dice_bce", choices=["bce", "dice_bce"],
                    help="dice_bce (reference option, main_oscd.py) handles the ~12%% "
                         "positive-pixel imbalance")
    ap.add_argument("--f1_bar", default=40.0, type=float,
                    help="required pretrained-chain F1 (all-positive trivial baseline at "
                         "the default 1-of-8 change fraction is ~22)")
    ap.add_argument("--margin", default=0.0, type=float,
                    help="required pretrained-over-random F1 margin (pts)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--device", default="cuda", type=str,
                    help="torch device every leg runs on (cuda, cuda:N or cpu)")
    return ap


def pretrain_args(args, corpus: str, out_dir: str):
    """``cli.train_dino``'s flags for the pretraining leg (the JAX script's
    set)."""
    from dinomc_tpu_torch.cli import train_dino

    a = train_dino.get_args_parser().parse_args([])
    epochs = max(math.ceil(args.pretrain_steps * args.pretrain_batch / args.corpus), 1)
    for k, v in dict(
        arch=args.backbone, out_dim=1024, optimizer="lars", use_bn_in_head=True,
        batch_size_per_gpu=args.pretrain_batch, epochs=epochs,
        max_steps=args.pretrain_steps, warmup_epochs=max(epochs // 20, 1),
        warmup_teacher_temp_epochs=max(epochs // 3, 1),
        local_crops_number=2, size_crops=[64, 48],
        global_crops_scale=(0.4, 1.0), local_crops_scale=(0.1, 0.4),
        momentum_teacher=0.99,
        # LARS recipe: base 0.3 * bs/256, wd 1e-6
        lr=0.3, weight_decay=1e-6, weight_decay_end=1e-6,
        data_path=corpus, image_size=128, output_dir=out_dir, print_freq=100,
        num_workers=2, saveckp_freq=0, device=args.device,
    ).items():
        assert hasattr(a, k), f"unknown arg {k}"
        setattr(a, k, v)
    return a


def main(argv=None) -> int:
    import torch

    args = get_args_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    work = args.workdir or tempfile.mkdtemp(prefix="oscd_learning_")
    os.makedirs(work, exist_ok=True)
    print(f"workdir: {work}", flush=True)
    t00 = time.time()

    # ------------------------------------------------------------ world --
    oscd_root = os.path.join(work, "oscd")
    if args.reuse and os.path.isdir(oscd_root):
        names = sorted(d for d in os.listdir(oscd_root) if d.startswith("syncity_"))
        train_c, val_c = names[: args.cities], names[args.cities:]
    else:
        train_c, val_c = build_world(
            oscd_root, args.cities, args.val_cities, args.scene, args.family,
            n_seeds=args.n_seeds, n_change=args.n_change, drift=args.drift)
    print(f"world: {len(train_c)} train / {len(val_c)} val cities "
          f"({time.time() - t00:.0f}s)", flush=True)

    # --------------------------------------------------------- pretrain --
    pth = os.path.join(work, "teacher_rn50.pth")
    pretrain_s = 0.0
    if args.pretrain_steps == 0:
        pth = ""  # wiring smoke: both legs from random init
    elif not (args.reuse and os.path.exists(pth)):
        from dinomc_tpu_torch.cli import convert_ckpt, train_dino

        corpus = os.path.join(work, "corpus")
        build_corpus(corpus, args.corpus, args.family)
        t0 = time.time()
        run = train_dino.train_dino(pretrain_args(args, corpus, os.path.join(work, "dino")))
        pretrain_s = time.time() - t0
        assert np.isfinite(run.last_loss), f"pretrain diverged: {run.last_loss}"
        convert_ckpt.run(convert_ckpt.get_args_parser().parse_args([
            "--ckpt", os.path.join(work, "dino", "checkpoints"),
            "--arch", args.backbone, "--what", "backbone",
            "--source", "teacher", "--out", pth,
        ]))
    print(f"[1/3] pretrained encoder at {pth} ({time.time() - t00:.0f}s)", flush=True)

    # ------------------------------------- change-detection fine-tunes --
    from dinomc_tpu_torch.cli import oscd as oscd_cli

    def run_oscd(tag, weights):
        out = os.path.join(work, f"oscd_{tag}")
        a = oscd_cli.get_args_parser().parse_args([])
        for k, v in dict(
            backbone=args.backbone, data_path=oscd_root, loss=args.loss,
            pretrained_weights=weights, freeze_encoder=True,
            train_cities=",".join(train_c), val_cities=",".join(val_c),
            epochs=args.epochs, batch_size=args.batch_size,
            output_dir=out, print_freq=20, device=args.device,
        ).items():
            assert hasattr(a, k), f"unknown arg {k}"
            setattr(a, k, v)
        best = oscd_cli.run(a).best_f1
        with open(f"{out}/log.txt") as f:
            traj = [json.loads(line) for line in f]
        return best, traj

    f1_pre, traj_pre = run_oscd("pretrained", pth)
    print(f"[2/3] frozen-PRETRAINED chain best F1 {f1_pre:.2f} "
          f"({time.time() - t00:.0f}s)", flush=True)
    f1_rand, traj_rand = run_oscd("random", "")
    print(f"[3/3] frozen-RANDOM control best F1 {f1_rand:.2f}", flush=True)

    dev = torch.device(args.device)
    result = {
        "metric": "oscd_learning_best_f1",
        "value": round(f1_pre, 2),
        "unit": "F1",
        "f1_random_control": round(f1_rand, 2),
        "final_iou_pretrained": round(traj_pre[-1]["iou"], 2),
        "trajectory_f1_pretrained": [round(t["f1"], 2) for t in traj_pre],
        "trajectory_f1_random": [round(t["f1"], 2) for t in traj_rand],
        "world": {"family": args.family, "train_cities": len(train_c),
                  "val_cities": len(val_c), "scene": args.scene,
                  "n_seeds": args.n_seeds, "n_change": args.n_change,
                  "drift": args.drift,
                  "all_positive_f1": round(
                      200.0 * (args.n_change / args.n_seeds)
                      / (1.0 + args.n_change / args.n_seeds), 1)},
        "pretrain_steps": args.pretrain_steps,
        "pretrain_seconds": round(pretrain_s, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "seconds": round(time.time() - t00, 1),
    }
    print(json.dumps(result), flush=True)
    with open(os.path.join(work, "oscd_learning.json"), "w") as f:
        json.dump(result, f)
    if args.smoke:
        return 0
    ok = f1_pre >= args.f1_bar and f1_pre >= f1_rand + args.margin
    print("OSCD LEARNING OK" if ok else
          f"OSCD LEARNING FAILED (bar {args.f1_bar}, margin {args.margin})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
