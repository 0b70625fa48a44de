"""End-to-end learning check of the PyTorch port.

The port's counterpart of ``scripts/validate_learning.py``, importing only
``dinomc_tpu_torch``: pretrains DINO-MC on the synthetic texture world
(``dinomc_tpu_torch/utils/synthetic.py``: 8 texture classes under heavy
nuisance variation, made in numpy from ``--seed``) and checks that frozen
5-NN accuracy of the teacher's features rises well above where it started.
Same recipe: ViT-tiny/16 at 96 px, 2 globals and 2 locals (64, 48 px),
out_dim 1024, AdamW, teacher momentum 0.99 -> 1.0, batch 64; the same
frozen 5-NN on 128 px images resized to 96 px (``jax.image.resize``'s
antialiased bilinear, ``ops/augment.resize``), the same linear probe
averaged over 3 split seeds, and the same endpoint averaging (the final
step and ``--endpoint_gap`` and twice that before it). ``--arch
resnet_test`` and ``resnet50`` run the JAX script's convnet recipe: LARS at
base lr 0.3 * batch / 256 and weight decay 1e-6, with BatchNorm in the
head (``docs/quality.md`` §2 says why those values); the k-NN and the probe
read the teacher's features with its running statistics.

Exit 0 only if the k-NN accuracy after >= max(before + 5, 50) (chance is
12.5%). The last line of standard output is one JSON object with the
trajectory, the endpoints, the wall time and the device.

Run: ``python scripts/validate_learning_torch.py [--steps 2000]
[--probe_every 500] [--device cuda]``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FEATURE_SIZE = 96


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("validate_learning_torch")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--probe_every", type=int, default=0,
                    help="also print k-NN accuracy every N steps (0 = only before/after)")
    ap.add_argument("--arch", default="vit_tiny",
                    choices=["vit_tiny", "vit_test", "swin_t", "resnet_test", "resnet50"],
                    help="vit_test is the tests' tiny ViT; the convnets run LARS and a BN head")
    ap.add_argument("--world", default="v1", choices=["v1", "v2", "v2m"],
                    help="texture world (utils/synthetic.TEXTURES)")
    ap.add_argument("--seed", type=int, default=0, help="seed of init, data and augmentation")
    ap.add_argument("--n_per_class", type=int, default=64,
                    help="corpus size: 8 classes x this")
    ap.add_argument("--endpoint_gap", type=int, default=500,
                    help="evaluate the endpoints at the final step and at -gap and "
                         "-2*gap and report their mean (0 = the final step alone)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    return ap


def features(backbone, enc, images, device):
    """Frozen features of ``images`` ((N, 128, 128, 3) numpy), resized to 96
    px, 128 images a forward; (N, D) f32 on ``device``."""
    import torch

    from dinomc_tpu_torch.ops.augment import resize

    out = []
    with torch.no_grad():
        for s in range(0, len(images), 128):
            x = torch.from_numpy(images[s:s + 128]).to(device)
            out.append(enc.apply(backbone, resize(x, (FEATURE_SIZE, FEATURE_SIZE), "bilinear")))
    return torch.cat(out)


def knn_acc(backbone, enc, images, labels, n_train, device) -> float:
    """Frozen 5-NN top-1 (%), the first ``n_train`` images the memory bank."""
    from dinomc_tpu_torch.eval.knn import knn_accuracy

    f = features(backbone, enc, images, device)
    return knn_accuracy(f[:n_train], labels[:n_train], f[n_train:], labels[n_train:],
                        ks=(5,), num_classes=8)[5]


def probe_acc(backbone, enc, images, labels, n_train, device) -> float:
    """Linear-probe top-1 (%), averaged over 3 seeded train/val splits."""
    from dinomc_tpu_torch.eval.linear_probe import train_linear_probe

    f = features(backbone, enc, images, device)
    n = len(images)
    accs = []
    for split_seed in range(3):
        order = np.random.RandomState(1000 + split_seed).permutation(n)
        tr, te = order[:n_train], order[n_train:]
        accs.append(train_linear_probe(f[tr], labels[tr], f[te], labels[te], num_classes=8,
                                       epochs=50, batch_size=256)["top1"])
    return float(np.mean(accs))


def run(args) -> dict:
    import torch

    from dinomc_tpu_torch.core import schedules
    from dinomc_tpu_torch.ops.augment import MultiCropConfig, draw_multicrop, multicrop_augment
    from dinomc_tpu_torch.train.dino_trainer import (
        DinoConfig,
        DinoSchedules,
        dino_train_step,
        init_dino_train_state,
    )
    from dinomc_tpu_torch.utils.synthetic import make_texture_dataset

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")

    images, labels_np = make_texture_dataset(n_per_class=args.n_per_class, seed=args.seed,
                                             family=args.world)
    n = len(images)
    n_train = int(n * 0.8)
    labels = torch.from_numpy(labels_np).to(device)

    is_bn = args.arch in ("resnet_test", "resnet50")
    cfg = DinoConfig(
        arch=args.arch, patch_size=16, out_dim=1024,
        niter_per_ep=50, global_crop_size=96, drop_path_rate=0.0, freeze_last_layer=1,
        # the reference's convnet recipe: LARS and BN in the head
        # (main_dino_mc.py:250-256,286)
        optimizer="lars" if is_bn else "adamw", use_bn_in_head=is_bn,
    )
    mc = MultiCropConfig(global_size=96, global_scale=(0.4, 1.0),
                         local_sizes=(64, 48), local_scale=(0.1, 0.4))
    epochs = max(args.steps // cfg.niter_per_ep, 1)
    # LARS's trust ratio scales every update to ~eta * lr * ||w||, so it
    # needs DINO's convnet lr, and weight decay small enough not to turn
    # the updates into pure shrinkage (docs/quality.md §2)
    base_lr = 0.3 * args.batch / 256.0 if is_bn else 1e-3
    wd = (1e-6, 1e-6) if is_bn else (0.04, 0.2)
    sch = DinoSchedules(
        lr=schedules.cosine_scheduler(base_lr, base_lr * 1e-2, epochs, cfg.niter_per_ep,
                                      warmup_epochs=2),
        wd=schedules.cosine_scheduler(*wd, epochs, cfg.niter_per_ep),
        # 0.99 -> 1.0: a 0.9995 teacher lags too long at a few thousand steps
        teacher_momentum=schedules.cosine_scheduler(0.99, 1.0, epochs, cfg.niter_per_ep),
        teacher_temp=schedules.teacher_temp_schedule(0.04, 0.07, max(epochs // 3, 1), epochs),
    )
    state = init_dino_train_state(cfg, args.seed, device)
    enc = cfg.encoder(student=False)

    def teacher_knn():
        return knn_acc(state.teacher["backbone"], enc, images, labels, n_train, device)

    def teacher_probe():
        return probe_acc(state.teacher["backbone"], enc, images, labels, n_train, device)

    acc_before = teacher_knn()
    print(f"k-NN acc before pretraining: {acc_before:.2f}% (chance = 12.5%)", flush=True)

    images_dev = torch.from_numpy(images).to(device)
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    data_rng = np.random.RandomState(args.seed + 2)
    ep_steps = {args.steps - 1}
    if args.endpoint_gap:
        ep_steps |= {args.steps - 1 - args.endpoint_gap, args.steps - 1 - 2 * args.endpoint_gap}
    trajectory, ep_knn, ep_probe, losses = {0: acc_before}, [], [], {}
    t0 = time.time()
    for step in range(args.steps):
        idx = torch.from_numpy(data_rng.randint(0, n, args.batch)).to(device)
        batch = images_dev[idx]
        B, H, W = batch.shape[:3]
        g, locals_ = multicrop_augment(batch, draw_multicrop(aug_gen, B, H, W, mc, device=device),
                                       mc)
        m = dino_train_step(state, g, locals_, sch, cfg)
        if step % 50 == 0 or step == args.steps - 1:
            losses[step] = float(m["loss"])
            print(f"step {step}: loss {losses[step]:.4f}  ({time.time() - t0:.0f}s)", flush=True)
            if not np.isfinite(losses[step]):
                print("NaN loss: failing")
                return {"ok": False, "knn_before": acc_before, "losses": losses}
        if args.probe_every and step and step % args.probe_every == 0:
            trajectory[step] = teacher_knn()
            print(f"  k-NN @ step {step}: {trajectory[step]:.2f}%", flush=True)
        if step in ep_steps and step > 0:
            ep_knn.append(teacher_knn())
            ep_probe.append(teacher_probe())
            trajectory[step] = ep_knn[-1]
            print(f"  endpoint snapshot @ step {step}: k-NN {ep_knn[-1]:.2f}%  "
                  f"probe {ep_probe[-1]:.2f}%", flush=True)
    seconds = time.time() - t0

    acc_after = float(np.mean(ep_knn)) if ep_knn else float("nan")
    lp_after = float(np.mean(ep_probe)) if ep_probe else float("nan")
    print(f"k-NN acc after {args.steps} steps: {acc_after:.2f}% "
          f"(mean of {len(ep_knn)} late snapshots, sd {float(np.std(ep_knn or [0])):.2f})")
    print(f"linear-probe acc after {args.steps} steps: {lp_after:.2f}% "
          f"(mean of {len(ep_probe)} late snapshots, sd {float(np.std(ep_probe or [0])):.2f})")
    ok = acc_after >= max(acc_before + 5.0, 50.0)
    print("LEARNING DEMONSTRATED" if ok else "INCONCLUSIVE (early-phase DINO; try more --steps)")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "ok": bool(ok), "arch": args.arch, "steps": args.steps, "seed": args.seed,
        "knn_before": acc_before, "knn_after": acc_after,
        "knn_after_sd": float(np.std(ep_knn)) if ep_knn else None,
        "probe_after": lp_after, "probe_after_sd": float(np.std(ep_probe)) if ep_probe else None,
        "knn_trajectory": trajectory, "endpoint_knn": ep_knn, "endpoint_probe": ep_probe,
        "losses": losses, "train_seconds": seconds, "device": kind,
    }


def main(argv=None) -> int:
    result = run(get_args_parser().parse_args(argv))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
