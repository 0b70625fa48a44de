"""Self-attention video generation CLI (PyTorch).

Counterpart of ``dinomc_tpu/cli/attention_video.py``; parity target the
reference ``utils/video_generation.py:__main__`` (``:297-378``): load a DINO
ViT checkpoint, read a folder of frames (or extract them from a video, which
needs cv2), render thresholded CLS-attention heatmaps and write a video (a
GIF through PIL where cv2 is missing). The flags are the JAX CLI's plus
``--device``. ``--pretrained_weights`` is a reference ``.pth`` read by
``cli/common.load_pretrained_backbone``, which refuses an orbax directory
with the routes to a ``.pth``; with none, the weights are random, drawn from
seed 0, and a notice says so (the reference's download of Facebook DINO
weights is not made: no network).

Usage:
    python -m dinomc_tpu_torch.cli.attention_video \\
        --input_path frames/ --output_path runs/attn.mp4 \\
        --pretrained_weights model_weights/dino_mc/vit_mc_checkpoint300.pth
"""

from __future__ import annotations

import argparse
import math
import os


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("attention_video (PyTorch)", add_help=False)
    p.add_argument("--arch", default="vit_small",
                   choices=["vit_tiny", "vit_small", "vit_base"])
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--pretrained_weights", default="", type=str,
                   help="torch .pth checkpoint; empty runs with random weights "
                        "(reference parity)")
    p.add_argument("--checkpoint_key", default="teacher", type=str,
                   help='"teacher" / "student" / "none"')
    p.add_argument("--input_path", required=True, type=str,
                   help="video file or folder of frame images")
    p.add_argument("--output_path", default="attention.mp4", type=str)
    p.add_argument("--threshold", default=0.6, type=float,
                   help="keep the smallest patch set holding this fraction "
                        "of each head's attention mass; <=0 disables")
    p.add_argument("--image_size", default=224, type=int,
                   help="frames are resized to this square size (the "
                        "reference's --resize); rounded to a multiple of "
                        "the patch size")
    p.add_argument("--fps", default=30, type=int)
    p.add_argument("--head", default=None, type=int,
                   help="render one head instead of the mean over heads")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the attention runs on (cuda, cuda:N or cpu)")
    return p


def run(args) -> str:
    import torch

    from dinomc_tpu_torch.ckpt.torch_import import load_torch_state_dict
    from dinomc_tpu_torch.cli.common import load_pretrained_backbone
    from dinomc_tpu_torch.models.vit import VIT_FACTORIES, VisionTransformer
    from dinomc_tpu_torch.utils.video_generation import VideoGenerator

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but torch sees no CUDA device")
    size = max(args.patch_size, args.image_size // args.patch_size * args.patch_size)
    # the module's position table has the checkpoint's grid; the forward
    # interpolates it to the frames' grid
    grid_size = size
    if args.pretrained_weights and not os.path.isdir(args.pretrained_weights):
        key = None if args.checkpoint_key.lower() == "none" else args.checkpoint_key
        n_pos = load_torch_state_dict(args.pretrained_weights, key)["pos_embed"].shape[1]
        grid_size = math.isqrt(n_pos - 1) * args.patch_size
    cfg = VIT_FACTORIES[args.arch](patch_size=args.patch_size, img_size=grid_size)
    vit = VisionTransformer(cfg, torch.Generator().manual_seed(0))
    if args.pretrained_weights:
        load_pretrained_backbone(vit, args.pretrained_weights, args.checkpoint_key)
    else:
        print("no --pretrained_weights given; using RANDOM weights")
    gen = VideoGenerator(vit.to(device), image_size=size,
                         threshold=args.threshold if args.threshold > 0 else None,
                         batch_size=args.batch_size)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)), exist_ok=True)
    out = gen.generate(args.input_path, args.output_path, fps=args.fps, head=args.head)
    print(f"wrote {out}")
    return out


def main():
    args = argparse.ArgumentParser("attention_video", parents=[get_args_parser()]).parse_args()
    run(args)


if __name__ == "__main__":
    main()
