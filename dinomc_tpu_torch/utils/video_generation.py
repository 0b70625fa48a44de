"""DINO attention-map visualization and video generation.

Counterpart of ``dinomc_tpu/utils/video_generation.py``; parity target the
reference ``utils/video_generation.py`` (``VideoGenerator``, ``:40-378``):
take a folder of frames (or extract them from a video), run
``vit_last_selfattention`` on each batch of frames, keep the top-attention
mass of each head (``threshold``), render heatmaps and write a video.

The attention of a batch is one call on the model's device (K1 for the
first L-1 blocks on a card); the thresholding, the upsampling and the
rendering follow the JAX functions step for step. Video IO uses cv2 where it
is installed and falls back to an animated GIF through PIL; extracting
frames from a video needs cv2, so without it the input is a folder of
frames.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch


@torch.no_grad()
def attention_heatmaps(
    vit,
    images: np.ndarray,  # (B, H, W, 3) float [0, 1], not normalized
    threshold: Optional[float] = 0.6,
) -> np.ndarray:
    """Per-image CLS attention maps, upsampled to pixels: (B, heads, H, W)
    f32, on the host.

    With ``threshold``, keeps the smallest set of patches holding that
    fraction of each head's attention mass (reference ``:150-238``): the
    mass normalized, sorted descending as the JAX package sorts it (a stable
    ascending argsort, reversed), the running sum held to ``<= threshold``
    and the keep mask scattered back through the inverse permutation.
    """
    from dinomc_tpu_torch.models.vit import vit_last_selfattention
    from dinomc_tpu_torch.ops.augment import _nearest_index, normalize

    B, H, W, _ = images.shape
    p = vit.cfg.patch_size
    gh, gw = H // p, W // p
    dev = vit.cls_token.device
    x = normalize(torch.as_tensor(images, dtype=torch.float32, device=dev))
    attn = vit_last_selfattention(vit, x)  # (B, h, N+1, N+1)
    cls_attn = attn[:, :, 0, 1:]  # (B, h, N)
    nh = cls_attn.shape[1]

    if threshold is not None:
        flat = cls_attn / cls_attn.sum(-1, keepdim=True)
        order = torch.argsort(flat, dim=-1, stable=True).flip(-1)
        cum = torch.cumsum(flat.gather(-1, order), dim=-1)
        inv = torch.argsort(order, dim=-1)
        keep = (cum <= threshold).gather(-1, inv)
        cls_attn = torch.where(keep, flat, torch.zeros_like(flat))

    maps = cls_attn.reshape(B, nh, gh, gw)
    # jax.image.resize(..., "nearest"): a repeat by p when H = gh * p
    rows, cols = _nearest_index(gh, H, dev), _nearest_index(gw, W, dev)
    return maps[:, :, rows][:, :, :, cols].cpu().numpy()


def render_heatmap_frames(
    images: np.ndarray,  # (B, H, W, 3) [0, 1]
    maps: np.ndarray,  # (B, heads, H, W)
    alpha: float = 0.5,
    head: Optional[int] = None,
) -> np.ndarray:
    """Overlay the mean-over-heads (or one head's) attention as red heat.
    Returns (B, H, W, 3) uint8 frames."""
    m = maps[:, head] if head is not None else maps.mean(1)
    m = m / np.maximum(m.max(axis=(1, 2), keepdims=True), 1e-12)
    heat = np.stack([m, np.zeros_like(m), 1.0 - m], axis=-1)
    out = (1 - alpha) * images + alpha * heat
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def extract_frames(video_path: str, out_dir: str, fps: Optional[int] = None) -> List[str]:
    """Video -> frame PNGs (cv2 required for video input)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    paths = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        p = os.path.join(out_dir, f"frame_{i:05d}.png")
        cv2.imwrite(p, frame)
        paths.append(p)
        i += 1
    cap.release()
    return paths


def write_video(frames: Sequence[np.ndarray], out_path: str, fps: int = 10) -> str:
    """uint8 frames -> mp4 through cv2, else an animated GIF through PIL
    (beside ``out_path``, with the ``.gif`` suffix). Returns the path
    written. A cv2 writer that does not open (no codec for mp4v) also falls
    back to the GIF, where the JAX function would return a path it never
    wrote."""
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError(f"cv2 could not open {out_path} for mp4v")
        for f in frames:
            vw.write(f[..., ::-1])  # RGB -> BGR
        vw.release()
        return out_path
    except Exception:
        from PIL import Image

        gif_path = os.path.splitext(out_path)[0] + ".gif"
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return gif_path


class VideoGenerator:
    """Frames or a video in, attention video out (reference class parity).
    ``vit`` is a port ``VisionTransformer`` on the device the attention runs
    on."""

    def __init__(self, vit, image_size: int = 224, threshold: Optional[float] = 0.6,
                 batch_size: int = 8):
        self.vit = vit
        self.image_size = image_size
        self.threshold = threshold
        self.batch_size = batch_size

    def _load_frames(self, input_path: str, tmp_dir: str) -> List[str]:
        if os.path.isdir(input_path):
            return sorted(str(p) for p in Path(input_path).iterdir()
                          if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
        return extract_frames(input_path, tmp_dir)

    def generate(self, input_path: str, output_path: str, fps: int = 10,
                 head: Optional[int] = None) -> str:
        from PIL import Image

        frame_paths = self._load_frames(input_path, output_path + "_frames")
        rendered = []
        s = self.image_size
        for i in range(0, len(frame_paths), self.batch_size):
            batch = np.stack([
                np.asarray(Image.open(p).convert("RGB").resize((s, s), Image.BICUBIC),
                           np.float32) / 255.0
                for p in frame_paths[i: i + self.batch_size]
            ])
            maps = attention_heatmaps(self.vit, batch, self.threshold)
            rendered.extend(render_heatmap_frames(batch, maps, head=head))
        return write_video(rendered, output_path, fps)
