"""The attention video of the port against the JAX package.

``vit_last_selfattention`` and ``attention_heatmaps`` run on the JAX
package's weights (carried across by ``ckpt/from_jax.load_jax_params``) and
the same seeded images, in f32. Bounds: the attention map within 1e-5 (the
ViT tests' forward bound is 2e-5 on features of larger magnitude;
probabilities are below 1). Heatmaps within 1e-6, except for patches whose
cumulative mass, in JAX's descending order, lies within 1e-5 of the
threshold: there an f32 summation order may flip the keep decision, so
those patches are counted (few must be) and left out. Frames within one
uint8 step. The GIF that ``write_video`` falls back to without cv2 is the
JAX function's, byte for byte.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.ckpt.torch_export import vit_state_dict
from dinomc_tpu.models import vit as jvit
from dinomc_tpu.utils import video_generation as jvg
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.cli import attention_video as tcli
from dinomc_tpu_torch.models import vit as tvit
from dinomc_tpu_torch.utils import video_generation as tvg
from _torch_port import n, one_torch_thread, t  # noqa: F401

S, P, B = 32, 4, 2
NEAR = 1e-5


def _pair():
    """(JAX cfg, JAX params, port ViT): ``vit_test`` with 2 layers, 32 px,
    f32, the same weights."""
    jcfg = dataclasses.replace(jvit.vit_test(patch_size=P, img_size=S, compute_dtype=jnp.float32),
                               depth=2)
    params = jax.device_get(jvit.init_vit(jax.random.PRNGKey(0), jcfg))
    model = tvit.VisionTransformer(dataclasses.replace(
        tvit.vit_test(patch_size=P, img_size=S, compute_dtype=torch.float32), depth=2))
    load_jax_params(model, params)
    return jcfg, params, model


def _images(seed):
    return np.random.default_rng(seed).uniform(size=(B, S, S, 3)).astype(np.float32)


def test_last_selfattention_matches_jax():
    jcfg, params, model = _pair()
    x = np.random.default_rng(1).standard_normal((B, S, S, 3)).astype(np.float32)
    ref = np.asarray(jvit.vit_last_selfattention(params, jnp.asarray(x), jcfg))
    with torch.no_grad():
        ours = tvit.vit_last_selfattention(model, t(x))
    assert ours.dtype == torch.float32 and ours.shape == (B, 2, 65, 65)
    np.testing.assert_allclose(n(ours), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(ours).sum(-1), 1.0, atol=1e-5)


def _near_threshold(params, images, jcfg, threshold):
    """(B, heads, gh, gw) bool: patches whose cumulative mass in JAX's
    descending order lies within NEAR of ``threshold``."""
    x = jvit.vit_last_selfattention(params, (jnp.asarray(images) - jnp.asarray(
        [0.485, 0.456, 0.406])) / jnp.asarray([0.229, 0.224, 0.225]), jcfg)
    cls = np.asarray(x)[:, :, 0, 1:]
    flat = cls / cls.sum(-1, keepdims=True)
    order = np.argsort(flat, axis=-1, kind="stable")[..., ::-1]
    cum = np.cumsum(np.take_along_axis(flat, order, -1), -1)
    near_sorted = np.abs(cum - threshold) < NEAR
    near = np.take_along_axis(near_sorted, np.argsort(order, -1), -1)
    g = S // P
    return near.reshape(B, -1, g, g)


@pytest.mark.parametrize("threshold", [0.6, None], ids=["threshold", "raw"])
def test_heatmaps_match_jax(threshold):
    jcfg, params, model = _pair()
    images = _images(2)
    ref = jvg.attention_heatmaps(params, images, jcfg, threshold)
    ours = tvg.attention_heatmaps(model, images, threshold)
    assert ours.shape == ref.shape == (B, 2, S, S) and ours.dtype == np.float32
    ok = np.ones(ref.shape, bool)
    if threshold is not None:
        near = _near_threshold(params, images, jcfg, threshold)
        assert near.sum() <= 2, f"{near.sum()} patches within {NEAR} of the threshold"
        ok = ~np.repeat(np.repeat(near, P, axis=2), P, axis=3)
        # the threshold kept some patches and dropped others
        assert 0 < (ref > 0).mean() < 1
    np.testing.assert_allclose(ours[ok], ref[ok], atol=1e-6, rtol=0)


def test_rendered_frames_match_jax():
    jcfg, params, model = _pair()
    images = _images(3)
    for head in (None, 1):
        ref = jvg.render_heatmap_frames(
            images, jvg.attention_heatmaps(params, images, jcfg, None), head=head)
        ours = tvg.render_heatmap_frames(images, tvg.attention_heatmaps(model, images, None),
                                         head=head)
        assert ours.dtype == np.uint8 and ours.shape == (B, S, S, 3)
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_write_video_falls_back_to_the_jax_gif(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
    frames = list(np.random.default_rng(4).integers(0, 256, (3, 24, 24, 3), dtype=np.uint8))
    ours = tvg.write_video(frames, str(tmp_path / "ours.mp4"), fps=5)
    ref = jvg.write_video(frames, str(tmp_path / "ref.mp4"), fps=5)
    assert ours == str(tmp_path / "ours.gif") and ref == str(tmp_path / "ref.gif")
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert Image.open(ours).n_frames == 3


def test_cli_writes_a_gif_from_a_folder_of_frames(tmp_path, monkeypatch, capsys):
    """``--device cpu`` on 3 PNG frames with a reference ``.pth`` (a DINO
    teacher written from the JAX package's ViT-tiny): a GIF of 3 frames at
    the rounded image size; its frames are the port's heatmaps rendered.
    Without weights it says it runs random ones."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(5)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(frames / f"{i}.png")
    jcfg = jvit.vit_tiny(patch_size=16)
    params = jax.device_get(jvit.init_vit(jax.random.PRNGKey(6), jcfg))
    sd = {f"backbone.{k}": torch.from_numpy(np.array(v)) for k, v in vit_state_dict(params).items()}
    torch.save({"teacher": sd}, tmp_path / "dino.pth")
    common = ["--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--image_size", "40",
              "--input_path", str(frames), "--batch_size", "2", "--threshold", "0"]
    out = tcli.run(tcli.get_args_parser().parse_args(
        common + ["--output_path", str(tmp_path / "out" / "attn.mp4"),
                  "--pretrained_weights", str(tmp_path / "dino.pth")]))
    assert out == str(tmp_path / "out" / "attn.gif")
    gif = Image.open(out)
    assert gif.n_frames == 3 and gif.size == (32, 32)

    model = tvit.VisionTransformer(tvit.vit_tiny(patch_size=16))
    load_jax_params(model, params)
    batch = np.stack([np.asarray(Image.open(frames / f"{i}.png").convert("RGB").resize(
        (32, 32), Image.BICUBIC), np.float32) / 255.0 for i in range(3)])
    want = tvg.render_heatmap_frames(batch, tvg.attention_heatmaps(model, batch, None))
    gif.seek(2)
    got = np.asarray(gif.convert("RGB"), np.int32)
    # GIF palettes quantize; the frame stays near what was rendered
    assert np.abs(got - want[2]).mean() < 8

    tcli.run(tcli.get_args_parser().parse_args(
        common + ["--output_path", str(tmp_path / "rand.mp4")]))
    assert "RANDOM weights" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="cli.convert_ckpt"):
        tcli.run(tcli.get_args_parser().parse_args(
            common + ["--output_path", str(tmp_path / "x.mp4"),
                      "--pretrained_weights", str(frames)]))
