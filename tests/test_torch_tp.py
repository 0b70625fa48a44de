"""Port DINO-TP (``ops/augment.multicrop_augment_tp``, the three-global step,
``train_dino --data_mode tp``) against the JAX package.

``multicrop_augment_tp`` is fed the JAX package's own draws (the boxes of
its key structure ``split(rng, 5 + L)``: keys 0-2 the globals, 5 + i the
locals; the rows of the pre-crop augments from ``draw_photometric_params``
on ``_tp_photo_aug``'s keys) and held against JAX ``multicrop_augment_tp(...,
batch_first=True)`` at the photometric chain's atol 2e-4
(tests/test_fused_augment.py). The three-global forward/backward is held at
tests/test_torch_dino_step.py's bounds (loss 1e-6, gradients 1e-5; steps:
loss 1e-5, parameters and centre 5e-4).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.ops import augment as xaug
from dinomc_tpu.ops.pallas import augment as paug
from dinomc_tpu.objectives import dino as jdino
from dinomc_tpu.train import dino_trainer as jtr
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.objectives import dino as tdino
from dinomc_tpu_torch.ops import augment as taug
from dinomc_tpu_torch.ops.hopper import _build
from dinomc_tpu_torch.ops.hopper import augment as haug
from dinomc_tpu_torch.train import dino_trainer as ttr
from _torch_port import assert_state_dicts_close, n, one_torch_thread, t  # noqa: F401
from test_torch_augment import _jax_boxes
import test_torch_dino_step as vit

MC = dict(local_sizes=(24, 16), global_size=32)


def _jax_tp_draws(rng, B, H, W, cfg):
    """The JAX package's draws of one ``multicrop_augment_tp`` call
    (augment.py:402-434) in the port's ``TPDraw`` form."""
    keys = jax.random.split(rng, 5 + len(cfg.local_sizes))
    photo = []
    for key in (keys[3], keys[4]):  # _tp_photo_aug: jitter k[0], gray k[1], blur k[2], flip k[3]
        k = jax.random.split(key, 4)
        photo.append(t(paug.draw_photometric_params(
            k[3], k[0], k[1], k[2], None, B, (0.4, 0.4, 0.4, 0.1),
            p_jit=0.8, p_gray=0.2, p_blur=0.5, p_sol=0.0)))
    return taug.TPDraw(
        global_boxes=[t(_jax_boxes(keys[i], B, H, W, cfg.global_scale)) for i in range(3)],
        photo=photo,
        local_boxes=[t(_jax_boxes(keys[5 + i], B, H, W, cfg.local_scale))
                     for i in range(len(cfg.local_sizes))],
    )


def _temporal_images(dtype, B, H, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        x = rng.integers(0, 256, size=(B, 4, H, H, 3), dtype=np.uint8)
    else:
        x = rng.uniform(size=(B, 4, H, H, 3)).astype(np.float32)
    x[:, 3] = x[:, 0]  # MCTemporal's [t0, t1, t2, t0]
    return x


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("seed", [5, 6])
def test_multicrop_augment_tp_with_jax_draws_matches_jax(dtype, seed):
    B, H = 4, 48
    cfg_j, cfg_t = xaug.MultiCropConfig(**MC), taug.MultiCropConfig(**MC)
    x = _temporal_images(dtype, B, H, seed)
    key = jax.random.PRNGKey(seed)
    gj, lj = xaug.multicrop_augment_tp(key, jnp.asarray(x), cfg_j, batch_first=True)
    draws = _jax_tp_draws(key, B, H, H, cfg_j)
    gt, lt = taug.multicrop_augment_tp(torch.from_numpy(x.copy()), draws, cfg_t, batch_first=True)
    assert gt.shape == gj.shape == (3, B, 32, 32, 3) and gt.dtype == torch.float32
    np.testing.assert_allclose(n(gt), np.asarray(gj), atol=2e-4)
    assert len(lt) == len(lj) == 2
    for a, b in zip(lt, lj):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), np.asarray(b), atol=2e-4)
    # the draws cover both branches of the flip and of the augment's stages
    rows = torch.cat(draws.photo)
    for col in (haug.P_FLIP, haug.P_JIT, haug.P_BLUR):
        assert 0 < int(rows[:, col].sum()) < 2 * B, col


def test_time_first_layout_matches_batch_first():
    """``batch_first=False`` takes (4, B, H, W, 3), as the JAX function does."""
    B, H = 3, 40
    cfg = taug.MultiCropConfig(**MC)
    x = torch.from_numpy(_temporal_images("float32", B, H, 9))
    draws = taug.draw_multicrop_tp(torch.Generator().manual_seed(3), B, H, H, cfg)
    g1, l1 = taug.multicrop_augment_tp(x, draws, cfg, batch_first=True)
    g2, l2 = taug.multicrop_augment_tp(x.transpose(0, 1).contiguous(), draws, cfg, batch_first=False)
    assert torch.equal(g1, g2) and all(torch.equal(a, b) for a, b in zip(l1, l2))


def test_only_views_one_and_three_are_augmented():
    """The rows of ``draws.photo`` act on views 1 (t1) and 3 (the second t0):
    with the photometric rows of every stage off and no flip, the three
    globals are plain bicubic crops of t1, t2 and t0, normalized."""
    B, H = 2, 40
    cfg = taug.MultiCropConfig(**MC)
    x = torch.from_numpy(_temporal_images("float32", B, H, 10))
    draws = taug.draw_multicrop_tp(torch.Generator().manual_seed(4), B, H, H, cfg)
    for rows in draws.photo:
        rows[:, [haug.P_FLIP, haug.P_JIT, haug.P_GRAY, haug.P_BLUR, haug.P_SOL]] = 0.0
    g, _ = taug.multicrop_augment_tp(x, draws, cfg)
    for i, view in enumerate((1, 2, 3)):
        ref = taug.normalize(taug.resized_crop(x[:, view], draws.global_boxes[i], 32, "bicubic"))
        torch.testing.assert_close(g[i], ref, atol=1e-5, rtol=0)


def test_draw_multicrop_tp_shapes_and_ranges():
    B, H, W = 64, 256, 200
    cfg = taug.MultiCropConfig()
    d = taug.draw_multicrop_tp(torch.Generator().manual_seed(0), B, H, W, cfg)
    assert len(d.global_boxes) == 3 and len(d.photo) == 2
    assert len(d.local_boxes) == len(cfg.local_sizes)
    for boxes, scale in [(b, cfg.global_scale) for b in d.global_boxes] + [
            (b, cfg.local_scale) for b in d.local_boxes]:
        assert boxes.shape == (B, 4) and boxes.dtype == torch.float32
        w, h, x0, y0 = boxes.unbind(1)
        assert bool((w >= 1).all() and (w <= W).all() and (h >= 1).all() and (h <= H).all())
        assert bool((x0 >= 0).all() and (x0 + w <= W + 1e-3).all())
        assert bool((y0 >= 0).all() and (y0 + h <= H + 1e-3).all())
        area = (w * h / (H * W)).numpy()
        assert area.max() <= scale[1] + 1e-6 and area.min() >= 0.5 * scale[0]
    for rows in d.photo:
        assert rows.shape == (B, haug.P_LEN)
        assert not rows[:, haug.P_SOL].any()  # the pre-crop augment never solarizes
        jitter = rows[:, [haug.P_FB, haug.P_FC, haug.P_FS]]
        assert float(jitter.min()) >= 0.6 and float(jitter.max()) <= 1.4
        assert float(rows[:, haug.P_FH].abs().max()) <= 0.1
        for col in (haug.P_FLIP, haug.P_JIT, haug.P_GRAY, haug.P_BLUR):
            assert 0 < int(rows[:, col].sum()) < B
        np.testing.assert_allclose(n(rows[:, haug.P_TAPS:haug.P_TAPS + haug.N_TAPS].sum(1)), 1.0,
                                   atol=1e-6)


def test_three_global_loss_has_24_terms_and_matches_jax():
    """3 teacher globals against 9 student crops: 3 x 9 - 3 = 24 pairs."""
    rng = np.random.default_rng(2)
    student = rng.standard_normal((9, 3, 64)).astype(np.float32)
    teacher = rng.standard_normal((3, 3, 64)).astype(np.float32)
    center = rng.standard_normal((64,)).astype(np.float32) * 0.1
    lj, cj = jdino.dino_loss(jnp.asarray(student), jnp.asarray(teacher), jnp.asarray(center), 0.05)
    st = t(student).requires_grad_()
    lt, ct = tdino.dino_loss(st, t(teacher), t(center), 0.05)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=1e-6)
    np.testing.assert_allclose(n(ct), np.asarray(cj), atol=1e-7)
    # by hand: the mean over the 24 off-diagonal (teacher, student) pairs
    q = torch.softmax((t(teacher) - t(center)) / 0.05, -1)
    logp = torch.log_softmax(t(student) / 0.1, -1)
    terms = [-(q[i] * logp[j]).sum(-1).mean() for i in range(3) for j in range(9) if i != j]
    assert len(terms) == 24
    np.testing.assert_allclose(float(lt.detach()), float(torch.stack(terms).mean()), rtol=1e-6)


def _tp_crops(rng):
    crops = [rng.standard_normal((vit.B, vit.GLOBAL, vit.GLOBAL, 3)).astype(np.float32)
             for _ in range(3)]
    return crops + [rng.standard_normal((vit.B, s, s, 3)).astype(np.float32)
                    for s in vit.LOCAL_SIZES]


def _tp_configs(**kw):
    """The shared configs; JAX's names its 3 global crops (informational
    there: both steps read G from the crops)."""
    jcfg, tcfg = vit._configs(**kw)
    return dataclasses.replace(jcfg, n_global_crops=3), tcfg


def test_tp_loss_and_grads_match_jax():
    """One forward/backward with 3 global crops (a teacher batch of 3B) and
    the packed locals: loss, every student gradient and the centre."""
    jcfg, tcfg = _tp_configs(norm_last_layer=False, freeze_last_layer=0)
    jstate, tstate = vit._states(jcfg, tcfg)
    crops = _tp_crops(np.random.default_rng(3))
    g, locals_ = np.stack(crops[:3]), crops[3:]
    lj, gj, cj, _, _ = jax.jit(jtr.dino_loss_and_grads, static_argnames=("cfg",))(
        jstate, jnp.asarray(g), tuple(map(jnp.asarray, locals_)), jnp.float32(0.04),
        jax.random.PRNGKey(1), jcfg)
    lt, gt, ct = ttr.dino_loss_and_grads(tstate, t(g), tuple(map(t, locals_)), 0.04,
                                         tstate.generator, tcfg)
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-6, rtol=0)
    assert_state_dicts_close(gt, vit._sd(gj), atol=1e-5, what="grad ")
    np.testing.assert_allclose(n(ct), np.asarray(cj), atol=1e-7)


def test_tp_steps_on_jax_augmented_views_match_jax():
    """The slice end to end on the CPU: temporal images through both
    packages' ``multicrop_augment_tp`` (the port on JAX's draws), then 3
    ``dino_train_step``s of each on its own crops, from the same weights."""
    jcfg, tcfg = _tp_configs(clip_grad=3.0, freeze_last_layer=1)
    jstate, tstate = vit._states(jcfg, tcfg)
    lr, wd, mom, ttemp = vit._schedules()
    jsch = jtr.DinoSchedules(lr=jnp.asarray(lr), wd=jnp.asarray(wd),
                             teacher_momentum=jnp.asarray(mom), teacher_temp=jnp.asarray(ttemp))
    tsch = ttr.DinoSchedules(lr=lr, wd=wd, teacher_momentum=mom, teacher_temp=ttemp)
    cfg_j = xaug.MultiCropConfig(global_size=vit.GLOBAL, local_sizes=vit.LOCAL_SIZES)
    cfg_t = taug.MultiCropConfig(global_size=vit.GLOBAL, local_sizes=vit.LOCAL_SIZES)
    for it in range(3):
        x = _temporal_images("uint8", vit.B, 48, 30 + it)
        key = jax.random.PRNGKey(40 + it)
        gj, lj = xaug.multicrop_augment_tp(key, jnp.asarray(x), cfg_j, batch_first=True)
        gt, lt = taug.multicrop_augment_tp(torch.from_numpy(x.copy()),
                                           _jax_tp_draws(key, vit.B, 48, 48, cfg_j), cfg_t)
        jstate, jm = jtr.dino_train_step(jstate, gj, lj, jsch, jcfg)
        tm = ttr.dino_train_step(tstate, gt, lt, tsch, tcfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=0,
                                   err_msg=f"loss at step {it}")
    assert_state_dicts_close(tstate.student.state_dict(), vit._sd(jstate.student), 5e-4, "student ")
    assert_state_dicts_close(tstate.teacher.state_dict(), vit._sd(jstate.teacher), 5e-4, "teacher ")
    np.testing.assert_allclose(n(tstate.center), np.asarray(jstate.center), atol=5e-4)


SMOKE = [
    "--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--out_dim", "128",
    "--batch_size_per_gpu", "1", "--epochs", "1", "--max_steps", "1", "--local_crops_number",
    "2", "--size_crops", "96", "64", "--warmup_epochs", "0", "--image_size", "128",
    "--print_freq", "1", "--num_workers", "1", "--data_mode", "tp",
]


def _seco_tree(root, locations=2, stamps=3, size=64):
    """A SeCo layout: a directory a location, a PNG a timestamp."""
    rng = np.random.default_rng(8)
    for loc in range(locations):
        d = root / f"{loc:03d}"
        d.mkdir(parents=True)
        for s in range(stamps):
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
                d / f"t{s}.png")
    return root


@pytest.mark.parametrize("source", ["synthetic", "tree", "packed"])
def test_cli_runs_one_tp_step(tmp_path, monkeypatch, source):
    """``train_dino --data_mode tp`` (JAX tests/test_cli_smoke.py's case)
    from synthetic data, a SeCo tree (``MCTemporal``) and a packed corpus
    (``PackedMCTemporal``, uint8 batches): one step through
    ``multicrop_augment_tp`` with 3 globals, a finite loss, and no kernel
    launched on the CPU (K3 runs its plain version)."""
    from dinomc_tpu_torch.cli import pack_data

    data = "synthetic"
    if source != "synthetic":
        data = str(_seco_tree(tmp_path / "seco"))
        if source == "packed":
            pack_data.main(["--src", data, "--out", str(tmp_path / "packed"), "--size", "128"])
            data = str(tmp_path / "packed")
    shapes = []
    real = taug.multicrop_augment_tp

    def spy(images, draws, cfg, batch_first=True):
        out = real(images, draws, cfg, batch_first)
        shapes.append((tuple(images.shape), images.dtype, tuple(out[0].shape)))
        return out

    monkeypatch.setattr(taug, "multicrop_augment_tp", spy)
    args = get_args_parser().parse_args(SMOKE + ["--data_path", data,
                                                 "--output_dir", str(tmp_path / "run")])
    _build.LAUNCHES.clear()
    out = train_dino(args)
    assert len(out.losses) == 1 and math.isfinite(out.losses[0])
    dtype = torch.uint8 if source == "packed" else torch.float32
    assert shapes == [((1, 4, 128, 128, 3), dtype, (3, 1, 224, 224, 3))]
    assert not _build.LAUNCHES
