"""Port full-resolution segmentation inference (data/patching.py,
eval/tiled_inference.py, the nearest and bicubic ``ops/augment.resize``,
``ckpt/torch_import.load_upernet_checkpoint``, utils/visualization.py and
the ``predict`` and ``evaluate_stitched`` CLIs) against the JAX package.

The same numpy inputs, made from a seed, go through both packages. Bounds:
patch coordinates, metadata, ``extract_patches`` and both ``stitch`` modes
equal exactly (slices and the same f32 sums in the same order); ``resize``
1e-5 absolute against ``jax.image.resize`` for bicubic and bilinear (two f32
matrix products against XLA's own order), nearest exactly. A real UPerNet
(vit_tiny/16, a narrow decoder) from a JAX init, carried across by
``ckpt/from_jax``, in f32 on both sides: logits within 1e-4 absolute, the
bound of tests/test_torch_upernet.py (convolutions sum in another order),
and class masks equal wherever JAX's top-2 margin exceeds 2e-4 (twice that
bound: elsewhere a 1e-4 difference may flip the argmax). The CLIs of both
packages run from one ``export_seg_checkpoint`` ``.pth`` under the same
bounds; their mIoU agree within the share of pixels whose class differs.
The CLIs compute in bf16 by default: the tests make both packages' seg
models f32 by replacing ``UPerNetConfig`` in each models module with one
whose ``compute_dtype`` is f32.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dinomc_tpu.ckpt.torch_export import export_seg_checkpoint, upernet_state_dict
from dinomc_tpu.data import patching as jpatch
from dinomc_tpu.data import seg_datasets as jsd
from dinomc_tpu.eval import tiled_inference as jtile
from dinomc_tpu.models import upernet as jup
from dinomc_tpu.train import seg_trainer as jseg
from dinomc_tpu.utils import visualization as jvis
from dinomc_tpu_torch.ckpt import torch_import as timport
from dinomc_tpu_torch.ckpt.checkpoint import CheckpointManager
from dinomc_tpu_torch.ckpt.from_jax import load_jax_params
from dinomc_tpu_torch.data import patching as tpatch
from dinomc_tpu_torch.data import seg_datasets as tsd
from dinomc_tpu_torch.eval import tiled_inference as ttile
from dinomc_tpu_torch.models import upernet as tup
from dinomc_tpu_torch.ops import augment as taug
from dinomc_tpu_torch.train import seg_trainer as tseg
from dinomc_tpu_torch.utils import visualization as tvis
from _torch_port import n, one_torch_thread, t, write_seg_folder  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
C = 8  # UAVid's classes
SMALL = dict(num_classes=C, arch="vit_tiny", patch_size=16, channels=32, aux_channels=16)
LOGIT_ATOL = 1e-4
MARGIN = 2e-4


# ---------------------------------------------------------------------------
# geometry, extract, stitch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,grid,overlap", [
    (64, 96, (2, 2), 0.0), (64, 96, (2, 3), 0.25), (2160, 3840, 4, 0.0),
    (2160, 3840, (3, 3), 0.1), (97, 61, 9, 0.5),
])
def test_coords_and_metadata_equal_jax(h, w, grid, overlap):
    assert tpatch.grid_from_arg(grid) == jpatch.grid_from_arg(grid)
    rows, cols = jpatch.grid_from_arg(grid)
    for ours, ref in ((tpatch.grid_coords(h, w, grid, overlap), jpatch.grid_coords(h, w, grid, overlap)),
                      (tpatch.custom_grid_coords(h, w, rows, cols),
                       jpatch.custom_grid_coords(h, w, rows, cols))):
        assert ours == ref
        meta = tpatch.coords_to_metadata(ours, "frame", cols=cols)
        assert meta == jpatch.coords_to_metadata(ref, "frame", cols=cols)
        assert tpatch.metadata_to_coords(meta, list(meta)) == jpatch.metadata_to_coords(meta, list(meta))
    with pytest.raises(ValueError):
        tpatch.grid_from_arg(8)


@pytest.mark.parametrize("mode", ["paste", "mean"])
@pytest.mark.parametrize("overlap", [0.0, 0.3])
def test_extract_and_stitch_equal_jax(mode, overlap):
    rng = np.random.default_rng(1)
    image = rng.standard_normal((64, 96, 5)).astype(np.float32)
    coords = jpatch.grid_coords(64, 96, (2, 3), overlap)
    ref = np.asarray(jpatch.extract_patches(jnp.asarray(image), coords))
    ours = tpatch.extract_patches(t(image), coords)
    np.testing.assert_array_equal(n(ours), ref)
    logits = rng.standard_normal(ref.shape).astype(np.float32)
    want = np.asarray(jpatch.stitch(jnp.asarray(logits), coords, (64, 96), mode))
    got = tpatch.stitch(t(logits), coords, (64, 96), mode)
    assert got.shape == (64, 96, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), want)
    with pytest.raises(ValueError):
        tpatch.stitch(t(logits), coords, (64, 96), "max")


def test_split_and_save_writes_what_jax_writes(tmp_path):
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    metas = {}
    for name, mod in (("jax", jpatch), ("port", tpatch)):
        meta = {}
        written = mod.split_and_save(image, mask, str(tmp_path / name / "img"),
                                     str(tmp_path / name / "msk"), "frame", (2, 3), 0.2, meta)
        mod.save_metadata(meta, str(tmp_path / name / "meta.json"))
        metas[name] = (written, mod.load_metadata(str(tmp_path / name / "meta.json")))
    assert metas["port"] == metas["jax"] and len(metas["port"][0]) == 6
    for sub in ("img", "msk"):
        for f in metas["jax"][0]:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / sub / f)),
                                          np.asarray(Image.open(tmp_path / "jax" / sub / f)))


# ---------------------------------------------------------------------------
# resize, the dataset additions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("hw_in,hw_out", [((32, 48), (64, 64)), ((64, 64), (32, 48)),
                                          ((90, 56), (21, 56)), ((7, 5), (16, 13))])
def test_resize_matches_jax(method, hw_in, hw_out):
    x = np.random.default_rng(3).standard_normal((2, *hw_in, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *hw_out, 4), method))
    out = taug.resize(t(x), hw_out, method)
    assert out.shape == (2, *hw_out, 4)
    if method == "nearest":
        np.testing.assert_array_equal(n(out), ref)
        ints = np.random.default_rng(4).integers(0, C, (1, *hw_in, 1)).astype(np.int32)
        want = jax.image.resize(jnp.asarray(ints, jnp.float32), (1, *hw_out, 1), "nearest")
        got = taug.resize(torch.from_numpy(ints), hw_out, "nearest")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    else:
        np.testing.assert_allclose(n(out), ref, atol=1e-5, rtol=0)


def test_nearest_uses_jax_rule_not_interpolate():
    """At 2160 -> 1000 rows, floor((i + 0.5) * in / out) and F.interpolate's
    floor(i * in / out) pick different rows."""
    x = torch.arange(2160, dtype=torch.float32).reshape(1, 2160, 1, 1)
    ours = taug.resize(x, (1000, 1), "nearest")[0, :, 0, 0]
    ref = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (1, 1000, 1, 1), "nearest"))
    np.testing.assert_array_equal(ours.numpy(), ref[0, :, 0, 0])
    interp = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(1000, 1), mode="nearest")
    assert not torch.equal(interp[0, 0, :, 0], ours)


def test_class_to_rgb_equals_jax():
    mask = np.random.default_rng(5).integers(-2, C + 3, (9, 11))
    for name in ("uavid", "udd6", "potsdam", "loveda"):
        np.testing.assert_array_equal(tsd.class_to_rgb(mask, tsd.SPECS[name]),
                                      jsd.class_to_rgb(mask, jsd.SPECS[name]))


def test_native_and_sized_loads_equal_jax(tmp_path):
    """``image_size=None`` loads the native 20 x 23 frames (the port's load
    resized to (None, None) before); ``size`` overrides ``image_size``."""
    write_seg_folder(tmp_path, 2, 20, jsd.UAVID, seed=7)
    dirs = (str(tmp_path / "images"), str(tmp_path / "masks"))
    for image_size, size in ((None, None), (16, None), (None, 12), (16, 12)):
        ref = jsd.SegSampleIndex(*dirs, jsd.UAVID, image_size=image_size)
        ours = tsd.SegSampleIndex(*dirs, tsd.UAVID, image_size=image_size)
        for i in range(2):
            (a, am), (b, bm) = ours.load(i, size=size), ref.load(i, size=size)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(am, bm)
            side = size or image_size
            assert a.shape[:2] == ((side, side) if side else (20, 23))


@pytest.mark.parametrize("split", ["train", "val"])
def test_potsdam_pairs_equal_jax(tmp_path, split):
    rng = np.random.default_rng(8)
    pal = np.asarray(jsd.POTSDAM.palette, np.uint8)
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(
            tmp_path / f"Image_{i}.tif")
        Image.fromarray(pal[rng.integers(0, 6, (12, 10))]).save(tmp_path / f"Label_{i}.tif")
    ref = jsd.SegSampleIndex.potsdam_pairs(str(tmp_path), jsd.POTSDAM, split, image_size=8)
    ours = tsd.SegSampleIndex.potsdam_pairs(str(tmp_path), tsd.POTSDAM, split, image_size=8)
    assert ours.stems == ref.stems and len(ours) == (6 if split == "train" else 1)
    for i in range(len(ours)):
        for a, b in zip(ours.load(i), ref.load(i)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# tiled inference with a real UPerNet
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _jax_seg():
    """A small JAX UPerNet in f32 from seed 0: (cfg, params, bn_state) with
    running statistics drawn, so eval-mode BatchNorms are not identities."""
    jcfg = jseg.SegConfig(model=jup.UPerNetConfig(**SMALL, compute_dtype=jnp.float32))
    st = jseg.init_seg_train_state(jax.random.PRNGKey(0), jcfg)
    params, bn = jax.device_get((st.params, st.bn_state))
    rng = np.random.default_rng(9)

    def draw(path, v):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    return jcfg, params, jax.tree_util.tree_map_with_path(draw, bn)


def _port_seg():
    jcfg, params, bn = _jax_seg()
    model = tup.UPerNet(tup.UPerNetConfig(**SMALL, compute_dtype=torch.float32))
    load_jax_params(model, (params, bn))
    return model


def _jax_predict(x):
    jcfg, params, bn = _jax_seg()
    return jseg.seg_predict(params, bn, x, jcfg)


def _assert_logits_and_masks(ours, ref):
    """ours: torch logits (..., C); ref: JAX logits."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(ours), ref, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(n(ours.argmax(-1))[sure], ref.argmax(-1)[sure])


def _frame(seed, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    image = jsd.UAVID.mean + rng.standard_normal((*hw, 3)).astype(np.float32) * 0.2
    return ((image - np.asarray(jsd.UAVID.mean)) / np.asarray(jsd.UAVID.std)).astype(np.float32)


@pytest.mark.parametrize("hw,grid,model_size,overlap,mode", [
    ((64, 96), (2, 2), 64, 0.0, "paste"), ((64, 96), (2, 3), 64, 0.25, "mean"),
    ((64, 96), (1, 1), None, 0.0, "paste"), ((160, 192), (2, 2), 64, 0.0, "paste"),
], ids=["2x2-up", "2x3-overlap-mean", "whole-native", "2x2-down"])
def test_tiled_predict_matches_jax(hw, grid, model_size, overlap, mode):
    image = _frame(10, hw)
    ref = jtile.tiled_predict(_jax_predict, jnp.asarray(image), grid, model_size, overlap, mode)
    model = _port_seg()
    calls = []

    def predict_fn(x):
        calls.append(tuple(x.shape))
        return tseg.seg_predict(model, x)

    ours = ttile.tiled_predict(predict_fn, t(image), grid, model_size, overlap, mode)
    assert ours.shape == (*hw, C) and len(calls) == 1
    _assert_logits_and_masks(ours, ref)


def test_evaluate_tiled_matches_jax():
    frames = [(_frame(11 + i), np.random.default_rng(20 + i).integers(0, C, (64, 96)))
              for i in range(2)]
    ref = jtile.evaluate_tiled(_jax_predict, ((jnp.asarray(x), jnp.asarray(m)) for x, m in frames),
                               C, (2, 2), 64)
    model = _port_seg()
    ours = ttile.evaluate_tiled(lambda x: tseg.seg_predict(model, x),
                                ((t(x), torch.from_numpy(m)) for x, m in frames), C, (2, 2), 64)
    assert ours["n_images"] == ref["n_images"] == 2
    # the masks agree wherever JAX's margin is clear; the scores within the
    # share of the pixels where they differ
    ours_m = [ttile.tiled_predict(lambda x: tseg.seg_predict(model, x), t(x), (2, 2), 64).argmax(-1)
              for x, _ in frames]
    ref_m = [np.asarray(jtile.tiled_predict(_jax_predict, jnp.asarray(x), (2, 2), 64)).argmax(-1)
             for x, _ in frames]
    share = np.mean([np.mean(n(a) != b) for a, b in zip(ours_m, ref_m)])
    for k in ("miou", "mf1", "acc"):
        assert abs(ours[k] - float(ref[k])) <= share + 1e-6, k
    np.testing.assert_array_equal(ours["present"], np.asarray(ref["present"]))


def test_stitch_from_files_matches_jax(tmp_path):
    """Per-patch CHW ``.npy`` files at another size than their boxes (so each
    is bicubic-resized) and the metadata of two frames; one frame rebuilt."""
    rng = np.random.default_rng(12)
    meta = {}
    for base in ("a", "b"):
        coords = jpatch.custom_grid_coords(64, 96, 2, 2)
        meta.update(jpatch.coords_to_metadata(coords, base, cols=2))
        for r in range(2):
            for c in range(2):
                np.save(tmp_path / f"{base}_{r}_{c}.npy",
                        rng.standard_normal((C, 20, 30)).astype(np.float32))
    jpatch.save_metadata(meta, str(tmp_path / "patches_metadata.json"))
    args = (str(tmp_path), str(tmp_path / "patches_metadata.json"), (64, 96))
    for base in ("a", None):
        ref = np.asarray(jtile.stitch_from_files(*args, basename=base))
        ours = ttile.stitch_from_files(*args, basename=base)
        assert ours.shape == (64, 96, C)
        np.testing.assert_allclose(n(ours), ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# checkpoints, visualization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrap", ["model_state_dict", "state_dict", "module."])
def test_load_upernet_checkpoint_reads_a_reference_pth(tmp_path, wrap):
    jcfg, params, bn = _jax_seg()
    ref = upernet_state_dict(params, bn)
    path = str(tmp_path / "seg.pth")
    if wrap == "model_state_dict":
        export_seg_checkpoint(path, params, bn, epoch=3, best_miou=0.5)
    else:
        sd = {("module." + k if wrap == "module." else k): torch.from_numpy(np.array(v))
              for k, v in ref.items()}
        torch.save({"state_dict": sd} if wrap == "state_dict" else sd, path)
    sd = timport.read_upernet_state_dict(path)
    assert timport.upernet_widths(sd) == dict(channels=32, aux_channels=16, use_fpn_neck=False)
    model = tup.UPerNet(tup.UPerNetConfig(**SMALL))
    timport.load_upernet_checkpoint(model, sd)
    ours = model.state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]).astype(ours[k].numpy().dtype))
    with pytest.raises(RuntimeError):  # strict: another width does not load
        timport.load_upernet_checkpoint(tup.UPerNet(tup.UPerNetConfig(num_classes=C, arch="vit_tiny",
                                                                      patch_size=16)), sd)


def test_visualization_equals_jax(tmp_path):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.de_norm(x), jvis.de_norm(x))
    np.testing.assert_array_equal(tvis.make_numpy_grid(x), jvis.make_numpy_grid(x))
    for img, mean in ((x[0], jvis.IMAGENET_MEAN), (x[0].transpose(2, 0, 1), jvis.IMAGENET_MEAN),
                      (x[0], None), (x[0, ..., :1], None), (x[0, ..., 0], None)):
        np.testing.assert_array_equal(np.asarray(tvis.transform_convert(img, mean)),
                                      np.asarray(jvis.transform_convert(img, mean)))
    with pytest.raises(ValueError):
        tvis.transform_convert(x[0, ..., :2])
    img1, img2 = rng.uniform(size=(2, 12, 10, 3)).astype(np.float32)
    gt, pred = (rng.uniform(size=(2, 12, 10)) > 0.5).astype(np.float32)
    image = rng.uniform(size=(12, 10, 3)).astype(np.float32)
    mask = rng.integers(0, C, (12, 10))
    for name, mod in (("jax", jvis), ("port", tvis)):
        mod.save_change_panel(str(tmp_path / f"{name}_panel.png"), img1, img2, gt, pred)
        mod._save_overlay_png(image, mask, jsd.UAVID.palette, str(tmp_path / f"{name}_ov.png"), 0.5)
    for f in ("panel", "ov"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"port_{f}.png")),
                                      np.asarray(Image.open(tmp_path / f"jax_{f}.png")))
    tvis.save_segmentation_figure(image, mask, tsd.UAVID.classes, tsd.UAVID.palette,
                                  str(tmp_path / "fig.png"), gt_mask=mask)
    assert (tmp_path / "fig.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture
def f32_models(monkeypatch):
    """Both packages' seg CLIs build their UPerNet in f32."""
    from dinomc_tpu_torch.models import upernet as tup_mod

    monkeypatch.setattr(jup, "UPerNetConfig",
                        functools.partial(jup.UPerNetConfig, compute_dtype=jnp.float32))
    monkeypatch.setattr(tup_mod, "UPerNetConfig",
                        functools.partial(tup.UPerNetConfig, compute_dtype=torch.float32))


@pytest.fixture
def seg_pth(tmp_path):
    jcfg, params, bn = _jax_seg()
    path = str(tmp_path / "seg.pth")
    export_seg_checkpoint(path, params, bn, epoch=1)
    return path


def _args(mod, argv, **overrides):
    args = mod.get_args_parser().parse_args(argv)
    for k, v in overrides.items():
        assert hasattr(args, k), k
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("grid", [None, [2, 2]], ids=["whole", "grid"])
def test_predict_cli_matches_jax(tmp_path, f32_models, seg_pth, grid):
    from dinomc_tpu.cli import predict as jcli
    from dinomc_tpu_torch.cli import predict as tcli

    img = (np.random.RandomState(14).rand(64, 96, 3) * 255).astype("uint8")
    Image.fromarray(img).save(tmp_path / "img.png")
    common = dict(arch="vit_tiny", patch_size=16, model_size=64, ckpt=seg_pth, grid=grid)
    ref = jcli.run(_args(jcli, ["--image", str(tmp_path / "img.png")], **common,
                         out=str(tmp_path / "jax.png")))
    ours = tcli.run(_args(tcli, ["--image", str(tmp_path / "img.png")], **common, device="cpu",
                          out=str(tmp_path / "port.png"), figure=str(tmp_path / "fig.png")))
    assert ours.shape == ref.shape == (64, 96) and ours.dtype == np.uint8
    # JAX's logits for the margin, from the same weights and image
    jcfg, params, bn = _jax_seg()
    x = jaug_normalize(img)
    if grid:
        logits = np.asarray(jtile.tiled_predict(_jax_predict, x, tuple(grid), 64))
    else:
        small = jax.image.resize(x, (64, 64, 3), "bicubic")
        logits = np.asarray(jax.image.resize(_jax_predict(small[None])[0], (64, 96, C), "bicubic"))
    np.testing.assert_array_equal(logits.argmax(-1), ref)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(ours[sure], ref[sure])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png"))[sure],
                                  np.asarray(Image.open(tmp_path / "jax.png"))[sure])
    assert (tmp_path / "fig.png").stat().st_size > 0


def jaug_normalize(img_u8):
    from dinomc_tpu.ops.augment import normalize

    return normalize(jnp.asarray(img_u8.astype(np.float32) / 255.0), jsd.UAVID.mean, jsd.UAVID.std)


@pytest.mark.parametrize("tree", [False, True], ids=["synthetic", "folder"])
def test_evaluate_stitched_cli_matches_jax(tmp_path, f32_models, seg_pth, tree, capsys):
    from dinomc_tpu.cli import evaluate_stitched as jcli
    from dinomc_tpu_torch.cli import evaluate_stitched as tcli

    common = dict(arch="vit_tiny", patch_size=16, model_size=64, ckpt=seg_pth, grid=[2, 2])
    if tree:
        write_seg_folder(tmp_path / "data", 2, 64, jsd.UAVID, seed=15)
        common.update(data_root=str(tmp_path / "data"), full_res=[48, 70])
    else:
        common.update(limit=1)
    ref = jcli.run(_args(jcli, [], **common, export_logits_dir=str(tmp_path / "jax")))
    ours = tcli.run(_args(tcli, [], **common, device="cpu", export_logits_dir=str(tmp_path / "port")))
    meta = json.loads((tmp_path / "port" / "patches_metadata.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "patches_metadata.json").read_text())
    assert len(meta) == (8 if tree else 4)
    mismatched, total = 0, 0
    for name in meta:
        stem = os.path.splitext(name)[0] + ".npy"
        a, b = np.load(tmp_path / "port" / stem), np.load(tmp_path / "jax" / stem)
        assert a.shape == b.shape and a.dtype == np.float32
        _assert_logits_and_masks(torch.from_numpy(a).permute(1, 2, 0), b.transpose(1, 2, 0))
        mismatched += int((a.argmax(0) != b.argmax(0)).sum())
        total += a[0].size
    for k in ("miou", "mf1", "acc"):
        assert abs(ours[k] - float(ref[k])) <= mismatched / total + 1e-6, k
    assert "mIoU" in capsys.readouterr().out


def test_evaluate_stitched_cli_runs_and_refuses_what_is_unported(tmp_path, capsys):
    """The port-side twin of ``test_evaluate_stitched_cli``, with
    ``--seq_parallel 1``; ``> 1`` raises with its ROADMAP item."""
    from dinomc_tpu_torch.cli import evaluate_stitched as mod

    common = dict(arch="vit_tiny", patch_size=16, model_size=64, grid=[2, 2], limit=1,
                  device="cpu")
    scores = mod.run(_args(mod, [], **common, export_logits_dir=str(tmp_path / "logits"),
                           seq_parallel=1))
    assert 0.0 <= scores["miou"] <= 1.0
    meta = json.load(open(tmp_path / "logits" / "patches_metadata.json"))
    assert len(meta) == 4
    assert len([f for f in os.listdir(tmp_path / "logits") if f.endswith(".npy")]) == 4
    # the exported patches rebuild the in-memory canvas bit for bit
    canvases = {}
    mod.run(_args(mod, [], **common), on_frame=lambda stem, logits: canvases.update({stem: logits}))
    rebuilt = ttile.stitch_from_files(str(tmp_path / "logits"),
                                      str(tmp_path / "logits" / "patches_metadata.json"),
                                      (448, 448), basename="synthetic_0")
    assert torch.equal(rebuilt, canvases["synthetic_0"])
    with pytest.raises(ValueError, match="--seq_parallel 2 must divide the world size 1"):
        mod.run(_args(mod, [], **common, seq_parallel=2))
    orbax = tmp_path / "orbax"
    (orbax / "0").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="cli.convert_ckpt"):
        mod.run(_args(mod, [], **common, ckpt=str(orbax)))
    assert "mIoU" in capsys.readouterr().out


def test_predict_cli(tmp_path):
    """The port-side twin of ``test_predict_cli``, then ``--grid`` with a
    ``train_seg`` checkpoint directory as ``--ckpt``."""
    from dinomc_tpu_torch.cli import predict as mod

    img_path = str(tmp_path / "img.png")
    Image.fromarray((np.random.RandomState(0).rand(96, 128, 3) * 255).astype("uint8")).save(img_path)
    common = dict(arch="vit_tiny", patch_size=16, model_size=64, device="cpu")
    pred = mod.run(_args(mod, ["--image", img_path], **common, out=str(tmp_path / "pred.png"),
                         figure=str(tmp_path / "fig.png")))
    assert pred.shape == (96, 128)
    assert (tmp_path / "pred.png").exists() and (tmp_path / "fig.png").exists()

    # a train_seg checkpoint directory: its weights, not seed 0's
    cfg = tseg.SegConfig(model=tup.UPerNetConfig(num_classes=C, arch="vit_tiny", patch_size=16))
    state = tseg.init_seg_train_state(cfg, seed=5)
    CheckpointManager(str(tmp_path / "ckpts")).save(2, state)
    x = taug.normalize(t(np.asarray(Image.open(img_path), np.float32) / 255.0), tsd.UAVID.mean,
                       tsd.UAVID.std)
    want = ttile.tiled_predict(lambda b: tseg.seg_predict(state.model, b), x, (2, 2), 64)
    pred = mod.run(_args(mod, ["--image", img_path], **common, grid=[2, 2],
                         ckpt=str(tmp_path / "ckpts"), out=str(tmp_path / "pred2.png")))
    np.testing.assert_array_equal(pred, want.argmax(-1).numpy())
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "pred2.png")),
                                  tsd.class_to_rgb(pred, tsd.UAVID))
    with pytest.raises(ValueError, match="--seq_parallel 4 must divide the world size 1"):
        mod.run(_args(mod, ["--image", img_path], **common, seq_parallel=4))


@pytest.mark.parametrize("which", ["missing", "empty"])
def test_predict_refuses_a_ckpt_directory_without_a_checkpoint(tmp_path, which):
    """A ``--ckpt`` directory that does not exist (and is not created) or
    holds no checkpoint raises, rather than scoring seed-0 weights."""
    from dinomc_tpu_torch.cli import predict as mod

    ckpt = tmp_path / "ckpts"
    if which == "empty":
        ckpt.mkdir()
    args = _args(mod, ["--image", "unused.png"], arch="vit_tiny", patch_size=16, model_size=64,
                 device="cpu", ckpt=str(ckpt))
    with pytest.raises(FileNotFoundError, match="--ckpt"):
        mod.load_seg_model(args, tsd.UAVID, torch.device("cpu"))
    assert ckpt.exists() == (which == "empty")


def test_cli_flags_are_the_jax_clis_plus_device():
    from dinomc_tpu.cli import evaluate_stitched as jes
    from dinomc_tpu.cli import oscd as joscd
    from dinomc_tpu.cli import predict as jpred
    from dinomc_tpu_torch.cli import evaluate_stitched as tes
    from dinomc_tpu_torch.cli import oscd as toscd
    from dinomc_tpu_torch.cli import predict as tpred

    def flags(mod):
        return {a.dest: (a.default, a.choices, a.nargs, a.required)
                for a in mod.get_args_parser()._actions}

    for jmod, tmod in ((jes, tes), (jpred, tpred), (joscd, toscd)):
        ours, ref = flags(tmod), flags(jmod)
        assert ours.pop("device") == ("cuda", None, None, False)
        assert ours == ref


def test_the_three_clis_import_no_jax():
    code = (
        "import sys\n"
        "import dinomc_tpu_torch.cli.predict, dinomc_tpu_torch.cli.evaluate_stitched\n"
        "import dinomc_tpu_torch.cli.oscd\n"
        "from dinomc_tpu_torch.cli import predict, evaluate_stitched, oscd\n"
        "for m in (predict, evaluate_stitched, oscd):\n"
        "    m.get_args_parser()\n"
        "import dinomc_tpu_torch.eval.tiled_inference, dinomc_tpu_torch.data.patching\n"
        "import dinomc_tpu_torch.data.oscd, dinomc_tpu_torch.train.oscd_trainer\n"
        "import dinomc_tpu_torch.utils.visualization, dinomc_tpu_torch.ckpt.checkpoint\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'dinomc_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
