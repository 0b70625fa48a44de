"""The port's multispectral readers (``data/seco.py``: ``read_bands``,
``_normalize_band``, ``_read_raw_band``, ``MCBase(bands=)``,
``MCTemporal``), the packed-corpus writer and its readers
(``data/packed.py``: ``pack_dataset``, ``PackedFlat``,
``PackedMCTemporal``), ``cli/pack_data.py`` and ``train_dino --bands``,
against the JAX package's copies of the same.

The same files go through both packages; the outputs must be equal: the
same arrays (dtype and value), the same timestamps picked per epoch, shards
equal byte for byte and an equal ``index.json``.
"""

import json
import math
import os

import numpy as np
import pytest
from PIL import Image

from dinomc_tpu.cli import pack_data as jpack_cli
from dinomc_tpu.data import native_loader as jnative
from dinomc_tpu.data import packed as jpacked
from dinomc_tpu.data import seco as jseco
from dinomc_tpu_torch.cli import pack_data as tpack_cli
from dinomc_tpu_torch.cli.train_dino import get_args_parser, train_dino
from dinomc_tpu_torch.data import native_loader as tnative
from dinomc_tpu_torch.data import packed as tpacked
from dinomc_tpu_torch.data import seco as tseco
from _torch_port import one_torch_thread  # noqa: F401

BANDS = ["B4", "B3", "B2"]


def _band_tree(root, locations=3, stamps=2, size=40, seed=0):
    """SeCo's multispectral layout: root/<location>/<timestamp>/{B}.tif, one
    uint16 band a file (PIL ``I;16``), digital numbers around the
    quantiles (some below and above them, so the clip engages), plus a B8
    band that has no quantiles."""
    rng = np.random.RandomState(seed)
    for loc in range(locations):
        for s in range(stamps):
            d = root / f"{loc:03d}" / f"t{s}"
            d.mkdir(parents=True)
            for b in BANDS + ["B8"]:
                img = Image.fromarray(rng.randint(0, 160, (size, size + 2)).astype(np.uint16))
                assert img.mode == "I;16"
                img.save(d / f"{b}.tif")
    return root


@pytest.fixture
def band_tree(tmp_path):
    return _band_tree(tmp_path / "bands")


def test_normalize_band_is_the_original():
    raw = np.random.default_rng(1).uniform(-20, 300, (17, 9)).astype(np.float32)
    for lo, hi in [(0.0, 129.0), (3.0, 88.0), (5.0, 5.0), (-1.0, 400.0)]:
        ours, ref = tseco._normalize_band(raw, lo, hi), jseco._normalize_band(raw, lo, hi)
        assert ours.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
    assert tseco.QUANTILES == jseco.QUANTILES and tseco.RGB_BANDS == jseco.RGB_BANDS


@pytest.mark.parametrize("reader", ["native", "pil"])
def test_band_readers_read_what_the_originals_read(band_tree, tmp_path, monkeypatch, reader):
    """``_read_raw_band`` and ``read_bands`` on per-band directories (every
    band, and B8 without quantiles) and on one 3-band file (bands by
    position), through the native reader and, with it refused, through
    PIL."""
    if reader == "pil":
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "read_band", lambda path, band=1: None)
    elif not tnative.available():
        pytest.skip("the native image loader is not built here")
    rgb = tmp_path / "rgb.tif"
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (24, 30, 3), dtype=np.uint8)).save(rgb)
    stamp = str(band_tree / "001" / "t1")
    for band in (1, 2, 3):
        ours, ref = tseco._read_raw_band(str(rgb), band), jseco._read_raw_band(str(rgb), band)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    raw = tseco._read_raw_band(os.path.join(stamp, "B4.tif"))
    np.testing.assert_array_equal(raw, jseco._read_raw_band(os.path.join(stamp, "B4.tif")))
    assert raw.shape == (40, 42) and raw.max() > 129  # above B4's quantile: clipped
    for path, bands in ((stamp, BANDS), (stamp, ["B8", "B2", "B3"]), (str(rgb), BANDS)):
        ours, ref = tseco.read_bands(path, bands), jseco.read_bands(path, bands)
        assert ours.dtype == ref.dtype == np.uint8 and ours.shape[-1] == 3
        np.testing.assert_array_equal(ours, ref)
    for size in (None, 32):
        np.testing.assert_array_equal(tseco.read_image(stamp, bands=BANDS, size=size),
                                      jseco.read_image(stamp, bands=BANDS, size=size))


def test_native_band_reader_is_the_original(band_tree):
    if not tnative.available():
        pytest.skip("the native image loader is not built here")
    path = str(band_tree / "000" / "t0" / "B3.tif")
    np.testing.assert_array_equal(tnative.read_band(path), jnative.read_band(path))
    assert tnative.read_band(str(band_tree / "missing.tif")) is None


@pytest.mark.parametrize("bands", [None, BANDS], ids=["rgb", "bands"])
def test_mc_datasets_are_the_originals(band_tree, tmp_path, bands):
    """``MCBase`` and ``MCTemporal`` on the same tree: the same samples and
    arrays, and ``MCTemporal``'s picks per epoch after ``set_epoch``. With
    ``bands``, each timestamp directory is a sample; without, a tree of
    PNGs."""
    root = band_tree
    if bands is None:
        root = tmp_path / "rgb"
        rng = np.random.default_rng(5)
        for loc in range(3):
            (root / f"{loc}").mkdir(parents=True)
            for s in range(3):
                Image.fromarray(rng.integers(0, 256, (30, 34, 3), dtype=np.uint8)).save(
                    root / f"{loc}" / f"t{s}.png")
    ours = tseco.MCBase(str(root), image_size=32, seed=4, bands=bands)
    ref = jseco.MCBase(str(root), image_size=32, seed=4, bands=bands)
    assert ours.samples == ref.samples and len(ours) == 3
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i], ref[i])
    ours = tseco.MCTemporal(str(root), image_size=32, seed=4, bands=bands)
    ref = jseco.MCTemporal(str(root), image_size=32, seed=4, bands=bands)
    assert ours.locations == ref.locations and len(ours) == 3
    for epoch in (None, 0, 3):
        if epoch is not None:
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a.shape == (4, 32, 32, 3) and a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a[0], a[3])


def _rgb_tree(root, layout):
    """A SeCo layout (3 locations, 1-3 JPEG/PNG timestamps each, one in a
    nested directory) or a flat one (files only)."""
    rng = np.random.default_rng(6)
    root.mkdir(parents=True)
    for loc in range(3):
        d = root if layout == "flat" else root / f"loc{loc}"
        for s in range(loc + 1):
            sub = d / "nested" if (layout == "seco" and s == 2) else d
            sub.mkdir(parents=True, exist_ok=True)
            img = rng.integers(0, 256, (20 + loc, 26, 3), dtype=np.uint8)
            Image.fromarray(img).save(sub / f"l{loc}_t{s}{'.png' if s % 2 else '.jpg'}")
    return root


@pytest.mark.parametrize("layout", ["seco", "flat"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_pack_dataset_writes_the_originals_bytes(tmp_path, monkeypatch, layout, native):
    """Shards byte for byte and an equal index, 4 records a shard over 2-3
    shards, through the native batch decoder and through the per-file
    fallback; then the readers over it give the original readers' items."""
    if not native:
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "decode_batch", lambda *a, **k: None)
    elif not tnative.available():
        pytest.skip("the native image loader is not built here")
    src = _rgb_tree(tmp_path / "src", layout)
    ours = tpacked.pack_dataset(str(src), str(tmp_path / "ours"), size=16, records_per_shard=4,
                                chunk=3)
    ref = jpacked.pack_dataset(str(src), str(tmp_path / "ref"), size=16, records_per_shard=4,
                               chunk=3)
    assert ours == ref and len(ref["shards"]) >= 2
    with open(tmp_path / "ours" / "index.json") as a, open(tmp_path / "ref" / "index.json") as b:
        assert json.load(a) == json.load(b)
    for shard in ref["shards"]:
        assert (tmp_path / "ours" / shard).read_bytes() == (tmp_path / "ref" / shard).read_bytes()
    assert [len(g) for g in ref["groups"]] == ([1, 2, 3] if layout == "seco" else [1] * 6)

    path = str(tmp_path / "ours")
    for as_float in (False, True):
        pairs = [(tpacked.PackedFlat(path, as_float), jpacked.PackedFlat(path, as_float)),
                 (tpacked.PackedMCTemporal(path, 2, as_float),
                  jpacked.PackedMCTemporal(path, 2, as_float))]
        for a, b in pairs:
            assert len(a) == len(b)
            for epoch in (None, 1):
                if epoch is not None:
                    a.set_epoch(epoch)
                    b.set_epoch(epoch)
                for i in range(len(b)):
                    x, y = a[i], b[i]
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
                if not hasattr(a, "set_epoch"):
                    break


def test_pack_dataset_refuses_to_overwrite(tmp_path):
    src = _rgb_tree(tmp_path / "src", "seco")
    tpacked.pack_dataset(str(src), str(tmp_path / "out"), size=8)
    before = (tmp_path / "out" / "index.json").read_text()
    with pytest.raises(FileExistsError, match="already holds a packed dataset"):
        tpacked.pack_dataset(str(src), str(tmp_path / "out"), size=8)
    assert (tmp_path / "out" / "index.json").read_text() == before
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no images under"):
        tpacked.pack_dataset(str(tmp_path / "empty"), str(tmp_path / "out2"), size=8)


def test_pack_data_cli_prints_the_originals_line(tmp_path, capsys, monkeypatch):
    """The same flags and the same JSON line (its timings aside) as
    ``dinomc_tpu/cli/pack_data.py``, and the same corpus on disk."""
    src = _rgb_tree(tmp_path / "src", "seco")
    flags = ["--src", str(src), "--size", "24", "--records_per_shard", "2", "--threads", "2"]
    ours = tpack_cli.main(flags + ["--out", str(tmp_path / "ours")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == ours
    monkeypatch.setattr("sys.argv", ["pack_data"] + flags + ["--out", str(tmp_path / "ref")])
    jpack_cli.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(ref)
    timing = ("seconds", "images_per_sec")
    assert {k: v for k, v in ours.items() if k not in timing} == {
        k: v for k, v in ref.items() if k not in timing}
    assert ours["packed"] == 6 and ours["groups"] == 3 and ours["shards"] == 3
    assert ours["record_shape"] == [24, 24, 3]
    for shard in json.loads((tmp_path / "ref" / "index.json").read_text())["shards"]:
        assert (tmp_path / "ours" / shard).read_bytes() == (tmp_path / "ref" / shard).read_bytes()
    ours_flags = {a.dest: a.default for a in tpack_cli.get_args_parser()._actions}
    assert ours_flags == {a.dest: a.default for a in jpack_cli.get_args_parser()._actions}


SMOKE = [
    "--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16", "--out_dim", "128",
    "--batch_size_per_gpu", "1", "--epochs", "1", "--max_steps", "1", "--local_crops_number",
    "2", "--size_crops", "96", "64", "--warmup_epochs", "0", "--image_size", "128",
    "--print_freq", "1", "--num_workers", "1",
]


@pytest.mark.parametrize("mode", ["mc", "tp"])
def test_cli_bands_runs_one_step(tmp_path, mode):
    """``train_dino --bands B4 B3 B2`` over a tree of uint16 per-band TIFFs
    (JAX tests/test_cli_smoke.py's case), in MC and TP mode: one step, a
    finite loss."""
    data = _band_tree(tmp_path / "bands", locations=2, stamps=2, size=128)
    out = train_dino(get_args_parser().parse_args(SMOKE + [
        "--data_path", str(data), "--bands", *BANDS, "--data_mode", mode,
        "--output_dir", str(tmp_path / "run")]))
    assert len(out.losses) == 1 and math.isfinite(out.losses[0])


def test_cli_bands_takes_exactly_three(tmp_path):
    with pytest.raises(AssertionError, match="exactly 3 band names"):
        train_dino(get_args_parser().parse_args(SMOKE + [
            "--bands", "B4", "B3", "--output_dir", str(tmp_path)]))


def test_cli_trains_mc_from_a_packed_corpus(tmp_path):
    """``--data_mode mc`` on a corpus that ``cli.pack_data`` wrote."""
    src = _rgb_tree(tmp_path / "src", "seco")
    tpack_cli.main(["--src", str(src), "--out", str(tmp_path / "packed"), "--size", "128"])
    out = train_dino(get_args_parser().parse_args(SMOKE + [
        "--data_path", str(tmp_path / "packed"), "--output_dir", str(tmp_path / "run")]))
    assert len(out.losses) == 1 and math.isfinite(out.losses[0])
