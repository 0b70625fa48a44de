"""Packed-shard datasets: decode a corpus once offline, read fixed-size raw
uint8 records by ``memmap`` at train time.

The port's copy of ``dinomc_tpu/data/packed.py``: the writer
(``pack_dataset``, run by ``cli/pack_data.py``; for the same source tree it
writes the same shards and ``index.json`` as the JAX package's) and the
readers ``PackedReader``, ``PackedFlat``, ``PackedMC`` and
``PackedMCTemporal``. Layout of a packed dataset directory::

    index.json          {"record_shape": [H,W,C], "n": N,
                         "records_per_shard": R, "shards": [...],
                         "groups": [[rec,...],...], "names": [...]}
    shard-00000.bin     R records of H*W*C uint8, back to back

``groups`` keeps the SeCo location structure, so ``PackedMC`` samples as
``MCBase`` does (one random record per group, fixed at construction) and
``PackedMCTemporal`` as ``MCTemporal`` (3 random timestamps an item, drawn
again each epoch). Records stay uint8 to the device, where
``ops/augment.multicrop_augment`` (and ``multicrop_augment_tp``) convert
them to f32 / 255.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

INDEX_NAME = "index.json"

_IMG_EXTS = (".tif", ".tiff", ".png", ".jpg", ".jpeg")


def is_packed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, INDEX_NAME))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _collect_groups(root: str) -> Tuple[List[List[str]], List[str]]:
    """SeCo layout (a subdirectory a location) -> each group's files; a
    flat tree (no subdirectory with images) is one group a file."""
    rootp = Path(root)
    groups: List[List[str]] = []
    for loc in sorted(rootp.iterdir()):
        if not loc.is_dir():
            continue
        files = sorted(str(f) for f in loc.rglob("*") if f.suffix.lower() in _IMG_EXTS)
        if files:
            groups.append(files)
    if not groups:
        groups = [[f] for f in sorted(str(f) for f in rootp.rglob("*")
                                      if f.suffix.lower() in _IMG_EXTS)]
    names = [f for g in groups for f in g]
    return groups, names


def _decode_chunk(paths: Sequence[str], size: int, threads: int) -> np.ndarray:
    """(len(paths), size, size, 3) uint8 through the native thread pool when
    it decodes every file, else file by file through ``seco.read_image``."""
    from dinomc_tpu_torch.data import native_loader
    from dinomc_tpu_torch.data.seco import read_image

    if native_loader.available():
        out = native_loader.decode_batch(list(paths), size, size, threads)
        if out is not None:
            return out
    return np.stack([np.round(read_image(p, size=size) * 255.0).astype(np.uint8) for p in paths])


def pack_dataset(
    src_root: str,
    out_dir: str,
    size: int = 256,
    records_per_shard: int = 2048,
    threads: int = 8,
    chunk: int = 256,
) -> dict:
    """Decode every image under ``src_root`` once into shards in ``out_dir``;
    returns the index. Refuses to overwrite a packed dataset (delete the
    directory to pack again)."""
    if is_packed(out_dir):
        raise FileExistsError(f"{out_dir} already holds a packed dataset")
    os.makedirs(out_dir, exist_ok=True)
    groups_files, names = _collect_groups(src_root)
    if not names:
        raise FileNotFoundError(f"no images under {src_root}")

    shards: List[str] = []
    n_written = 0
    shard_f = None
    try:
        for start in range(0, len(names), chunk):
            for img in _decode_chunk(names[start:start + chunk], size, threads):
                if n_written % records_per_shard == 0:
                    if shard_f is not None:
                        shard_f.close()
                    shards.append(f"shard-{len(shards):05d}.bin")
                    shard_f = open(os.path.join(out_dir, shards[-1]), "wb")
                shard_f.write(np.ascontiguousarray(img, np.uint8).tobytes())
                n_written += 1
    finally:
        if shard_f is not None:
            shard_f.close()

    # the groups as record ids: records were written in group order
    groups_ids: List[List[int]] = []
    cursor = 0
    for g in groups_files:
        groups_ids.append(list(range(cursor, cursor + len(g))))
        cursor += len(g)
    index = {
        "version": 1,
        "record_shape": [size, size, 3],
        "dtype": "uint8",
        "n": n_written,
        "record_bytes": size * size * 3,
        "records_per_shard": records_per_shard,
        "shards": shards,
        "groups": groups_ids,
        "names": [os.path.relpath(p, src_root) for p in names],
    }
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return index


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


class PackedReader:
    """mmap view over a packed dataset: ``record(i)`` is a zero-copy uint8
    (H, W, C) view into the page cache."""

    def __init__(self, path: str):
        with open(os.path.join(path, INDEX_NAME)) as f:
            self.index = json.load(f)
        self.shape = tuple(self.index["record_shape"])
        self.n = int(self.index["n"])
        self.rps = int(self.index["records_per_shard"])
        self.groups: List[List[int]] = self.index["groups"]
        self._maps = []
        left = self.n
        for name in self.index["shards"]:
            k = min(self.rps, left)
            self._maps.append(np.memmap(os.path.join(path, name), dtype=np.uint8, mode="r",
                                        shape=(k,) + self.shape))
            left -= k

    def __len__(self) -> int:
        return self.n

    def record(self, i: int) -> np.ndarray:
        return self._maps[i // self.rps][i % self.rps]

    def batch(self, ids: Sequence[int]) -> np.ndarray:
        out = np.empty((len(ids),) + self.shape, np.uint8)
        for j, i in enumerate(ids):
            out[j] = self.record(int(i))
        return out


class PackedFlat:
    """Every record, one item each (``FlatImageFolder`` over packed data)."""

    def __init__(self, path: str, as_float: bool = False):
        self.reader = PackedReader(path)
        self.as_float = as_float

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, i: int) -> np.ndarray:
        rec = np.asarray(self.reader.record(i))
        return rec.astype(np.float32) / 255.0 if self.as_float else rec


class PackedMC:
    """``MCBase`` over packed data: ONE random record per group, fixed at
    construction (``dino_dataset.py:40-50`` semantics)."""

    def __init__(self, path: str, seed: int = 0, as_float: bool = False):
        self.reader = PackedReader(path)
        self.as_float = as_float
        rng = np.random.RandomState(seed)
        self.samples = [g[rng.randint(len(g))] for g in self.reader.groups]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> np.ndarray:
        rec = np.asarray(self.reader.record(self.samples[i]))
        return rec.astype(np.float32) / 255.0 if self.as_float else rec


class PackedMCTemporal:
    """``MCTemporal`` over packed data: 3 random timestamps an item, drawn
    again each epoch after ``set_epoch`` (``dino_dataset.py:89-128``); items
    are (4, H, W, C) = [t0, t1, t2, t0], as ``data/seco.MCTemporal``'s."""

    def __init__(self, path: str, seed: int = 0, as_float: bool = False):
        self.reader = PackedReader(path)
        self.as_float = as_float
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.reader.groups)

    def set_epoch(self, epoch: int) -> None:
        self._rng = np.random.RandomState(epoch)

    def __getitem__(self, i: int) -> np.ndarray:
        g = self.reader.groups[i]
        picks = self._rng.randint(len(g), size=3)
        t0, t1, t2 = (np.asarray(self.reader.record(g[j])) for j in picks)
        out = np.stack([t0, t1, t2, t0])
        return out.astype(np.float32) / 255.0 if self.as_float else out
