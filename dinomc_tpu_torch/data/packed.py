"""Packed-shard datasets: fixed-size raw uint8 records, read by ``memmap``.

The port's copy of the reader side of ``dinomc_tpu/data/packed.py``; the
shards are written offline by that module's ``pack_dataset``. Layout of a
packed dataset directory::

    index.json          {"record_shape": [H,W,C], "n": N,
                         "records_per_shard": R, "shards": [...],
                         "groups": [[rec,...],...], "names": [...]}
    shard-00000.bin     R records of H*W*C uint8, back to back

``groups`` keeps the SeCo location structure, so ``PackedMC`` samples as
``MCBase`` does: one random record per group, fixed at construction.
Records stay uint8 to the device, where ``ops/augment.multicrop_augment``
converts them to f32 / 255.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np

INDEX_NAME = "index.json"


def is_packed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, INDEX_NAME))


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
