"""Host -> device input pipeline: sharded sampling and prefetch.

Counterpart of ``dinomc_tpu/data/loader.py``:
  * ``ShardedSampler``: deterministic per-epoch shuffle, sharded across
    processes (``DistributedSampler`` + ``set_epoch``,
    ``main_dino_mc.py:193,324-325``);
  * ``random_subset``: the seeded fraction of a dataset that
    ``--train_frac`` keeps (BigEarthNet-10%);
  * ``PrefetchLoader``: background threads assemble each batch on the host,
    copy it into pinned memory and start the copy to ``device``
    (non-blocking), keeping ``prefetch`` batches in flight. The copy is
    issued on the device's default stream, the one the step runs on, so a
    batch is complete before any kernel reads it.
Augmentation runs on the device, so host work is only decode + resize.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class ShardedSampler:
    """Deterministic per-epoch shuffle, sharded across processes."""

    def __init__(
        self,
        n: int,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_id: int = 0,
        seed: int = 0,
    ):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last = shuffle, drop_last
        self.num_shards, self.shard_id, self.seed = num_shards, shard_id, seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        # pad to a multiple of num_shards by wrapping, so every shard yields
        # the same number of batches
        total = -(-self.n // self.num_shards) * self.num_shards
        if total != self.n:
            order = np.concatenate([order, np.resize(order, total - self.n)])
        shard = order[self.shard_id :: self.num_shards]
        end = len(shard) - (len(shard) % self.batch_size if self.drop_last else 0)
        for s in range(0, end, self.batch_size):
            batch = shard[s : s + self.batch_size]
            if len(batch):
                yield batch

    def __len__(self) -> int:
        per_shard = -(-self.n // self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return (per_shard + self.batch_size - 1) // self.batch_size


def random_subset(n: int, frac: float, seed: int = 42) -> np.ndarray:
    """Seeded fractional subset of range(n) (``utils/data.py:27-30``)."""
    rng = np.random.RandomState(seed)
    k = int(round(n * frac))
    return rng.permutation(n)[:k]


class PrefetchLoader:
    """Batches assembled in background threads and copied to ``device``
    through pinned memory, ``prefetch`` batches ahead."""

    def __init__(
        self,
        dataset,
        sampler: ShardedSampler,
        device="cpu",
        prefetch: int = 2,
        num_threads: int = 4,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.num_threads = num_threads

    def __len__(self) -> int:
        return len(self.sampler)

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type != "cuda":
            return t.to(self.device)
        with torch.cuda.device(self.device):
            return t.pin_memory().to(self.device, non_blocking=True)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that notices the consumer leaving early
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        error: list = []
        pool = ThreadPoolExecutor(self.num_threads) if self.num_threads > 1 else None

        def fetch(idx) -> list:
            if pool is None:
                return [self.dataset[int(i)] for i in idx]
            return list(pool.map(self.dataset.__getitem__, [int(i) for i in idx]))

        def producer():
            try:
                for idx in self.sampler:
                    if stop.is_set():
                        return
                    if not put(self._to_device(np.stack(fetch(idx)))):
                        return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
            if error:
                raise error[0]
        finally:
            stop.set()
            t.join(timeout=10.0)
