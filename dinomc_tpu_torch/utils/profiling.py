"""Tracing and profiling hooks.

Counterpart of ``dinomc_tpu/utils/profiling.py``, with its names: ``trace``
wraps ``torch.profiler.profile`` (CPU and, with a card, CUDA activities)
and writes a Chrome trace (``trace.json``, viewable in Perfetto or
``chrome://tracing``) into ``log_dir``; ``annotate`` is a named region in
that trace; ``sync`` waits for the device work of a tree's first tensor;
``StepTimer`` times steps by the host clock, syncing every ``sync_every``
steps; ``device_memory_stats`` reads the card's allocator.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; on exit, write ``log_dir/trace.json``.
    Yields the profiler, whose ``key_averages()`` sums the block by op."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace (shows up in the timeline)."""
    return torch.profiler.record_function(name)


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(
        tree, (list, tuple)) else ()
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def sync(tree) -> None:
    """Wait for the device of the first tensor leaf of ``tree`` to finish its
    queued work (nothing to wait for on the CPU)."""
    t = _first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Wall-clock step timing with a periodic device sync."""

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self._count = 0
        self._last = time.perf_counter()
        self.history: list = []

    def step(self, outputs=None) -> Optional[float]:
        """Call once per train step; returns ms a step for synced steps."""
        self._count += 1
        if self._count % self.sync_every == 0 and outputs is not None:
            sync(outputs)
            now = time.perf_counter()
            ms = (now - self._last) / self.sync_every * 1000.0
            self._last = now
            self.history.append(ms)
            return ms
        return None


def device_memory_stats() -> Dict[str, float]:
    """MB allocated by tensors and the card's total memory for device 0;
    ``{}`` with no card."""
    if not torch.cuda.is_available():
        return {}
    _, total = torch.cuda.mem_get_info(0)
    return {"mb_in_use": torch.cuda.memory_allocated(0) / 1e6, "mb_limit": total / 1e6}
