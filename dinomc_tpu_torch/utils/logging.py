"""Training-loop logging: smoothed meters, epoch iteration lines, JSONL,
the per-epoch CSV and optional Weights & Biases runs.

Counterpart of ``dinomc_tpu/utils/logging.py``: ``SmoothedValue`` /
``MetricLogger.log_every`` (reference ``utils/utils.py:239-416``),
``JsonlLogger`` (``main_dino_mc.py:348-350``); ``write_epoch_csv``,
``TensorBoardLogger``, ``WandbLogger``, ``Tee`` and ``Timer`` are copied as
they are (jax-free in the JAX package too). The memory readout is
``torch.cuda.memory_allocated`` when a card is in use.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Optional, Sequence

import torch


class SmoothedValue:
    """A series with a smoothing window (median/avg) and global stats."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


def _device_mem_mb() -> Optional[float]:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.memory_allocated() / 1024.0 / 1024.0
    return None


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self):
        """Sum each meter's (count, total) across processes, so
        ``global_avg`` covers every rank (reference ``SmoothedValue.
        synchronize_between_processes``, ``utils/utils.py:257-268,356-358``).
        The window statistics stay local, as in the reference. A no-op
        alone. Every rank must hold the same meter names."""
        from dinomc_tpu_torch.parallel import distributed as pd

        names = sorted(self.meters)
        if pd.get_world_size() < 2 or not names:
            return
        local = torch.tensor([[self.meters[n].count, self.meters[n].total] for n in names],
                             dtype=torch.float64, device=pd.comm_device())
        pd.all_reduce_(local)
        for n, (cnt, tot) in zip(names, local.tolist()):
            self.meters[n].count = int(cnt)
            self.meters[n].total = float(tot)

    def log_every(self, iterable, print_freq: int, header: str = "", total: Optional[int] = None):
        """Iterate with periodic ``header [i/N] eta ... meters time data mem``
        lines. Host-clock times: a step that does not sync is counted when
        a later one does."""
        total = total if total is not None else len(iterable)
        i = 0
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                mem = _device_mem_mb()
                mem_str = f"  mem: {mem:.0f}MB" if mem is not None else ""
                print(f"{header} [{i}/{total}]  eta: {eta}  {self}  "
                      f"time: {iter_time}  data: {data_time}{mem_str}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(total, 1):.4f} s / it)")


class JsonlLogger:
    """Append one JSON object per line (reference log.txt format)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, record: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def write_epoch_csv(
    path: str,
    epoch: int,
    scalars: Dict[str, float],
    per_class: Optional[Dict[str, Sequence[float]]] = None,
    class_names: Optional[Sequence[str]] = None,
) -> None:
    """Wide-format per-epoch CSV: one row per epoch, columns for scalars plus
    ``<metric>/<class>`` per-class columns. (Fixes the reference's
    late-binding bug at ``utils/metric_tool.py:355-367``.)"""
    row: Dict[str, float] = {"epoch": epoch, **scalars}
    if per_class:
        assert class_names is not None
        for metric, values in per_class.items():
            for cls_name, v in zip(class_names, values):
                row[f"{metric}/{cls_name}"] = float(v)
    exists = os.path.exists(path)
    fieldnames = list(row.keys())
    if exists:
        with open(path) as f:
            reader = csv.reader(f)
            try:
                fieldnames = next(reader)
            except StopIteration:
                exists = False
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        if not exists:
            writer.writeheader()
        writer.writerow(row)


class TensorBoardLogger:
    """Optional TensorBoard scalars/images (reference OSCD Lightning logging,
    ``main_oscd.py:54-78``). Gated: no-ops when tensorboard is unavailable."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception:
            self._w = None

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def image(self, tag: str, image, step: int) -> None:
        """image: (H, W, 3) float [0,1] or uint8."""
        if self._w is not None:
            import numpy as np

            arr = np.asarray(image)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            self._w.add_image(tag, arr, step, dataformats="HWC")

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class WandbLogger:
    """Optional Weights & Biases run logging (the reference seg trainers
    call ``wandb.init``/``wandb.log`` directly, ``train_dino_mc_seg.py:44-59,
    171-185``). Gated: no-ops unless the ``wandb`` package is importable AND
    a login is configured; training never depends on it."""

    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[Dict] = None, enabled: bool = True):
        self._run = None
        if not enabled:
            return
        try:
            import wandb

            self._run = wandb.init(project=project, name=name, config=config or {}, reinit=True)
        except Exception:
            self._run = None

    @property
    def active(self) -> bool:
        return self._run is not None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None


class Tee:
    """Mirror stdout to a log file (reference ``Logger``,
    ``utils/logger_tool.py``)."""

    def __init__(self, path: str):
        self.file = open(path, "a")
        self.stdout = sys.stdout

    def __enter__(self):
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self.stdout
        self.file.close()

    def write(self, msg):
        self.stdout.write(msg)
        self.file.write(msg)

    def flush(self):
        self.stdout.flush()
        self.file.flush()


class Timer:
    """Progress timer with ETA (reference ``Timer``, ``utils/logger_tool.py:33-72``)."""

    def __init__(self, total: int = 0):
        self.total = total
        self.start = time.time()
        self.done = 0

    def update(self, n: int = 1):
        self.done += n

    @property
    def elapsed(self) -> float:
        return time.time() - self.start

    @property
    def eta(self) -> float:
        if self.done == 0:
            return 0.0
        return self.elapsed / self.done * (self.total - self.done)
