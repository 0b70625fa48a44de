"""Shared CLI utilities: bool flags, seeding and the per-step record.

Counterpart of ``dinomc_tpu/cli/common.py`` (the parts the DINO CLI uses),
plus ``StepLog``, which the JAX CLIs need not have (they keep one loss).
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch


def bool_flag(s: str) -> bool:
    """Parse boolean CLI args (reference ``bool_flag``, ``utils/utils.py:216-227``)."""
    truthy = {"on", "true", "1", "yes"}
    falsy = {"off", "false", "0", "no"}
    if s.lower() in truthy:
        return True
    if s.lower() in falsy:
        return False
    raise argparse.ArgumentTypeError(f"invalid bool value {s!r}")


def set_seed(seed: int) -> None:
    """Host-side seeding; device-side draws use explicit generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class StepLog:
    """A run's per-step losses as host floats and, on a card, its per-step
    device ms (CUDA events around augmentation + step). A step's loss tensor
    and events stay on the device only until the next ``flush``, which the
    CLIs call at each print step, where the host syncs anyway, and at the
    end: a run holds at most ``print_freq`` of them, however long it is."""

    def __init__(self, timed: bool):
        self.timed = timed
        self.losses: list = []
        self.step_ms: list = []
        self._pending: list = []  # (loss tensor, start event, end event)

    def begin(self):
        """Mark a step's start: a recorded CUDA event on a card, else None."""
        if not self.timed:
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start

    def end(self, loss: torch.Tensor, start) -> None:
        """Mark the end of the step that ``begin`` returned ``start`` for."""
        end = None
        if self.timed:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self._pending.append((loss, start, end))

    def flush(self) -> None:
        """Turn the pending steps into host floats (syncs with the card)."""
        for loss, start, end in self._pending:
            self.losses.append(float(loss))
            if end is not None:
                end.synchronize()
                self.step_ms.append(start.elapsed_time(end))
        self._pending.clear()
