"""Per-iteration schedules (numpy, host-side).

Counterpart of ``dinomc_tpu/core/schedules.py``, which is not imported here
because it imports jax. Parity target: the reference's ``cosine_scheduler``
(``utils/utils.py:200-213``) and teacher-temperature warmup
(``main_dino_mc.py:431-435``). The trainer reads one entry per step on the
host, so a schedule change costs nothing on the device.
"""

from __future__ import annotations

import numpy as np


def cosine_scheduler(
    base_value: float,
    final_value: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
) -> np.ndarray:
    """Linear warmup ``np.linspace(start, base, warmup_iters)`` then
    ``final + 0.5*(base-final)*(1+cos(pi * i/len))`` over the remaining
    iterations; one entry per iteration."""
    warmup_iters = min(int(warmup_epochs * niter_per_ep), epochs * niter_per_ep)
    warmup_schedule = np.array([])
    if warmup_iters > 0:
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)

    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    denom = max(len(iters), 1)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / denom)
    )

    schedule = np.concatenate((warmup_schedule, schedule))
    if len(schedule) != epochs * niter_per_ep:
        raise ValueError(f"schedule has {len(schedule)} entries, want {epochs * niter_per_ep}")
    return schedule


def linear_scaled_lr(base_lr: float, global_batch_size: int) -> float:
    """DINO linear lr scaling rule: lr * total_batch / 256
    (``main_dino_mc.py:293-298``)."""
    return base_lr * global_batch_size / 256.0


def teacher_temp_schedule(
    warmup_teacher_temp: float,
    teacher_temp: float,
    warmup_teacher_temp_epochs: int,
    epochs: int,
) -> np.ndarray:
    """Per-epoch teacher temperature: linear warmup then constant."""
    return np.concatenate(
        (
            np.linspace(warmup_teacher_temp, teacher_temp, warmup_teacher_temp_epochs),
            np.ones(epochs - warmup_teacher_temp_epochs) * teacher_temp,
        )
    )
