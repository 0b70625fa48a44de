"""Train-state checkpoints with restart-from-latest.

Counterpart of ``dinomc_tpu/ckpt/orbax_io.py`` (``CheckpointManager``): the
whole ``DinoTrainState`` (student, teacher, AdamW moments and counts,
centre, step, DropPath generator) goes through ``torch.save`` into
``<dir>/ckpt_<step>.pth``; the newest ``max_to_keep`` files are kept, plus
every multiple of ``keep_period``. A rerun with the same directory resumes
from the newest file (the reference's ``restart_from_checkpoint``,
``utils/utils.py:165-197``). Files are written to a temporary name and
renamed, so a crash never leaves a half-written checkpoint as the newest.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from dinomc_tpu_torch.train.dino_trainer import DinoTrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pth$")


def state_to_dict(state: DinoTrainState) -> dict:
    return {
        "step": int(state.step),
        "student": state.student.state_dict(),
        "teacher": state.teacher.state_dict(),
        "opt_state": state.opt_state,
        "center": state.center,
        "generator": state.generator.get_state(),
    }


@torch.no_grad()
def load_state_dict_into(state: DinoTrainState, saved: dict) -> None:
    """Restore ``saved`` into ``state`` in place, on the state's device."""
    state.student.load_state_dict(saved["student"], strict=True)
    state.teacher.load_state_dict(saved["teacher"], strict=True)
    dev = state.center.device
    for kind in ("mu", "nu"):
        for name, t in saved["opt_state"][kind].items():
            state.opt_state[kind][name].copy_(t)
    state.opt_state["count"] = dict(saved["opt_state"]["count"])
    state.center = saved["center"].to(dev)
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2, keep_period: Optional[int] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period

    def steps(self) -> List[int]:
        found = (_NAME.match(p.name) for p in self.dir.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.pth"

    def save(self, step: int, state: DinoTrainState) -> Path:
        path = self.path(step)
        tmp = path.with_suffix(".tmp")
        torch.save(state_to_dict(state), tmp)
        os.replace(tmp, path)
        steps = self.steps()
        for s in steps[: -self.max_to_keep]:
            if not (self.keep_period and s % self.keep_period == 0):
                self.path(s).unlink()
        return path

    def restore(self, state: DinoTrainState) -> bool:
        """Load the newest checkpoint into ``state``; False when there is
        none."""
        step = self.latest_step()
        if step is None:
            return False
        # weights_only: checkpoints hold tensors, ints and dicts only
        saved = torch.load(self.path(step), map_location="cpu", weights_only=True)
        load_state_dict_into(state, saved)
        return True
