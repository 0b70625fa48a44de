"""Train-state checkpoints with restart-from-latest.

Counterpart of ``dinomc_tpu/ckpt/orbax_io.py`` (``CheckpointManager``): a
whole train state goes through ``torch.save`` into
``<dir>/ckpt_<step>.pth``. For a ``DinoTrainState`` that is the student,
teacher, AdamW moments and counts, centre, step and DropPath generator; for
a ``SegTrainState`` the UPerNet (parameters and BatchNorm statistics), AdamW
state, step and dropout generator; for a ``ClsTrainState`` the backbone and
classifier, optimizer state, step and generator; for an ``OSCDTrainState``
the siamese model (its encoder's BatchNorm statistics included), Adam state,
step and generator. The newest ``max_to_keep`` files are kept, plus every
multiple of ``keep_period``; with ``best_mode='max'`` the ``max_to_keep``
files of highest metric are kept instead (the seg trainer's best-mIoU, the
EuroSAT CLI's best-accuracy and the OSCD CLI's best-F1 checkpoint). A rerun
with the same directory resumes from the newest file (the reference's
``restart_from_checkpoint``, ``utils/utils.py:165-197``). Files are written
to a temporary name and renamed, so a crash never leaves a half-written
checkpoint as the newest.

Under a process group every rank calls ``save`` and ``restore``. ``save``
gathers a sharded DINO state's optimizer moments whole (a collective; the
modules hold full tensors already, ``core/mesh.shard_dino_state``), rank 0
alone writes the file in the layout above, and every rank waits at a barrier.
``restore`` reads the file on every rank and keeps of each split moment this
rank's block, so a checkpoint written at one world size resumes at another.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import List, Optional, Union

import torch

from dinomc_tpu_torch.core import mesh as core_mesh
from dinomc_tpu_torch.parallel import distributed as pd
from dinomc_tpu_torch.train.cls_trainer import ClsTrainState
from dinomc_tpu_torch.train.dino_trainer import DinoTrainState
from dinomc_tpu_torch.train.oscd_trainer import OSCDTrainState
from dinomc_tpu_torch.train.seg_trainer import SegTrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pth$")
TrainState = Union[DinoTrainState, SegTrainState, ClsTrainState, OSCDTrainState]
_ONE_MODEL = (SegTrainState, ClsTrainState, OSCDTrainState)


def _load_opt_state(opt_state: dict, saved: dict, mesh=None, placements=None) -> None:
    """AdamW's moments and counts, or SGD's momentum buffers; a split
    moment takes this rank's block of the saved whole one."""
    for kind, entries in saved.items():
        if kind == "count":
            opt_state["count"] = dict(entries)
            continue
        for name, t in entries.items():
            if mesh is not None and placements.get(name) is not None:
                t = core_mesh.shard(mesh, t, placements[name])
            opt_state[kind][name].copy_(t)


def state_to_dict(state: TrainState) -> dict:
    if isinstance(state, _ONE_MODEL):
        return {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "opt_state": state.opt_state,
            "generator": state.generator.get_state(),
        }
    return {
        "step": int(state.step),
        "student": state.student.state_dict(),
        "teacher": state.teacher.state_dict(),
        "opt_state": core_mesh.full_opt_state(state),
        "center": state.center,
        "generator": state.generator.get_state(),
    }


@torch.no_grad()
def load_state_dict_into(state: TrainState, saved: dict) -> None:
    """Restore ``saved`` into ``state`` in place, on the state's device."""
    _load_opt_state(state.opt_state, saved["opt_state"], getattr(state, "mesh", None),
                    getattr(state, "placements", None))
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])
    if isinstance(state, _ONE_MODEL):
        state.model.load_state_dict(saved["model"], strict=True)
        return
    state.student.load_state_dict(saved["student"], strict=True)
    state.teacher.load_state_dict(saved["teacher"], strict=True)
    state.center = saved["center"].to(state.center.device)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2, keep_period: Optional[int] = None,
                 best_mode: Optional[str] = None):
        if best_mode not in (None, "max"):
            raise ValueError(f"best_mode must be None or 'max', got {best_mode!r}")
        self.dir = Path(directory)
        if pd.is_main_process():
            self.dir.mkdir(parents=True, exist_ok=True)
        pd.barrier()
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.best_mode = best_mode
        self._metrics_path = self.dir / "metrics.json"

    def steps(self) -> List[int]:
        found = (_NAME.match(p.name) for p in self.dir.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.pth"

    def metrics(self) -> dict:
        """{step: metric} of the kept checkpoints saved with a metric."""
        if not self._metrics_path.exists():
            return {}
        return {int(k): v for k, v in json.loads(self._metrics_path.read_text()).items()}

    def save(self, step: int, state: TrainState, metric: Optional[float] = None) -> Path:
        path = self.path(step)
        saved = state_to_dict(state)  # every rank: the gathers are collectives
        if pd.is_main_process():
            self._write(path, step, saved, metric)
        pd.barrier()
        return path

    def _write(self, path: Path, step: int, saved: dict, metric: Optional[float]) -> None:
        tmp = path.with_suffix(".tmp")
        torch.save(saved, tmp)
        os.replace(tmp, path)
        steps = self.steps()
        metrics = self.metrics()
        if metric is not None:
            metrics[step] = float(metric)
        if self.best_mode:  # best first, the newer of equal metrics first
            ranked = sorted(steps, key=lambda s: (metrics.get(s, float("-inf")), s), reverse=True)
            drop = ranked[self.max_to_keep:]
        else:
            drop = steps[: -self.max_to_keep]
        for s in drop:
            if not (self.keep_period and s % self.keep_period == 0):
                self.path(s).unlink()
                metrics.pop(s, None)
        if metrics:
            self._metrics_path.write_text(json.dumps({str(k): v for k, v in metrics.items()}))

    def restore(self, state: TrainState) -> bool:
        """Load the newest checkpoint into ``state``; False when there is
        none."""
        step = self.latest_step()
        if step is None:
            return False
        # weights_only: checkpoints hold tensors, ints and dicts only
        saved = torch.load(self.path(step), map_location="cpu", weights_only=True)
        load_state_dict_into(state, saved)
        return True
