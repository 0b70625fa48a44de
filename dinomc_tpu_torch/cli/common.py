"""Shared CLI utilities: bool flags, seeding, run directories, pretrained
backbones, the per-step record, and the multi-process pieces (the torchrun
process-group wrapper, the seg CLIs' ``seq`` layout, the fine-tune CLIs'
refusal of several processes).

Counterpart of ``dinomc_tpu/cli/common.py``, plus ``StepLog``, which the JAX
CLIs need not have (they keep one loss).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def refuse_multi_process(cli: str) -> None:
    """The fine-tune CLIs run one process: under a torchrun launch of
    several (``WORLD_SIZE`` > 1) they would run as independent copies, so
    they refuse it until their data-parallel path is ported."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"{cli} runs one process; its data-parallel path (WORLD_SIZE={world}) is not "
            "ported yet (ROADMAP.md queue 1 #17)")


def in_process_group(run, args, *rest, **kwargs):
    """``run(args, ...)`` inside torchrun's process group: joined (and torn
    down after) when torchrun's environment is set and no group is up yet,
    used as it is when the caller brought one up, none otherwise. Only rank
    0 prints (``setup_for_distributed``)."""
    from dinomc_tpu_torch.parallel import distributed as pd

    owns_group = not pd.is_initialized()
    if pd.init_distributed_mode(args.device):
        pd.setup_for_distributed()
    try:
        return run(args, *rest, **kwargs)
    finally:
        pd.destroy(keep_group=not owns_group)


def seq_mesh(seq_parallel: int):
    """The JAX seg CLIs' layout: ``seq_parallel`` ranks a ring, the world
    size over it the data axis; None at ``seq_parallel`` 1 (no ring)."""
    from dinomc_tpu_torch.core.mesh import make_mesh
    from dinomc_tpu_torch.parallel import distributed as pd

    sp, world = max(1, seq_parallel), pd.get_world_size()
    if world % sp:
        raise ValueError(f"--seq_parallel {sp} must divide the world size {world} "
                         "(the number of processes torchrun starts)")
    if sp == 1:
        return None
    mesh = make_mesh(data=world // sp, seq=sp)
    print(f"sequence-parallel backbone: mesh {mesh.shape}")
    return mesh


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


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


ORBAX_HINT = ("convert an orbax directory with the JAX package's `python -m "
              "dinomc_tpu.cli.convert_ckpt` in its JAX environment")


def orbax_refusal(path: str) -> NotImplementedError:
    """The error for a checkpoint directory where the port takes a ``.pth``:
    the port reads no orbax directory (orbax needs jax)."""
    return NotImplementedError(
        f"{path}: a directory, not a .pth file; the port reads no orbax checkpoint. Pass a "
        "reference .pth: convert a port checkpoint with `python -m "
        f"dinomc_tpu_torch.cli.convert_ckpt`, or {ORBAX_HINT}")


def load_pretrained_backbone(module, path: str, checkpoint_key: str = "teacher") -> None:
    """Load ``--pretrained_weights`` into the backbone ``module`` in place:
    a reference ``.pth`` (``load_pretrained_weights`` parity,
    ``utils/utils.py:75-119``). ``checkpoint_key``: 'teacher' (default),
    'student' or 'none'. An orbax checkpoint directory of the JAX package
    is refused with the routes to a ``.pth`` (``orbax_refusal``). So is any
    file for an XCiT: neither package maps a reference XCiT ``.pth`` onto its
    own XCiT (the JAX ``load_backbone_for_arch`` refuses it too)."""
    from dinomc_tpu_torch.ckpt.torch_import import load_backbone
    from dinomc_tpu_torch.models.xcit import XCiT

    if isinstance(module, XCiT):
        raise ValueError(f"{path}: no torch importer for XCiT (supported: the ViTs, "
                         "resnet50, wide_resnet50_2, swin_t); train it from this port's "
                         "own checkpoints instead")
    if os.path.isdir(path):
        raise orbax_refusal(path)
    key = None if checkpoint_key.lower() == "none" else checkpoint_key
    load_backbone(module, path, checkpoint_key=key)


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
