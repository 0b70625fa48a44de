"""Shared CLI utilities: bool flags and seeding.

Counterpart of ``dinomc_tpu/cli/common.py`` (the parts the DINO CLI uses).
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
