"""Load reference PyTorch checkpoints into the port's modules.

The reference's ``load_pretrained_weights`` (``utils/utils.py:75-119``)
picks a checkpoint key (``'teacher'`` in DINO-MC checkpoints; none in
Facebook DINO/DeiT files) and strips the ``module.`` and ``backbone.``
prefixes; the JAX package's ``ckpt/torch_import.load_torch_state_dict`` does
the same. The port's modules already carry the reference's names, so the
result loads directly, with no JAX tree in between.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn


def load_torch_state_dict(path: str, checkpoint_key: Optional[str] = "teacher") -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` file -> flat {name: CPU tensor}: ``checkpoint_key``'s
    entry when the file has one, a ``state_dict`` entry unwrapped, and every
    ``module.`` / ``backbone.`` removed from the names."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and checkpoint_key and checkpoint_key in ckpt:
        ckpt = ckpt[checkpoint_key]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k.replace("module.", "").replace("backbone.", ""): torch.as_tensor(v).detach().cpu()
            for k, v in ckpt.items()}


@torch.no_grad()
def load_backbone(module: nn.Module, path: str, checkpoint_key: Optional[str] = "teacher") -> None:
    """Load a reference checkpoint's backbone into ``module`` with
    ``strict=True``: each of the module's tensors must be in the file (as
    f32); the file's other entries (a DINO head, say) are left out."""
    sd = load_torch_state_dict(path, checkpoint_key)
    names = module.state_dict().keys()
    missing = sorted(n for n in names if n not in sd)
    if missing:
        raise KeyError(f"{path}: no tensor for {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    module.load_state_dict({n: sd[n].float() for n in names}, strict=True)
