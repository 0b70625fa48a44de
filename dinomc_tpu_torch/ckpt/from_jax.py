"""Carry JAX-package parameters into the port.

The JAX trees go through ``ckpt/state_dicts.py`` (the port's numpy copies
of the JAX package's exporters), which emit the reference's
timm/DINO/torchvision/mmseg state-dict layout; the port's modules use the
same names, so each load is ``load_state_dict(strict=True)``. Inputs are
numpy trees (or anything ``np.asarray`` reads, such as host copies of JAX
arrays). A UPerNet takes a ``(params, bn_state)`` pair. A ViT loads the
same tree whatever its ``mlp_impl``: the dense and the fused MLP read the
same ``fc1``/``fc2`` tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from dinomc_tpu_torch.ckpt.state_dicts import (
    dino_head_state_dict,
    swin_state_dict,
    upernet_state_dict,
    vit_state_dict,
)
from dinomc_tpu_torch.models.dino_head import DINOHead
from dinomc_tpu_torch.models.swin import SwinTransformer
from dinomc_tpu_torch.models.upernet import UPerNet
from dinomc_tpu_torch.models.vit import VisionTransformer
from dinomc_tpu_torch.train import optim
from dinomc_tpu_torch.train.dino_trainer import DinoTrainState
from dinomc_tpu_torch.train.seg_trainer import SegTrainState


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)) for k, v in sd.items()}


def state_dict_from_jax(module: nn.Module, params: Any) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``module`` built from the matching JAX tree:
    a ViT or Swin tree, a DINO-head tree, a ``{'backbone', 'head'}`` tree
    (ViT or Swin backbone), or a UPerNet's ``(params, bn_state)``."""
    backbones = {VisionTransformer: vit_state_dict, SwinTransformer: swin_state_dict}
    if isinstance(module, UPerNet):
        return _tensors(upernet_state_dict(*params))
    if type(module) in backbones:
        return _tensors(backbones[type(module)](params))
    if isinstance(module, DINOHead):
        return _tensors(dino_head_state_dict(params))
    if isinstance(module, nn.ModuleDict) and set(module.keys()) == {"backbone", "head"}:
        sd = backbones[type(module["backbone"])](params["backbone"], "backbone.")
        sd.update(dino_head_state_dict(params["head"], "head."))
        return _tensors(sd)
    raise TypeError(f"no JAX parameter mapping for {type(module).__name__}")


@torch.no_grad()
def load_jax_params(module_or_state, jax_params) -> None:
    """Copy JAX parameters into a port module or train state, in place.

    For a ``DinoTrainState``, ``jax_params`` is a JAX ``DinoTrainState`` (or
    any object with ``student``, ``teacher``, ``center`` and ``step``):
    student, teacher, centre and step are copied and the AdamW moments and
    counts start from zero, as the JAX package's freshly initialized state
    has them. For a ``SegTrainState``, ``jax_params`` is a JAX
    ``SegTrainState``: parameters, BatchNorm statistics and step are copied,
    the AdamW state starts from zero."""
    if isinstance(module_or_state, SegTrainState):
        st = module_or_state
        load_jax_params(st.model, (jax_params.params, jax_params.bn_state))
        st.step = int(np.asarray(jax_params.step))
        st.opt_state = optim.adamw_init(dict(st.model.named_parameters()))
        return
    if isinstance(module_or_state, DinoTrainState):
        st = module_or_state
        load_jax_params(st.student, jax_params.student)
        load_jax_params(st.teacher, jax_params.teacher)
        st.center = torch.from_numpy(np.array(jax_params.center, np.float32)).to(st.center.device)
        st.step = int(np.asarray(jax_params.step))
        st.opt_state = optim.adamw_init(dict(st.student.named_parameters()))
        return
    module = module_or_state
    module.load_state_dict(state_dict_from_jax(module, jax_params), strict=True)
