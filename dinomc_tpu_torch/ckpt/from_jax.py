"""Carry JAX-package parameters into the port.

The JAX trees go through ``ckpt/state_dicts.py`` (the port's numpy copies
of the JAX package's exporters), which emit the reference's
timm/DINO/torchvision/mmseg state-dict layout; the port's modules use the
same names, so each load is ``load_state_dict(strict=True)``. Inputs are
numpy trees (or anything ``np.asarray`` reads, such as host copies of JAX
arrays). A UPerNet or a ResNet takes a ``(params, bn_state)`` pair, its
running statistics included. A ViT loads the same tree whatever its
``mlp_impl``: the dense and the fused MLP read the same ``fc1``/``fc2``
tensors. A DINO head with BatchNorm has no exporter in the JAX package
(``torch_export.py:85-89`` refuses it), so it is mapped here, to the
reference's shifted Sequential indices; so is the OSCD ``Siamese`` (its
encoder through ``resnet_state_dict``, its decoder convolutions HWIO ->
OIHW under the JAX tree's names), which the JAX package never exports, and
XCiT (``xcit_state_dict``: the JAX tree's names, its stacked blocks split
into one module a layer), which has no ``.pth`` layout in either package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from dinomc_tpu_torch.ckpt.state_dicts import (
    dino_head_state_dict,
    resnet_state_dict,
    swin_state_dict,
    upernet_state_dict,
    vit_state_dict,
)
from dinomc_tpu_torch.models.dino_head import DINOHead
from dinomc_tpu_torch.models.resnet import ResNet
from dinomc_tpu_torch.models.siamese import Siamese
from dinomc_tpu_torch.models.swin import SwinTransformer
from dinomc_tpu_torch.models.upernet import UPerNet
from dinomc_tpu_torch.models.vit import VisionTransformer
from dinomc_tpu_torch.models.xcit import XCiT
from dinomc_tpu_torch.train.cls_trainer import ClsTrainState
from dinomc_tpu_torch.train.dino_trainer import DinoTrainState
from dinomc_tpu_torch.train.oscd_trainer import OSCDTrainState
from dinomc_tpu_torch.train.seg_trainer import SegTrainState


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)) for k, v in sd.items()}


def head_state_dict(params: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A DINO-head tree -> the reference ``DINOHead`` state dict. With
    BatchNorm (``bn_scale``/``bn_bias`` in the hidden layers), dense layer j
    sits at ``mlp.{3j}`` and its BatchNorm at ``mlp.{3j+1}`` (Linear, BN,
    GELU); without, the exporter's ``mlp.{2j}``."""
    n = sum(1 for k in params if k.startswith("mlp_"))
    if not any("bn_scale" in params[f"mlp_{j}"] for j in range(n)):
        return dino_head_state_dict(params, prefix)
    sd: Dict[str, np.ndarray] = {}
    for j in range(n):
        layer = params[f"mlp_{j}"]
        sd[f"{prefix}mlp.{3 * j}.weight"] = np.asarray(layer["kernel"], np.float32).T.copy()
        sd[f"{prefix}mlp.{3 * j}.bias"] = np.asarray(layer["bias"], np.float32)
        if "bn_scale" in layer:
            sd[f"{prefix}mlp.{3 * j + 1}.weight"] = np.asarray(layer["bn_scale"], np.float32)
            sd[f"{prefix}mlp.{3 * j + 1}.bias"] = np.asarray(layer["bn_bias"], np.float32)
    last = {k: v for k, v in params.items() if not k.startswith("mlp_")}
    sd.update(dino_head_state_dict(last, prefix))
    return sd


def _linear(sd, name, p) -> None:
    sd[name + ".weight"] = np.asarray(p["kernel"], np.float32).T.copy()
    sd[name + ".bias"] = np.asarray(p["bias"], np.float32)


def _conv(sd, name, kernel, bias) -> None:
    """HWIO -> (out, in, kh, kw)."""
    sd[name + ".weight"] = np.asarray(kernel, np.float32).transpose(3, 2, 0, 1).copy()
    sd[name + ".bias"] = np.asarray(bias, np.float32)


def _affine(sd, name, p) -> None:
    """A LayerNorm's or BatchNorm's ``scale`` and ``bias``."""
    sd[name + ".weight"] = np.asarray(p["scale"], np.float32)
    sd[name + ".bias"] = np.asarray(p["bias"], np.float32)


def siamese_state_dict(params: Dict[str, Any], bn_state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``init_siamese`` pair -> the port's ``Siamese`` state dict:
    ``encoder.*`` in torchvision's names, ``lateral.{i}``, ``smooth`` and
    ``classifier`` as (out, in, k, k) weights and biases."""
    sd = resnet_state_dict(params["encoder"], bn_state["encoder"], "encoder.")
    convs = {f"lateral.{i}": p for i, p in enumerate(params["lateral"])}
    convs.update(smooth=params["smooth"], classifier=params["classifier"])
    for name, p in convs.items():
        _conv(sd, name, p["kernel"], p["bias"])
    return sd


def xcit_state_dict(params: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX ``init_xcit`` tree -> the port's ``XCiT`` state dict: the JAX
    names, the blocks' leaves unstacked along their leading layer axis,
    Linear kernels (in, out) -> (out, in), conv kernels HWIO -> OIHW."""
    sd: Dict[str, np.ndarray] = {}
    for i, p in enumerate(params["stem"]):
        _conv(sd, f"{prefix}stem.{i}", p["kernel"], p["bias"])
    _linear(sd, prefix + "pos_proj", params["pos_proj"])
    sd[prefix + "cls_token"] = np.asarray(params["cls_token"], np.float32)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    blocks = {k: {kk: f32(vv) for kk, vv in v.items()} if isinstance(v, dict) else f32(v)
              for k, v in params["blocks"].items()}
    for l in range(blocks["temp"].shape[0]):
        pre = f"{prefix}blocks.{l}."
        row = {k: {kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l]
               for k, v in blocks.items()}
        for name in ("norm1", "norm3", "norm2", "lpi_bn"):
            _affine(sd, pre + name, row[name])
        for name in ("qkv", "proj", "fc1", "fc2"):
            _linear(sd, pre + name, row[name])
        for name in ("lpi_conv1", "lpi_conv2"):
            _conv(sd, pre + name, row[name]["kernel"], row[name]["bias"])
        for name in ("temp", "gamma1", "gamma3", "gamma2"):
            sd[pre + name] = row[name].copy()
    for i, cb in enumerate(params["cls_blocks"]):
        pre = f"{prefix}cls_blocks.{i}."
        for name in ("norm1", "norm2"):
            _affine(sd, pre + name, cb[name])
        for name in ("qkv", "proj", "fc1", "fc2"):
            _linear(sd, pre + name, cb[name])
        for name in ("gamma1", "gamma2"):
            sd[pre + name] = np.asarray(cb[name], np.float32)
    _affine(sd, prefix + "norm", params["norm"])
    return sd


def _resnet(pair, prefix: str = "") -> Dict[str, np.ndarray]:
    return resnet_state_dict(*pair, prefix)


def state_dict_from_jax(module: nn.Module, params: Any) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``module`` built from the matching JAX tree:
    a ViT, Swin or XCiT tree, a ResNet's, a UPerNet's or a Siamese's
    ``(params, bn_state)`` pair, a DINO-head tree, a ``{'backbone', 'head'}``
    tree, or a classifier's ``{'backbone', 'fc'}`` tree (a ResNet backbone as
    a pair)."""
    backbones = {VisionTransformer: vit_state_dict, SwinTransformer: swin_state_dict,
                 ResNet: _resnet, XCiT: xcit_state_dict}
    if isinstance(module, UPerNet):
        return _tensors(upernet_state_dict(*params))
    if isinstance(module, Siamese):
        return _tensors(siamese_state_dict(*params))
    if type(module) in backbones:
        return _tensors(backbones[type(module)](params))
    if isinstance(module, DINOHead):
        return _tensors(head_state_dict(params))
    if isinstance(module, nn.ModuleDict) and set(module.keys()) == {"backbone", "head"}:
        sd = backbones[type(module["backbone"])](params["backbone"], "backbone.")
        sd.update(head_state_dict(params["head"], "head."))
        return _tensors(sd)
    if isinstance(module, nn.ModuleDict) and set(module.keys()) == {"backbone", "fc"}:
        sd = backbones[type(module["backbone"])](params["backbone"], "backbone.")
        sd.update({f"fc.{k}": np.asarray(v) for k, v in params["fc"].items()})
        return _tensors(sd)
    raise TypeError(f"no JAX parameter mapping for {type(module).__name__}")


@torch.no_grad()
def _zero_opt_state(opt_state: dict) -> None:
    """A freshly initialized optimizer state, whichever optimizer made it."""
    for kind, entries in opt_state.items():
        for name in entries:
            if kind == "count":
                entries[name] = 0
            else:
                entries[name].zero_()


def _paired(model: nn.ModuleDict, params: Dict[str, Any], bn_state) -> Dict[str, Any]:
    """``params`` with a ResNet backbone's tree paired with its BatchNorm
    state, as ``state_dict_from_jax`` takes it."""
    if isinstance(model["backbone"], ResNet):
        return {**params, "backbone": (params["backbone"], bn_state)}
    return params


@torch.no_grad()
def load_jax_params(module_or_state, jax_params) -> None:
    """Copy JAX parameters into a port module or train state, in place.

    For a ``DinoTrainState``, ``jax_params`` is a JAX ``DinoTrainState`` (or
    any object with ``student``, ``teacher``, ``center`` and ``step``, and
    for a convnet ``student_state`` and ``teacher_state``): student,
    teacher, their BatchNorm statistics, centre and step are copied and the
    optimizer state starts from zero, as the JAX package's freshly
    initialized state has them. For a ``SegTrainState``, ``jax_params`` is a
    JAX ``SegTrainState``: parameters, BatchNorm statistics and step are
    copied, the AdamW state starts from zero. For a ``ClsTrainState``, a JAX
    ``ClsTrainState``: backbone (with its BatchNorm statistics), classifier
    and step are copied, the optimizer state starts from zero. For an
    ``OSCDTrainState``, a JAX ``OSCDTrainState``: the same."""
    if isinstance(module_or_state, (SegTrainState, OSCDTrainState)):
        st = module_or_state
        load_jax_params(st.model, (jax_params.params, jax_params.bn_state))
        st.step = int(np.asarray(jax_params.step))
        _zero_opt_state(st.opt_state)
        return
    if isinstance(module_or_state, ClsTrainState):
        st = module_or_state
        load_jax_params(st.model, _paired(st.model, jax_params.params, jax_params.bn_state))
        st.step = int(np.asarray(jax_params.step))
        _zero_opt_state(st.opt_state)
        return
    if isinstance(module_or_state, DinoTrainState):
        st = module_or_state
        load_jax_params(st.student, _paired(st.student, jax_params.student,
                                            getattr(jax_params, "student_state", {})))
        load_jax_params(st.teacher, _paired(st.teacher, jax_params.teacher,
                                            getattr(jax_params, "teacher_state", {})))
        st.center = torch.from_numpy(np.array(jax_params.center, np.float32)).to(st.center.device)
        st.step = int(np.asarray(jax_params.step))
        _zero_opt_state(st.opt_state)
        return
    module = module_or_state
    module.load_state_dict(state_dict_from_jax(module, jax_params), strict=True)
