"""JAX-package parameter trees -> the reference's PyTorch state-dict layout.

The port's own copies, numpy only, of the exporters in
``dinomc_tpu/ckpt/torch_export.py`` (``vit_state_dict``,
``dino_head_state_dict``, ``swin_state_dict``, ``resnet_state_dict``,
``upernet_state_dict``): they
map a tree of the JAX package (numpy arrays, or anything ``np.asarray``
reads) to timm/DINO, torchvision and mmseg names, which the port's modules
carry. ``tests/test_torch_copies.py`` holds each to its original, key
for key and value for value.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _patch_conv(kernel) -> np.ndarray:
    """A patchify-matmul kernel (p*p*3, D), (ph, pw, c) inner order -> the
    conv weight (D, 3, p, p)."""
    kernel = _np(kernel)
    d = kernel.shape[1]
    p = int(round((kernel.shape[0] // 3) ** 0.5))
    assert p * p * 3 == kernel.shape[0], f"non-RGB patch kernel {kernel.shape}"
    return kernel.reshape(p, p, 3, d).transpose(3, 2, 0, 1).copy()


def _ln(sd: StateDict, p, key: str) -> None:
    sd[key + ".weight"] = _np(p["scale"])
    sd[key + ".bias"] = _np(p["bias"])


def _lin(sd: StateDict, p, key: str) -> None:
    """(in, out) kernel -> torch's (out, in) weight, and the bias if any."""
    sd[key + ".weight"] = _np(p["kernel"]).T.copy()
    if "bias" in p:
        sd[key + ".bias"] = _np(p["bias"])


def vit_state_dict(params: Dict[str, Any], prefix: str = "") -> StateDict:
    """A stacked-block ViT tree -> the timm/DINO state dict: the leading
    layer axis unstacks into ``blocks.{i}.*``."""
    sd: StateDict = {}
    sd[prefix + "patch_embed.proj.weight"] = _patch_conv(params["patch_embed"]["kernel"])
    sd[prefix + "patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    sd[prefix + "cls_token"] = _np(params["cls_token"])
    sd[prefix + "pos_embed"] = _np(params["pos_embed"])
    blocks = params["blocks"]
    for i in range(_np(blocks["norm1"]["scale"]).shape[0]):
        pre = f"{prefix}blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[pre + ln + ".weight"] = _np(blocks[ln]["scale"][i])
            sd[pre + ln + ".bias"] = _np(blocks[ln]["bias"][i])
        for ours, theirs in ((blocks["attn"]["qkv"], "attn.qkv"), (blocks["attn"]["proj"], "attn.proj"),
                             (blocks["mlp"]["fc1"], "mlp.fc1"), (blocks["mlp"]["fc2"], "mlp.fc2")):
            sd[pre + theirs + ".weight"] = _np(ours["kernel"][i]).T.copy()
            sd[pre + theirs + ".bias"] = _np(ours["bias"][i])
    _ln(sd, params["norm"], prefix + "norm")
    return sd


def dino_head_state_dict(params: Dict[str, Any], prefix: str = "") -> StateDict:
    """A DINO-head tree -> the reference ``DINOHead`` state dict: dense layer
    j at ``mlp.{2j}`` (Sequential with GELUs between), the weight-normed last
    layer as ``weight_g`` (out, 1) and ``weight_v`` (out, in)."""
    sd: StateDict = {}
    n = sum(1 for k in params if k.startswith("mlp_"))
    assert not any("bn_scale" in params[f"mlp_{j}"] for j in range(n)), (
        "BN-in-head trees have no reference layout here (use_bn_in_head=False)")
    for j in range(n):
        _lin(sd, params[f"mlp_{j}"], f"{prefix}mlp.{2 * j}")
    sd[prefix + "last_layer.weight_g"] = _np(params["last_layer"]["g"]).reshape(-1, 1)
    sd[prefix + "last_layer.weight_v"] = _np(params["last_layer"]["v"]).T.copy()
    return sd


def swin_state_dict(params: Dict[str, Any], prefix: str = "") -> StateDict:
    """A Swin-T tree -> torchvision ``swin_t`` names. The
    ``relative_position_index`` buffers are derived, and not emitted."""
    sd: StateDict = {}
    pe = params["patch_embed"]
    sd[prefix + "features.0.0.weight"] = _patch_conv(pe["kernel"])
    sd[prefix + "features.0.0.bias"] = _np(pe["bias"])
    _ln(sd, pe["norm"], prefix + "features.0.2")
    for s, stage in enumerate(params["stages"]):
        for b, blk in enumerate(stage["blocks"]):
            pre = f"{prefix}features.{2 * s + 1}.{b}"
            _ln(sd, blk["norm1"], pre + ".norm1")
            _lin(sd, blk["qkv"], pre + ".attn.qkv")
            _lin(sd, blk["proj"], pre + ".attn.proj")
            sd[pre + ".attn.relative_position_bias_table"] = _np(blk["rel_bias"])
            _ln(sd, blk["norm2"], pre + ".norm2")
            _lin(sd, blk["fc1"], pre + ".mlp.0")
            _lin(sd, blk["fc2"], pre + ".mlp.3")
        if "merge" in stage:
            mpre = f"{prefix}features.{2 * s + 2}"
            _ln(sd, stage["merge"]["norm"], mpre + ".norm")
            _lin(sd, stage["merge"]["reduce"], mpre + ".reduction")
    _ln(sd, params["norm"], prefix + "norm")
    return sd


def _conv_bn(sd: StateDict, p, s, conv_key: str, bn_key: str) -> None:
    sd[conv_key + ".weight"] = _np(p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()
    sd[bn_key + ".weight"] = _np(p["bn"]["scale"])
    sd[bn_key + ".bias"] = _np(p["bn"]["bias"])
    sd[bn_key + ".running_mean"] = _np(s["bn"]["mean"])
    sd[bn_key + ".running_var"] = _np(s["bn"]["var"])
    sd[bn_key + ".num_batches_tracked"] = np.zeros((), np.int64)


def resnet_state_dict(params: Dict[str, Any], state: Dict[str, Any], prefix: str = "") -> StateDict:
    """A ResNet-50 / WRN (params, BatchNorm state) pair -> torchvision names:
    HWIO kernels become OIHW weights, the running statistics buffers."""
    sd: StateDict = {}
    _conv_bn(sd, params["stem"], state["stem"], prefix + "conv1", prefix + "bn1")
    for stage in range(1, 5):
        name = f"layer{stage}"
        for b, (bp, bs) in enumerate(zip(params[name], state[name])):
            pre = f"{prefix}{name}.{b}"
            for i in (1, 2, 3):
                _conv_bn(sd, bp[f"conv{i}"], bs[f"conv{i}"], f"{pre}.conv{i}", f"{pre}.bn{i}")
            if "down" in bp:
                _conv_bn(sd, bp["down"], bs["down"], f"{pre}.downsample.0", f"{pre}.downsample.1")
    if "fc" in params:
        _lin(sd, params["fc"], prefix + "fc")
    return sd


def upernet_state_dict(params: Dict[str, Any], state: Dict[str, Any]) -> StateDict:
    """A UPerNet (params, bn_state) pair -> mmseg ``UPerNetDinoMC`` names."""
    sd: StateDict = vit_state_dict(params["backbone"], "backbone.vit.")

    def cbr(prefix, p, s):
        _conv_bn(sd, p, s, prefix + ".conv", prefix + ".bn")

    def conv(prefix, p):
        sd[prefix + ".weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1).copy()
        if "bias" in p:
            sd[prefix + ".bias"] = _np(p["bias"])

    if "neck" in params:
        for i, p in enumerate(params["neck"]):
            conv(f"neck.lateral_convs.{i}.conv", p["lateral"])
            conv(f"neck.fpn_convs.{i}.conv", p["out"])
    for i, (p, s) in enumerate(zip(params["psp"], state["psp"])):
        cbr(f"decode_head.psp_modules.{i}.1", p, s)
    cbr("decode_head.bottleneck", params["psp_bottleneck"], state["psp_bottleneck"])
    for i, (p, s) in enumerate(zip(params["lateral"], state["lateral"])):
        cbr(f"decode_head.lateral_convs.{i}", p, s)
    for i, (p, s) in enumerate(zip(params["fpn"], state["fpn"])):
        cbr(f"decode_head.fpn_convs.{i}", p, s)
    cbr("decode_head.fpn_bottleneck", params["fusion"], state["fusion"])
    conv("decode_head.conv_seg", params["classifier"])
    cbr("auxiliary_head.convs.0", params["aux"]["conv"], state["aux"]["conv"])
    conv("auxiliary_head.conv_seg", params["aux"]["classifier"])
    return sd
