"""Load reference PyTorch checkpoints into the port's modules.

The reference's ``load_pretrained_weights`` (``utils/utils.py:75-119``)
picks a checkpoint key (``'teacher'`` in DINO-MC checkpoints; none in
Facebook DINO/DeiT files) and strips the ``module.`` and ``backbone.``
prefixes; the JAX package's ``ckpt/torch_import.load_torch_state_dict`` does
the same. The port's modules already carry the reference's names, so the
result loads directly, with no JAX tree in between.

A torchvision-layout ResNet ``.pth`` loads through ``load_backbone`` with
its BatchNorm running statistics, the port's ResNet carrying torchvision's
names. A fine-tuned classifier (``main_eurosat.py:144-154``) is a
full-model ``state_dict`` with the classifier at ``head.weight`` /
``head.bias`` for ViT and Swin and at ``fc.weight`` / ``fc.bias`` on the
torchvision convnets: ``load_cls_checkpoint`` reads one into the port's
``{'backbone', 'fc'}`` module, whose ``fc.kernel`` is that weight
transposed, and ``save_cls_checkpoint`` writes one, BatchNorm buffers
included; ``classifier_name`` decides the name for both. A reference
segmentation checkpoint (``train_dino_mc_seg.py:190-197``: mmseg
``UPerNetDinoMC`` names under ``model_state_dict``) loads into the port's
``UPerNet``, which carries those names: ``read_upernet_state_dict`` reads
the file once, ``upernet_widths`` takes the decoder widths it was trained
with from that dict and ``load_upernet_checkpoint`` loads it. A DINO-MC
checkpoint's head, with the running statistics of a BatchNorm-in-head that
the port's head (as the JAX one) has no place for, is never read:
``load_backbone`` takes the backbone's tensors alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from dinomc_tpu_torch.models.resnet import ResNet

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


def read_upernet_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference seg checkpoint -> flat {mmseg name: CPU tensor}: the
    ``model_state_dict`` or ``state_dict`` entry unwrapped, ``module.``
    removed from the names (the JAX package's ``load_upernet_checkpoint``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model_state_dict", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {k.replace("module.", ""): torch.as_tensor(v).detach().cpu() for k, v in ckpt.items()}


def upernet_widths(sd: Dict[str, torch.Tensor]) -> Dict:
    """The ``UPerNetConfig`` fields a reference seg checkpoint's state dict
    (``read_upernet_state_dict``) fixes: the decoder's and the auxiliary
    head's channels and whether it has the FPN neck (the JAX package takes
    its whole tree from the file, so it runs whatever widths the file
    holds)."""
    return {"channels": sd["decode_head.conv_seg.weight"].shape[1],
            "aux_channels": sd["auxiliary_head.conv_seg.weight"].shape[1],
            "use_fpn_neck": any(k.startswith("neck.") for k in sd)}


@torch.no_grad()
def load_upernet_checkpoint(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a reference seg checkpoint's state dict
    (``read_upernet_state_dict``) into the port's ``UPerNet`` with
    ``strict=True``; no renaming, the port's names are mmseg's."""
    model.load_state_dict(sd, strict=True)


def classifier_name(backbone: nn.Module) -> str:
    """Where a reference classification checkpoint keeps the classifier of
    a model on ``backbone``: ``fc`` on the torchvision convnets, ``head``
    on ViT and Swin."""
    return "fc" if isinstance(backbone, ResNet) else "head"


def cls_params_from_torch(sd: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """A reference fine-tuned classifier's state dict (prefixes stripped),
    its classifier at ``name`` (``classifier_name``) -> the port's
    ``{'backbone', 'fc'}`` state dict."""
    out = {f"backbone.{k}": v for k, v in sd.items() if not k.startswith(name + ".")}
    out["fc.kernel"] = sd[name + ".weight"].T.contiguous()
    out["fc.bias"] = sd[name + ".bias"]
    return out


@torch.no_grad()
def load_cls_checkpoint(model: nn.Module, path: str) -> None:
    """Load a reference fine-tuned classification checkpoint
    (``{'state_dict': full model, ...}``) into ``model`` with
    ``strict=True``."""
    sd = cls_params_from_torch(load_torch_state_dict(path, checkpoint_key="state_dict"),
                               classifier_name(model["backbone"]))
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)


def save_cls_checkpoint(path: str, model: nn.Module, epoch: int = 0,
                        best_acc: Optional[float] = None) -> str:
    """Write ``model`` (``{'backbone', 'fc'}``) in the reference's
    classification layout: ``{'epoch', 'state_dict', 'best_acc'}``, the
    classifier at ``head.weight`` (C, D) and ``head.bias``, or at ``fc.*``
    for a ResNet, whose BatchNorm buffers are in the state dict."""
    from dinomc_tpu_torch.ckpt.torch_export import write_cls

    name = classifier_name(model["backbone"])
    sd = {k[len("backbone."):]: v.detach().cpu()
          for k, v in model.state_dict().items() if k.startswith("backbone.")}
    sd[name + ".weight"] = model.state_dict()["fc.kernel"].detach().cpu().T.contiguous()
    sd[name + ".bias"] = model.state_dict()["fc.bias"].detach().cpu()
    return write_cls(path, sd, epoch, best_acc)
