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
included; ``classifier_name`` decides the name for both. A DINO-MC
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
    name = classifier_name(model["backbone"])
    sd = {k[len("backbone."):]: v.detach().cpu()
          for k, v in model.state_dict().items() if k.startswith("backbone.")}
    sd[name + ".weight"] = model.state_dict()["fc.kernel"].detach().cpu().T.contiguous()
    sd[name + ".bias"] = model.state_dict()["fc.bias"].detach().cpu()
    save = {"epoch": int(epoch), "state_dict": sd}
    if best_acc is not None:
        save["best_acc"] = float(best_acc)
    torch.save(save, path)
    return path
