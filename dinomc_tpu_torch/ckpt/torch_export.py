"""Write the port's modules as reference-format PyTorch checkpoints.

Counterpart of the writers in ``dinomc_tpu/ckpt/torch_export.py``
(``cls_state_dict``, ``export_cls_checkpoint``, ``export_seg_checkpoint``,
``backbone_state_dict_for_arch``, ``export_dino_checkpoint``,
``export_backbone``). Their inputs there are JAX trees; here they are the
port's own module state dicts (what ``ckpt/checkpoint.CheckpointManager``
saves), whose names are already the reference's (timm/DINO, torchvision,
mmseg). So a writer picks keys, adds prefixes, writes the reference's file
layout and refuses what the JAX writer refuses:

- DINO (``main_dino_mc.py:333-343``): ``student`` under DDP's ``module.``
  prefix, ``teacher`` bare, ``epoch`` and ``dino_loss.center`` (1, out_dim);
  a DINO head with BatchNorm has no reference layout in the JAX writer and
  is refused.
- seg (``train_dino_mc_seg.py:190-197``): ``{'epoch', 'model_state_dict'}``.
- cls (``main_eurosat.py:144-154``): ``{'epoch', 'state_dict'}``, the
  classifier at ``fc`` for the torchvision convnets and ``head`` otherwise.
- backbone: ``{checkpoint_key: state dict}``, or the bare state dict.

Floating tensors are written as f32 CPU tensors, as the JAX writer writes
them. BatchNorm's ``num_batches_tracked`` is the port's own count; the JAX
package has no such counter and writes 0. XCiT is refused, as in the JAX
``backbone_state_dict_for_arch``: neither package has a reference layout
for it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

StateDict = Dict[str, torch.Tensor]
# a key every state dict of the arch family has, to refuse a wrong --arch
_MARKS = {"vit": "cls_token", "resnet": "conv1.weight", "swin": "features.0.0.weight"}


def _family(arch: str) -> str:
    if arch.startswith("vit") or arch.startswith("deit"):
        return "vit"
    if arch in ("resnet50", "wide_resnet50_2"):
        return "resnet"
    if arch in ("swin_t", "swin_tiny"):
        return "swin"
    raise ValueError(
        f"no torch exporter for arch '{arch}' (supported: vit*/deit*, "
        "resnet50, wide_resnet50_2, swin_t)"
    )


def _host(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """CPU copies, floating tensors as f32."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().clone()
            for k, v in sd.items()}


def strip_prefix(sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """The entries of ``sd`` under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def backbone_state_dict_for_arch(arch: str, sd: Mapping[str, torch.Tensor],
                                 prefix: str = "") -> StateDict:
    """A backbone module's state dict -> the reference's, each name under
    ``prefix``; refuses an arch with no reference layout and a state dict
    that is not of ``arch``'s family."""
    mark = _MARKS[_family(arch)]
    if mark not in sd:
        raise ValueError(f"the state dict is not a {arch} backbone (no '{mark}')")
    return {prefix + k: v for k, v in _host(sd).items()}


def cls_state_dict(arch: str, sd: Mapping[str, torch.Tensor]) -> StateDict:
    """A ``{'backbone', 'fc'}`` module's state dict (``fc.kernel`` (D, C),
    ``fc.bias``) -> the reference's full-model state dict, the classifier at
    ``fc`` on the torchvision convnets and at ``head`` on ViT and Swin."""
    out = backbone_state_dict_for_arch(arch, strip_prefix(sd, "backbone."))
    name = "fc" if _family(arch) == "resnet" else "head"
    out[name + ".weight"] = sd["fc.kernel"].detach().float().cpu().T.contiguous()
    out[name + ".bias"] = sd["fc.bias"].detach().float().cpu().clone()
    return out


def write_cls(path: str, sd: StateDict, epoch: int = 0, best_acc: Optional[float] = None) -> str:
    """``{'epoch', 'state_dict', 'best_acc'}`` with a full-model state dict."""
    save = {"epoch": int(epoch), "state_dict": sd}
    if best_acc is not None:
        save["best_acc"] = float(best_acc)
    torch.save(save, path)
    return path


def export_cls_checkpoint(path: str, arch: str, sd: Mapping[str, torch.Tensor],
                          epoch: int = 0, best_acc: Optional[float] = None) -> str:
    """A reference-format classification checkpoint (``main_eurosat.py``'s
    layout without the optimizer state)."""
    return write_cls(path, cls_state_dict(arch, sd), epoch, best_acc)


def export_seg_checkpoint(path: str, sd: Mapping[str, torch.Tensor], epoch: int = 0,
                          best_miou: Optional[float] = None) -> str:
    """A reference-format seg checkpoint from a ``UPerNet`` state dict (mmseg
    names already), without the optimizer state."""
    if "decode_head.conv_seg.weight" not in sd:
        raise ValueError("the state dict is not a UPerNet's (no 'decode_head.conv_seg.weight')")
    save = {"epoch": int(epoch), "model_state_dict": _host(sd)}
    if best_miou is not None:
        save["best_miou"] = float(best_miou)
    torch.save(save, path)
    return path


def _dino_side(arch: str, sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """One ``{'backbone', 'head'}`` tower -> ``{prefix}backbone.*`` and
    ``{prefix}head.*``."""
    head = strip_prefix(sd, "head.")
    if "mlp.1.weight" in head:  # a BatchNorm after the first linear layer
        raise ValueError(
            "BN-in-head exports are not supported: torch Sequential indices "
            "shift with BatchNorm modules (use_bn_in_head=False, the reference "
            "default, for exportable runs)")
    out = backbone_state_dict_for_arch(arch, strip_prefix(sd, "backbone."), prefix + "backbone.")
    out.update({f"{prefix}head.{k}": v for k, v in _host(head).items()})
    return out


def export_dino_checkpoint(path: str, arch: str, student: Mapping[str, torch.Tensor],
                           teacher: Mapping[str, torch.Tensor], epoch: int = 0,
                           center: Optional[torch.Tensor] = None) -> str:
    """A reference-format DINO pretraining checkpoint from the student's and
    the teacher's state dicts."""
    save = {
        "student": _dino_side(arch, student, "module."),
        "teacher": _dino_side(arch, teacher, ""),
        "epoch": int(epoch),
    }
    if center is not None:
        save["dino_loss"] = {"center": center.detach().float().cpu().reshape(1, -1).clone()}
    torch.save(save, path)
    return path


def export_backbone(path: str, arch: str, sd: Mapping[str, torch.Tensor],
                    checkpoint_key: Optional[str] = "teacher") -> str:
    """A minimal ``{checkpoint_key: backbone state dict}`` file (the bare
    state dict when ``checkpoint_key`` is empty), which every reference
    loader reads."""
    out = backbone_state_dict_for_arch(arch, sd)
    torch.save({checkpoint_key: out} if checkpoint_key else out, path)
    return path
