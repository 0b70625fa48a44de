"""Serialized inference programs (the serving artifact).

Counterpart of ``dinomc_tpu/ckpt/export.py``, where ``jax.export`` writes a
jitted inference function with its weights baked in as StableHLO. Here
``torch.export.export`` traces the function at the example shapes (static,
as in JAX) into an ATen graph, ``torch.export.save`` writes it with the
weights inside, and ``load_exported`` gives back a callable module that
needs no model code. The trace runs under ``_build.route_ops()``, so each
hand-written forward kernel the function reaches is one ``dinomc_torch::``
op in the graph (``ops/hopper/custom_ops.py``): on a card the loaded
program launches the kernels; on the CPU those ops run the plain versions.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch
import torch.nn as nn

from dinomc_tpu_torch.ops.hopper import _build


class _Fn(nn.Module):
    """A function as a module; tensors it closes over become the program's
    constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _SegPredict(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        from dinomc_tpu_torch.train.seg_trainer import seg_predict

        return seg_predict(self.model, images)


class _ClsPredict(nn.Module):
    def __init__(self, model: nn.Module, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, images):
        from dinomc_tpu_torch.train.cls_trainer import cls_predict

        return cls_predict(self.model, images, self.cfg)


def _clear_device_caches() -> None:
    """Empty the models' caches of device tensors (resize matrices, Swin's
    window masks, XCiT's position features)."""
    from dinomc_tpu_torch.models import layers, swin, xcit

    for cached in (layers._resize_matrix, swin._attn_mask, xcit._pos_features):
        cached.cache_clear()


def export_fn(fn: Callable, example_args: Sequence, path: str) -> int:
    """Export ``fn`` (a module or a function) at the example arguments'
    shapes and save it to ``path``; returns the file's size in bytes.

    One eager call first fills the models' caches of device tensors, so the
    trace finds them and the program keeps them as device constants (a
    tensor the trace built would be uploaded at every call). The caches are
    emptied after the trace: one it had to fill holds a fake tensor."""
    from dinomc_tpu_torch.ops.hopper import custom_ops  # noqa: F401 (registers the ops)

    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    try:
        with torch.no_grad():
            module(*example_args)
            with _build.route_ops():
                # non-strict: the Python of the forward runs as it is, on fake tensors
                program = torch.export.export(module, tuple(example_args), strict=False)
    finally:
        _clear_device_caches()
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_exported(path: str) -> Callable:
    """Load a saved program; returns a callable module."""
    from dinomc_tpu_torch.ops.hopper import custom_ops  # noqa: F401 (the ops it names)

    return torch.export.load(path).module()


def _example(model: nn.Module, image_size: int, batch: int) -> tuple:
    dev = next(model.parameters()).device
    return (torch.zeros(batch, image_size, image_size, 3, device=dev),)


def export_seg_model(model: nn.Module, path: str, image_size: int = 224,
                     batch: int = 1) -> int:
    """An eval-mode segmentation predictor (``seg_predict``): (B, S, S, 3)
    normalized images -> (B, S, S, C) logits."""
    return export_fn(_SegPredict(model), _example(model, image_size, batch), path)


def export_classifier(model: nn.Module, cfg, path: str, image_size: int = 224,
                      batch: int = 1) -> int:
    """An eval-mode classifier (``cls_predict`` of a ``{'backbone', 'fc'}``
    module under ``ClsConfig`` ``cfg``): (B, S, S, 3) -> (B, C) logits."""
    return export_fn(_ClsPredict(model, cfg), _example(model, image_size, batch), path)
