"""Segmentation metrics.

Counterpart of the segmentation part of ``dinomc_tpu/eval/metrics.py``:
the fast-hist confusion matrix and ``cm2score`` (reference
``utils/metric_tool.py:96-203``), the streaming per-class intersection /
union / correct accumulators of the per-epoch validation
(``evaluate.py:30-54``), and the console table. The confusion matrix and
accumulators stay on the tensors' device; ``seg_stats_finalize`` reads them
back once. Classification metrics wait for ROADMAP.md queue 1 #11.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """cm[t, p] = number of pixels with ground truth t predicted p; targets
    outside [0, num_classes) are ignored."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = (target >= 0) & (target < num_classes)
    idx = torch.where(valid, target * num_classes + pred, num_classes * num_classes)
    cm = torch.bincount(idx, minlength=num_classes * num_classes + 1)[:-1]
    return cm.reshape(num_classes, num_classes)


def cm2score(cm: torch.Tensor, eps: float = 1e-10) -> Dict[str, torch.Tensor]:
    """Overall accuracy, per-class precision / recall / F1 / IoU and their
    means over the classes that appear (union > 0). Rows are ground truth."""
    cm = cm.double() if cm.dtype == torch.int64 else cm.float()
    tp = cm.diagonal()
    sum_gt, sum_pred = cm.sum(dim=1), cm.sum(dim=0)
    acc = tp.sum() / cm.sum().clamp_min(eps)
    precision = tp / sum_pred.clamp_min(eps)
    recall = tp / sum_gt.clamp_min(eps)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(eps)
    union = sum_gt + sum_pred - tp
    iou = tp / union.clamp_min(eps)
    present = (union > 0).to(iou.dtype)
    n_present = present.sum().clamp_min(1.0)
    return {
        "acc": acc, "precision": precision, "recall": recall, "f1": f1, "iou": iou,
        "miou": (iou * present).sum() / n_present,
        "mf1": (f1 * present).sum() / n_present,
        "present": present,
    }


def seg_stats_init(num_classes: int, device=None) -> Dict[str, torch.Tensor]:
    z = torch.zeros(num_classes, dtype=torch.float32, device=device)
    return {"inter": z, "union": z.clone(), "correct": z.clone(),
            "total": torch.zeros((), dtype=torch.float32, device=device)}


def seg_stats_update(
    stats: Dict[str, torch.Tensor], pred: torch.Tensor, target: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Add a batch's per-class intersection, union and correct counts."""
    cm = confusion_matrix(pred, target, stats["inter"].shape[0]).float()
    tp = cm.diagonal()
    return {
        "inter": stats["inter"] + tp,
        "union": stats["union"] + cm.sum(dim=1) + cm.sum(dim=0) - tp,
        "correct": stats["correct"] + tp,
        "total": stats["total"] + cm.sum(),
    }


def seg_stats_finalize(stats: Dict[str, torch.Tensor], eps: float = 1e-10) -> Dict:
    """Per-class IoU / F1 and their means over the present classes, and
    pixel accuracy, as host numbers."""
    inter = stats["inter"].cpu().numpy()
    union = stats["union"].cpu().numpy()
    present = union > 0
    iou = inter / np.maximum(union, eps)
    f1 = 2 * inter / np.maximum(union + inter, eps)  # 2TP / (2TP + FP + FN)
    return {
        "iou": iou,
        "f1": f1,
        "miou": float(iou[present].mean()) if present.any() else 0.0,
        "mf1": float(f1[present].mean()) if present.any() else 0.0,
        "acc": float(stats["correct"].sum().item() / max(float(stats["total"].item()), eps)),
        "present": present,
    }


def format_class_metrics_table(class_names: Sequence[str], scores: Dict) -> str:
    """Console table (reference ``utils/metric_tool.py:265-282`` analog)."""
    lines = [f"{'class':<16}{'IoU':>8}{'F1':>8}"]
    iou, f1 = np.asarray(scores["iou"]), np.asarray(scores["f1"])
    for i, name in enumerate(class_names):
        lines.append(f"{name:<16}{iou[i]*100:>8.2f}{f1[i]*100:>8.2f}")
    lines.append(
        f"{'mean':<16}{scores['miou']*100:>8.2f}{scores['mf1']*100:>8.2f}"
        + (f"   acc {scores['acc']*100:.2f}" if "acc" in scores else "")
    )
    return "\n".join(lines)
