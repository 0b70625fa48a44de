"""Segmentation and classification metrics.

Counterpart of ``dinomc_tpu/eval/metrics.py``: the fast-hist confusion
matrix and ``cm2score`` (reference ``utils/metric_tool.py:96-203``), the
streaming per-class intersection / union / correct accumulators of the
per-epoch validation (``evaluate.py:30-54``), the console table, and the
classification metrics: top-k accuracy (``utils/utils.py:519-526``), the
micro mAP of BigEarthNet (``main_bigearthnet.py:223-225``) and the streaming
``ConfuseMatrixMeter`` (``utils/metric_tool.py:49-64``). The confusion
matrix and accumulators stay on the tensors' device; ``seg_stats_finalize``
reads them back once.
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


# ---------------------------------------------------------------------------
# classification metrics
# ---------------------------------------------------------------------------


def topk_accuracy(
    logits: torch.Tensor, target: torch.Tensor, topk: Sequence[int] = (1,)
) -> Dict[int, torch.Tensor]:
    """Top-k accuracy in percent, a device scalar per k (reference
    ``utils/utils.py:519-526``)."""
    _, pred = torch.topk(logits, max(topk), dim=1, sorted=True)  # (B, maxk)
    correct = pred == target.reshape(-1, 1)
    return {k: 100.0 * correct[:, :k].any(dim=1).float().mean() for k in topk}


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """AP for one ranking (binary labels), sklearn-style step integration."""
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tp = np.cumsum(labels)
    n_pos = labels.sum()
    if n_pos == 0:
        return 0.0
    precision = tp / np.arange(1, len(labels) + 1)
    return float((precision * labels).sum() / n_pos)


def micro_map(scores: np.ndarray, labels: np.ndarray) -> float:
    """Micro-averaged mAP over a multi-label batch: every (sample, class)
    decision in one ranking, as ``sklearn.average_precision_score(average=
    'micro')`` (``main_bigearthnet.py:223-225``)."""
    return average_precision(np.asarray(scores).reshape(-1), np.asarray(labels).reshape(-1))


class ConfuseMatrixMeter:
    """Streaming (weighted) confusion-matrix meter (reference
    ``utils/metric_tool.py:49-64``): a running weighted sum of per-batch
    confusion matrices on the host; ``update_cm`` returns the current
    batch's mean F1 and ``get_scores`` scores the accumulated matrix."""

    def __init__(self, n_class: int):
        self.n_class = n_class
        self.clear()

    def update_cm(self, pr, gt, weight: float = 1.0) -> float:
        cm = confusion_matrix(torch.as_tensor(pr), torch.as_tensor(gt), self.n_class).int()
        self.sum += weight * cm.cpu().numpy()
        self.count += weight
        return float(cm2score(cm)["mf1"])

    def get_scores(self) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in cm2score(torch.from_numpy(self.sum)).items()}

    def clear(self) -> None:
        self.sum = np.zeros((self.n_class, self.n_class), np.float64)
        self.count = 0.0
