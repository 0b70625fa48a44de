"""Weighted k-NN evaluation on frozen features (DINO protocol).

Counterpart of ``dinomc_tpu/eval/knn.py``; the protocol is upstream DINO's
``eval_knn``: cosine-similarity top-k neighbours over the training
features, class votes weighted by exp(sim / T) with T = 0.07. Computed in
f32 on the features' device, one similarity product for the whole test set.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (norms below 1e-12 count as 1e-12)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def knn_predict(
    train_feats: torch.Tensor,  # (N, D)
    train_labels: torch.Tensor,  # (N,)
    test_feats: torch.Tensor,  # (M, D)
    k: int = 20,
    num_classes: int = 10,
    temperature: float = 0.07,
) -> torch.Tensor:
    """Predicted labels (M,) by temperature-weighted cosine k-NN voting.

    ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk`` promises
    no order among equal values. Neighbours with exactly equal similarity
    may therefore come in another order than in the JAX package, which
    changes a vote only when such a tie straddles the k-th place."""
    train_feats = torch.as_tensor(train_feats).float()
    dev = train_feats.device
    test_feats = torch.as_tensor(test_feats).to(dev).float()
    train_labels = torch.as_tensor(train_labels).to(dev).long()
    sims = l2_normalize(test_feats) @ l2_normalize(train_feats).T  # (M, N)
    topv, topi = torch.topk(sims, k, dim=1, sorted=True)
    weights = torch.exp(topv / temperature)
    # a one-hot sum, not scatter_add_: CUDA's atomics would add in any order
    one_hot = F.one_hot(train_labels[topi], num_classes).float()  # (M, k, C)
    return (one_hot * weights[..., None]).sum(dim=1).argmax(-1)


def knn_accuracy(
    train_feats,
    train_labels,
    test_feats,
    test_labels,
    ks: Sequence[int] = (10, 20),
    num_classes: int = 10,
    temperature: float = 0.07,
) -> Dict[int, float]:
    """Top-1 accuracy (percent) per k."""
    out = {}
    for k in ks:
        pred = knn_predict(train_feats, train_labels, test_feats, k=k,
                           num_classes=num_classes, temperature=temperature)
        correct = pred == torch.as_tensor(test_labels).to(pred.device)
        out[k] = float(correct.float().mean() * 100.0)
    return out


@torch.no_grad()
def extract_features(
    apply_fn: Callable[[object], torch.Tensor], batches: Iterable,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``apply_fn(images) -> (B, D)`` over (images, labels) batches with
    autograd off; returns the stacked (features, labels), both on the
    features' device."""
    feats, labels = [], []
    for images, y in batches:
        f = apply_fn(images)
        feats.append(f)
        labels.append(torch.as_tensor(y).to(f.device))
    return torch.cat(feats), torch.cat(labels)
