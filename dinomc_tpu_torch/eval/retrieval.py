"""Retrieval and feature-space utilities.

Counterpart of ``dinomc_tpu/eval/retrieval.py`` (DINO leftovers the
reference carries, ``utils/utils.py:519-856``): ``PCA`` with optional
whitening, the revisited-Oxford ``compute_ap`` / ``compute_map`` with junk
handling (numpy, copied from the JAX package and held to it by
``tests/test_torch_copies.py``), and ``multi_scale`` feature averaging on
torch tensors, its resizes those of ``jax.image.resize(..., "bilinear")``
(antialiased when downsampling, ``ops/augment.resize``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dinomc_tpu_torch.eval.knn import l2_normalize
from dinomc_tpu_torch.ops.augment import resize


class PCA:
    """PCA with optional whitening, fitted on (N, D) features."""

    def __init__(self, dim: int = 256, whit: Optional[float] = 0.5):
        self.dim = dim
        self.whit = whit
        self.mean: Optional[np.ndarray] = None
        self.proj: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray) -> "PCA":
        X = np.asarray(X, np.float64)
        self.mean = X.mean(axis=0)
        Xc = X - self.mean
        cov = Xc.T @ Xc / max(len(X) - 1, 1)
        eigval, eigvec = np.linalg.eigh(cov)
        order = np.argsort(eigval)[::-1][: self.dim]
        eigval = np.maximum(eigval[order], 1e-12)
        eigvec = eigvec[:, order]
        if self.whit is not None:
            eigvec = eigvec / (eigval**self.whit)
        self.proj = eigvec
        return self

    def apply(self, X: np.ndarray) -> np.ndarray:
        assert self.proj is not None, "fit first"
        return (np.asarray(X, np.float64) - self.mean) @ self.proj


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """AP given 0-based ranks of positive results and #positives
    (reference ``compute_ap`` trapezoid formulation)."""
    if nres == 0:
        return 0.0
    ap = 0.0
    recall_step = 1.0 / nres
    for j, rank in enumerate(np.sort(ranks)):
        precision_0 = j / rank if rank > 0 else 1.0
        precision_1 = (j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(
    ranks: np.ndarray,  # (n_db, n_queries) ranked db indices per query
    gnd: List[Dict],  # per-query {'ok': array, 'junk': array}
    kappas: Sequence[int] = (),
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
    """Mean AP + per-query APs + precision@k (reference ``compute_map``)."""
    nq = len(gnd)
    aps = np.zeros(nq)
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    for i in range(nq):
        ok = np.asarray(gnd[i].get("ok", []))
        if ok.size == 0:
            aps[i] = np.nan
            prs[i] = np.nan
            nempty += 1
            continue
        junk = np.asarray(gnd[i].get("junk", []))
        pos = np.isin(ranks[:, i], ok)
        junk_mask = np.isin(ranks[:, i], junk)
        # ranks of positives after removing junk entries above them
        pos_idx = np.where(pos)[0]
        shift = np.cumsum(junk_mask)[pos_idx]
        adjusted = pos_idx - shift
        aps[i] = compute_ap(adjusted, len(ok))
        for k, kappa in enumerate(kappas):
            prs[i, k] = (adjusted < kappa).sum() / min(kappa, len(ok))
    valid = max(nq - nempty, 1)
    mean_ap = float(np.nansum(aps) / valid)
    mean_prs = np.nansum(prs, axis=0) / valid
    return mean_ap, aps, mean_prs, prs


def multi_scale(
    image: torch.Tensor,  # (B, H, W, 3)
    forward: Callable[[torch.Tensor], torch.Tensor],  # images -> (B, D)
    scales: Sequence[float] = (1.0, 1.0 / 2 ** 0.5, 1.0 / 2),
) -> torch.Tensor:
    """L2-normalized average of features over image scales (reference
    ``multi_scale``, ``utils/utils.py:832-846``); each side is rounded to a
    multiple of 32."""
    B, H, W, C = image.shape
    acc = None
    for s in scales:
        if s == 1.0:
            inp = image
        else:
            h = int(round(H * s / 32) * 32) or 32
            w = int(round(W * s / 32) * 32) or 32
            inp = resize(image, (h, w), "bilinear")
        f = l2_normalize(forward(inp))
        acc = f if acc is None else acc + f
    return l2_normalize(acc / len(scales))
