"""Linear probe on frozen features (DINO eval protocol).

Counterpart of ``dinomc_tpu/eval/linear_probe.py``; the protocol is upstream
DINO's ``eval_linear``: one linear classifier trained with SGD (momentum
0.9) on a cosine lr schedule over features of the frozen backbone. The
features are extracted once; the probe trains in f32 on their device. The
minibatch order comes from ``np.random.RandomState(seed)``, as in the JAX
package; the initial weights are a draw of their own (``probe_init``), so a
caller can pass the JAX package's initial ``w`` as ``init``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dinomc_tpu_torch.core.schedules import cosine_scheduler


def probe_init(generator: torch.Generator, D: int, C: int) -> torch.Tensor:
    """The probe's initial (D, C) weight: 0.01 * N(0, 1)."""
    return 0.01 * torch.randn(D, C, generator=generator, device=generator.device)


def train_linear_probe(
    train_feats,  # (N, D)
    train_labels,  # (N,)
    test_feats,
    test_labels,
    num_classes: int,
    epochs: int = 100,
    batch_size: int = 1024,
    base_lr: float = 0.01,
    weight_decay: float = 0.0,
    seed: int = 0,
    return_params: bool = False,
    init: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Returns {'top1': %, 'loss': the last step's}; with ``return_params``
    also 'params': (w (D, C), b (C,)). ``init`` is the initial w, by default
    ``probe_init`` from a CPU generator seeded with ``seed``."""
    tf = torch.as_tensor(train_feats).float()
    dev = tf.device
    tl = torch.as_tensor(train_labels).to(dev).long()
    N, D = tf.shape
    niter = max(N // batch_size, 1)
    lrs = cosine_scheduler(base_lr, 1e-6, epochs, niter).astype(np.float32)
    if init is None:
        init = probe_init(torch.Generator().manual_seed(seed), D, num_classes)
    w = torch.as_tensor(init).to(dev, torch.float32).clone().requires_grad_(True)
    b = torch.zeros(num_classes, dtype=torch.float32, device=dev, requires_grad=True)
    mu_w, mu_b = torch.zeros_like(w), torch.zeros_like(b)

    rng = np.random.RandomState(seed)
    it = 0
    loss = torch.zeros((), device=dev)
    for _ in range(epochs):
        order = rng.permutation(N)
        for s in range(0, niter * batch_size, batch_size):
            idx = torch.from_numpy(order[s:s + batch_size]).to(dev)
            loss = F.cross_entropy(tf[idx] @ w + b, tl[idx])
            gw, gb = torch.autograd.grad(loss, (w, b))
            lr = float(lrs[min(it, len(lrs) - 1)])
            with torch.no_grad():
                mu_w.mul_(0.9).add_(gw + weight_decay * w)
                mu_b.mul_(0.9).add_(gb)
                w.sub_(lr * mu_w)
                b.sub_(lr * mu_b)
            it += 1
    w, b = w.detach(), b.detach()
    with torch.no_grad():
        pred = (torch.as_tensor(test_feats).to(dev).float() @ w + b).argmax(-1)
        top1 = float((pred == torch.as_tensor(test_labels).to(dev)).float().mean() * 100.0)
    out = {"top1": top1, "loss": float(loss.detach())}
    if return_params:
        out["params"] = (w, b)
    return out


def dense_linear_probe(
    train_tokens,  # (Nt, D) per-position frozen features
    train_labels,  # (Nt,) int class per position
    test_tokens,
    test_labels,
    num_classes: int,
    epochs: int = 30,
    batch_size: int = 4096,
    base_lr: float = 0.05,
    seed: int = 0,
    init: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Linear segmentation probe: one shared (D, C) classifier applied to
    every token, each token a sample labelled with the mask class at its
    centre. Features are standardized per dimension with the train
    statistics. Returns {'top1', 'miou', 'loss'} on the test tokens."""
    tr = torch.as_tensor(train_tokens).float()
    te = torch.as_tensor(test_tokens).to(tr.device).float()
    mu = tr.mean(dim=0, keepdim=True)
    sd = tr.std(dim=0, keepdim=True, correction=0) + 1e-6
    tr, te = (tr - mu) / sd, (te - mu) / sd
    res = train_linear_probe(
        tr, train_labels, te, test_labels, num_classes, epochs=epochs,
        batch_size=batch_size, base_lr=base_lr, seed=seed, return_params=True, init=init,
    )
    w, b = res.pop("params")
    pred = (te @ w + b).argmax(-1).cpu().numpy()
    gt = np.asarray(torch.as_tensor(test_labels).cpu())
    ious = []
    for c in range(num_classes):
        union = float(((pred == c) | (gt == c)).sum())
        if union > 0:
            ious.append(float(((pred == c) & (gt == c)).sum()) / union)
    res["miou"] = float(np.mean(ious)) if ious else 0.0
    return res

