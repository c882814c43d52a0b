"""DINO-style weighted-kNN classifier on extracted features.

Port of ``gm3d_tpu/eval/knn.py`` (reference ``main_knn.py:154-198``
knn_classifier), an alternative probe to the linear SVM over the same pooled
encoder features. It runs in float64 on the features' device (the card's,
where ``cli/evaluate.py`` extracted them), with ``torch.topk`` for the
neighbours.

Ties: ``np.argsort`` (the JAX package's) is not stable and ``torch.topk`` is
not either; where two training features tie at the k-th place the two
packages may take different neighbours.
"""

from __future__ import annotations

from typing import Optional

import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def knn_classifier(train_features, train_labels, test_features, test_labels,
                   k: int = 20, temperature: float = 0.07,
                   num_classes: Optional[int] = None) -> float:
    """Cosine-similarity weighted vote over the k nearest training features
    (all of them where ``k`` is above their number): each neighbour votes
    ``exp(similarity / temperature)`` for its label. Tensors or numpy arrays;
    the accuracy as a fraction."""
    tr = torch.as_tensor(train_features)
    dev = tr.device
    tr = _normalize(tr.to(torch.float64))
    te = _normalize(torch.as_tensor(test_features, device=dev).to(torch.float64))
    ytr = torch.as_tensor(train_labels, device=dev).to(torch.int64)
    yte = torch.as_tensor(test_labels, device=dev).to(torch.int64)
    if num_classes is None:
        num_classes = int(ytr.max()) + 1
    sim = te @ tr.t()  # (Nte, Ntr)
    # at most every training feature, as the JAX package's argsort slice keeps
    topk_sim, idx = torch.topk(sim, min(k, tr.shape[0]), dim=1)
    weights = torch.exp(topk_sim / temperature)
    votes = torch.zeros((te.shape[0], num_classes), dtype=torch.float64, device=dev)
    votes.scatter_add_(1, ytr[idx], weights)
    return float((votes.argmax(1) == yte).to(torch.float64).mean())
