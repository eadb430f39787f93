"""Classification metrics from a masked confusion matrix (counterpart of
multimodalsignal_tpu/train/metrics.py).

Parity targets: sklearn.metrics accuracy_score / f1_score(average='weighted',
zero_division=0) / confusion_matrix. Plain functions on tensors, float32
throughout as in the JAX package; the mask carries the 0/1 sample weights of
the wrap-padded batches. Leading axes are lanes (the sweep's folds): labels
[F, B] give confusion matrices [F, K, K] and metrics [F], each lane's own.
"""

from __future__ import annotations

import math

import torch


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     num_classes: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """[..., num_classes, num_classes] float32 counts; rows = true, cols =
    predicted."""
    if mask is None:
        mask = torch.ones(y_true.shape, dtype=torch.float32, device=y_true.device)
    lead = tuple(y_true.shape[:-1])
    cells = num_classes * num_classes
    lanes = torch.arange(math.prod(lead), device=y_true.device).reshape(lead + (1,))
    idx = (lanes * cells + y_true * num_classes + y_pred).long()
    flat = torch.zeros(math.prod(lead) * cells, dtype=torch.float32, device=y_true.device)
    flat.index_add_(0, idx.reshape(-1), mask.float().reshape(-1))
    return flat.reshape(lead + (num_classes, num_classes))


def accuracy_from_cm(cm: torch.Tensor) -> torch.Tensor:
    total = cm.sum(dim=(-2, -1))
    trace = cm.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    return torch.where(total > 0, trace / total, torch.zeros_like(total))


def weighted_f1_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """Support-weighted mean of per-class F1 (sklearn average='weighted').
    Classes with zero support contribute nothing; classes with zero
    precision + recall get F1 = 0 (zero_division=0)."""
    tp = cm.diagonal(dim1=-2, dim2=-1)
    support = cm.sum(dim=-1)
    predicted = cm.sum(dim=-2)
    zero = torch.zeros_like(tp)
    precision = torch.where(predicted > 0, tp / predicted.clamp(min=1e-12), zero)
    recall = torch.where(support > 0, tp / support.clamp(min=1e-12), zero)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall / denom.clamp(min=1e-12), zero)
    total = support.sum(dim=-1)
    return torch.where(total > 0, (f1 * support).sum(dim=-1) / total.clamp(min=1e-12),
                       torch.zeros_like(total))
