"""Losses and ranking metrics (port of ``repro.train.losses``)."""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def bce_with_logits(logits: Tensor, labels: Tensor,
                    weights: Tensor | None = None) -> Tensor:
    """Numerically stable binary cross-entropy over logits."""
    logits = logits.float()
    labels = labels.float()
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    if weights is not None:
        per = per * weights
        return per.sum() / torch.clamp(weights.sum(), min=1.0)
    return per.mean()


def softmax_xent(logits: Tensor, labels: Tensor) -> Tensor:
    """logits: (..., V); labels: (...) int ids. Mean NLL."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def auc(scores, labels) -> float:
    """Exact ROC-AUC via rank statistic (numpy, for eval-time use)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    s = np.concatenate([pos, neg])
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average ranks for ties
    _, inv, cnt = np.unique(s, return_inverse=True, return_counts=True)
    sums = np.zeros(len(cnt))
    np.add.at(sums, inv, ranks)
    ranks = (sums / cnt)[inv]
    r_pos = ranks[: len(pos)].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2)
                 / (len(pos) * len(neg)))


def valid_task_aucs(scores, labels) -> dict[int, float]:
    """Per-task ROC-AUCs over the trailing task axis, skipping degenerate
    slices: a task whose labels are single-class has no defined ROC and
    is left out of the result, so callers assert on the tasks that
    remain."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    out: dict[int, float] = {}
    for t in range(scores.shape[-1]):
        a = auc(scores[..., t], labels[..., t])
        if not np.isnan(a):
            out[t] = a
    return out
