"""Evaluation metrics on the host (numpy only; counterpart of
tpu_breath/train/metrics.py): accuracy, ROC-AUC, precision, recall, F1."""
from __future__ import annotations

import numpy as np


def binary_metrics(probs: np.ndarray, labels: np.ndarray
                   ) -> dict[str, float]:
    """The metrics of predictions probs > 0.5 against labels {0, 1}."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels, np.float64)
    preds = (probs > 0.5).astype(np.float64)
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    tn = float(np.sum((preds == 0) & (labels == 0)))
    acc = (tp + tn) / max(len(labels), 1)
    precision = tp / max(tp + fp, 1e-12)
    recall = tp / max(tp + fn, 1e-12)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"acc": acc, "auc": roc_auc(probs, labels),
            "precision": precision, "recall": recall, "f1": f1}


def roc_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney U) with average ranks over ties; NaN
    when one class is absent."""
    pos, neg = probs[labels == 1], probs[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    allv = np.concatenate([pos, neg])
    order = np.argsort(allv, kind="mergesort")
    sortedv = allv[order]
    # average rank of each run of equal values
    starts = np.flatnonzero(np.r_[True, sortedv[1:] != sortedv[:-1]])
    ends = np.r_[starts[1:], len(sortedv)]
    run_rank = (starts + 1 + ends) / 2.0
    ranks = np.empty(len(allv), np.float64)
    ranks[order] = np.repeat(run_rank, ends - starts)
    n_pos, n_neg = len(pos), len(neg)
    return float((ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
