"""Evaluation metrics of the reference workloads (port of
``sir_gcn_tpu/train/metrics.py``): accuracy, balanced accuracy (SBM), MAE
(ZINC), MSE (hetero-edge-count) and ROC-AUC (molhiv,
heterophilous-binary; the rank-statistic AUC in place of the OGB
Evaluator or sklearn). NumPy in, Python floats out."""

from __future__ import annotations

import numpy as np


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.argmax(logits, -1) == labels))


def balanced_accuracy(logits: np.ndarray, labels: np.ndarray,
                      num_classes: int) -> float:
    """Class-balanced accuracy (reference
    ``benchmark-datasets/sbm-dataset/train.py:58-61``): the mean of the
    per-class recalls over the classes present in ``labels``."""
    pred = np.argmax(logits, -1)
    accs = []
    for c in range(num_classes):
        m = labels == c
        if m.any():
            accs.append(float(np.mean(pred[m] == c)))
    return float(np.mean(accs))


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary ROC-AUC by the Mann-Whitney U statistic with tie-aware
    midranks (sklearn's ``roc_auc_score``); NaN with one class only."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    r = np.arange(1, scores.size + 1, dtype=np.float64)
    i = 0
    while i < scores.size:  # a run of ties shares its mean rank
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i:j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    ranks = np.empty_like(scores)
    ranks[order] = r
    auc = (ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def mae(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - target)))


def mse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean((pred - target) ** 2))
