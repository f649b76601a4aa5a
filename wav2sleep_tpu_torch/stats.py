"""Evaluation statistics for sleep staging, from confusion matrices.

The port's copy of ``wav2sleep_tpu/stats.py`` (numpy): accuracy and Cohen's
kappa, as the reference computes them, so the numbers compare directly.
"""

from __future__ import annotations

import numpy as np


def confusion_accuracy(cmat) -> float:
    """Accuracy from a confusion matrix (trace / total); nan when empty."""
    cmat = np.asarray(cmat)
    total = np.sum(cmat)
    if total == 0:
        return float('nan')
    return float(np.trace(cmat) / total)


def cohens_kappa(cmat, n_classes: int | None = None) -> float:
    """Cohen's kappa from a confusion matrix: what
    ``sklearn.metrics.cohen_kappa_score`` gives on the predictions and labels
    behind ``cmat``; nan when empty or when chance agreement is total."""
    cmat = np.asarray(cmat).astype(float)
    if n_classes is None:
        n_classes = cmat.shape[0]
    sum0 = np.sum(cmat, axis=0)
    sum1 = np.sum(cmat, axis=1)
    total = np.sum(sum0)
    if total == 0:
        return float('nan')
    expected = np.outer(sum0, sum1) / total
    w_mat = np.ones((n_classes, n_classes)) - np.eye(n_classes)
    denom = np.sum(w_mat * expected)
    if denom == 0:
        return float('nan')
    k = np.sum(w_mat * cmat) / denom
    return float(1 - k)
