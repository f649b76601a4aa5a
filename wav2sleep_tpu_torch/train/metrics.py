"""Classification metrics of the training and evaluation steps.

Port of ``wav2sleep_tpu/train/metrics.py``: the confusion matrix and the
mean cross-entropy over labels that are not ignored (label -1), both
computed on the device so the host only reads their results.
"""

from __future__ import annotations

import torch


def confusion_matrix(logits_or_preds: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     from_logits: bool = True) -> torch.Tensor:
    """[C, C] int64 confusion matrix (rows = true, cols = predicted); labels < 0
    are ignored."""
    preds = logits_or_preds.argmax(dim=-1) if from_logits else logits_or_preds
    preds = preds.reshape(-1).to(torch.int64)
    labels = labels.reshape(-1).to(torch.int64)
    valid = labels >= 0
    idx = torch.where(valid, labels * num_classes + preds, 0)
    counts = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, valid.to(torch.int64))
    return counts.reshape(num_classes, num_classes)


def cross_entropy_ignore_index(logits_NC: torch.Tensor, labels_N: torch.Tensor,
                               label_smoothing: float = 0.0, count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, in f32 whatever the logits'
    dtype; with ``label_smoothing`` the mix ``(1 - s) nll + s mean(-log p)``.
    ``count`` replaces the number of labels >= 0 as the divisor: a rank of a
    data-parallel group divides its sum by the global batch's count."""
    labels = labels_N.to(torch.int64)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logp = logits_NC.float()
    log_probs = logp - logp.amax(dim=-1, keepdim=True)
    log_probs = log_probs - log_probs.exp().sum(dim=-1, keepdim=True).log()
    nll = -log_probs.gather(-1, safe[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / (valid.sum() if count is None else count).clamp_min(1)
