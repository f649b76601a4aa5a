"""Confusion-matrix metric logging.

The port's counterpart of ``wav2sleep_tpu/log.py``: ``log_aux_metrics``
records ``{prefix}_acc`` and ``{prefix}_kappa`` of one confusion matrix as a
line of ``metrics.jsonl`` in an artifacts folder and, when
``MLFLOW_TRACKING_URI`` is set and ``mlflow`` imports, to MLflow, and draws
the matrix as ``<prefix>_conf_mats/<epoch:04d>.png`` beside it
(``plotting``; best effort, as in the JAX package: a missing matplotlib is
logged and skipped).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

from .stats import cohens_kappa, confusion_accuracy

logger = logging.getLogger(__name__)

DEFAULT_ARTIFACT_DIR = 'artifacts'


def mlflow_module():
    """``mlflow`` when a tracking URI is configured and it imports, else None."""
    if not os.environ.get('MLFLOW_TRACKING_URI'):
        return None
    try:
        import mlflow
    except ImportError:
        return None
    return mlflow


def save_confusion_figure(cmat, epoch: int, prefix: str, out: str) -> str | None:
    """``<out>/<prefix>_conf_mats/<epoch:04d>.png`` of ``cmat``; its path, or
    None when it could not be drawn (no matplotlib, say)."""
    try:
        from .plotting import save_confusion_png

        png_dir = os.path.join(out, f'{prefix}_conf_mats')
        os.makedirs(png_dir, exist_ok=True)
        png_path = os.path.join(png_dir, f'{epoch:04d}.png')
        save_confusion_png(cmat, png_path, num_classes=len(cmat))
        return png_path
    except Exception as e:  # noqa: BLE001 - the figure is best-effort observability
        logger.info(f'confusion figure skipped: {e}')
        return None


def log_aux_metrics(cmat, epoch: int, prefix: str, artifact_dir: str | None = None) -> dict[str, float]:
    """Log accuracy and kappa of one (prefix, epoch) confusion matrix, and
    its figure; returns them."""
    cmat = np.asarray(cmat, dtype=float)
    metrics = {f'{prefix}_acc': confusion_accuracy(cmat), f'{prefix}_kappa': cohens_kappa(cmat, n_classes=len(cmat))}
    out = artifact_dir or os.environ.get('WAV2SLEEP_ARTIFACTS', DEFAULT_ARTIFACT_DIR)
    os.makedirs(out, exist_ok=True)
    png_path = save_confusion_figure(cmat, epoch, prefix, out)
    with open(os.path.join(out, 'metrics.jsonl'), 'a') as f:
        f.write(json.dumps({'step': epoch, 'time': time.time(), **metrics}) + '\n')
    mlflow = mlflow_module()
    if mlflow is not None:
        mlflow.log_metrics(metrics, step=epoch)
        if png_path is not None:
            try:
                mlflow.log_artifact(png_path, artifact_path=f'{prefix}_conf_mats')
            except Exception as e:  # noqa: BLE001 - best effort, as the figure
                logger.debug(f'mlflow figure upload failed: {e}')
    return metrics
