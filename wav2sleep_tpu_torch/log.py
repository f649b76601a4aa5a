"""Confusion-matrix metric logging.

The port's counterpart of ``wav2sleep_tpu/log.py``: ``log_aux_metrics``
records ``{prefix}_acc`` and ``{prefix}_kappa`` of one confusion matrix as a
line of ``metrics.jsonl`` in an artifacts folder and, when
``MLFLOW_TRACKING_URI`` is set and ``mlflow`` imports, to MLflow. The JAX
package also renders a confusion PNG when its plotting imports; that figure
is best effort there and is not drawn here.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .stats import cohens_kappa, confusion_accuracy

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


def log_aux_metrics(cmat, epoch: int, prefix: str, artifact_dir: str | None = None) -> dict[str, float]:
    """Log accuracy and kappa of one (prefix, epoch) confusion matrix;
    returns them."""
    cmat = np.asarray(cmat, dtype=float)
    metrics = {f'{prefix}_acc': confusion_accuracy(cmat), f'{prefix}_kappa': cohens_kappa(cmat, n_classes=len(cmat))}
    out = artifact_dir or os.environ.get('WAV2SLEEP_ARTIFACTS', DEFAULT_ARTIFACT_DIR)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'metrics.jsonl'), 'a') as f:
        f.write(json.dumps({'step': epoch, 'time': time.time(), **metrics}) + '\n')
    mlflow = mlflow_module()
    if mlflow is not None:
        mlflow.log_metrics(metrics, step=epoch)
    return metrics
