"""Confusion-matrix figures.

The port's copy of ``wav2sleep_tpu/plotting.py``: a heatmap (seaborn's when
it imports, else matplotlib's ``imshow``) with per-class precision and
recall on secondary axes and accuracy and kappa in the title. matplotlib is
imported inside the functions only, so the port imports and runs where it is
not installed; the training logger draws its figures best effort.
"""

from __future__ import annotations

import numpy as np

from .settings import SLEEP_STAGE_CATEGORIES
from .stats import cohens_kappa, confusion_accuracy


def plot_confusion_matrix(
    categories,
    cmat,
    ax=None,
    description: str | None = None,
    heatmap_cmap: str = 'Purples',
    normalize: bool = True,
):
    """Render a confusion matrix (rows=true, cols=pred) with per-class
    precision/recall margins and acc/kappa in the title."""
    import matplotlib.pyplot as plt

    cmat = np.asarray(cmat, dtype=float)
    if ax is None:
        _, ax = plt.subplots(1, 1)
    n = len(categories)
    row_sums = cmat.sum(axis=1, keepdims=True)
    col_sums = cmat.sum(axis=0, keepdims=True)
    with np.errstate(divide='ignore', invalid='ignore'):
        recall = np.where(row_sums[:, 0] > 0, np.diag(cmat) / row_sums[:, 0], np.nan)
        precision = np.where(col_sums[0] > 0, np.diag(cmat) / col_sums[0], np.nan)
        shown = cmat / row_sums if normalize else cmat
    shown = np.nan_to_num(shown)

    # Cell-center coordinates differ per backend: seaborn heatmaps center
    # cell i at i + 0.5, imshow at i — the secondary precision/recall axes
    # must use the same centers or every margin lands between cells.
    try:
        import seaborn as sns

        sns.heatmap(
            shown,
            annot=cmat.astype(int) if cmat.sum() < 1e7 else True,
            fmt='d' if cmat.sum() < 1e7 else '.2f',
            cmap=heatmap_cmap,
            cbar=False,
            xticklabels=categories,
            yticklabels=categories,
            ax=ax,
        )
        centers = np.arange(n) + 0.5
    except ImportError:
        ax.imshow(shown, cmap=heatmap_cmap)
        ax.set_xticks(range(n), categories)
        ax.set_yticks(range(n), categories)
        centers = np.arange(n, dtype=float)
    ax.set_xlabel('Predicted')
    ax.set_ylabel('True')

    acc = confusion_accuracy(cmat)
    kappa = cohens_kappa(cmat, n_classes=n)
    title = f'acc={acc:.3f}  κ={kappa:.3f}'
    if description:
        title = f'{description}\n{title}'
    ax.set_title(title)

    # Per-class precision/recall margins.
    sec_x = ax.secondary_xaxis('top')
    sec_x.set_xticks(centers, [f'{p:.2f}' if np.isfinite(p) else '-' for p in precision])
    sec_x.set_xlabel('Precision')
    sec_y = ax.secondary_yaxis('right')
    sec_y.set_yticks(centers, [f'{r:.2f}' if np.isfinite(r) else '-' for r in recall])
    sec_y.set_ylabel('Recall')
    return ax


def save_confusion_png(cmat, path: str, num_classes: int | None = None) -> None:
    """Write a confusion-matrix PNG (used by the training metrics logger)."""
    import matplotlib

    matplotlib.use('Agg', force=False)
    import matplotlib.pyplot as plt

    n = num_classes or len(cmat)
    categories = SLEEP_STAGE_CATEGORIES.get(n, [str(i) for i in range(n)])
    fig, ax = plt.subplots(1, 1)
    plot_confusion_matrix(categories, cmat, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
