"""The port's confusion-matrix figures against the JAX package's.

``wav2sleep_tpu_torch.plotting.plot_confusion_matrix`` draws the same title
and the same precision/recall margin tick texts as
``wav2sleep_tpu.plotting.plot_confusion_matrix`` (exact string equality),
with seaborn and with matplotlib alone; ``MetricsLogger.log_confusion``
writes ``<prefix>_conf_mats/<epoch:04d>.png`` beside ``metrics.jsonl``, and
skips the figure (logging the metrics all the same) where matplotlib is
missing.
"""

import json
import os
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg', force=True)

from wav2sleep_tpu import plotting as jax_plotting  # noqa: E402
from wav2sleep_tpu_torch import plotting  # noqa: E402

from .test_torch_threads import one_torch_thread  # noqa: E402,F401 - autouse

CMATS = {
    'four': np.array([[50, 2, 1, 0], [3, 40, 5, 2], [1, 6, 30, 3], [0, 2, 4, 44]], dtype=float),
    'empty_row_and_column': np.array([[5, 0, 1], [0, 0, 0], [2, 0, 7]], dtype=float),
    'five': np.arange(25, dtype=float).reshape(5, 5),
}


def _texts(mod, cmat, description):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    mod.plot_confusion_matrix([str(i) for i in range(len(cmat))], cmat, ax=ax, description=description)
    axes = [ax] + list(ax.child_axes)
    texts = (ax.get_title(), [[t.get_text() for t in a.get_xticklabels() + a.get_yticklabels()] for a in axes],
             [a.get_xlabel() + '|' + a.get_ylabel() for a in axes])
    plt.close(fig)
    return texts


@pytest.mark.parametrize('seaborn', [True, False], ids=['seaborn', 'matplotlib'])
@pytest.mark.parametrize('name', sorted(CMATS))
def test_title_and_margins_match_jax(name, seaborn, monkeypatch):
    """Exact: the title (description, acc, kappa) and every tick text and
    axis label, on the main and the secondary axes."""
    if not seaborn:
        monkeypatch.setitem(sys.modules, 'seaborn', None)
    else:
        pytest.importorskip('seaborn')
    for description in (None, 'val/mesa'):
        assert _texts(plotting, CMATS[name], description) == _texts(jax_plotting, CMATS[name], description)


def test_log_confusion_writes_the_png(tmp_path):
    """The trainer's logger writes the figure where the JAX package's does
    (``<log_dir>/<prefix>_conf_mats/<epoch:04d>.png``), and the metrics."""
    from wav2sleep_tpu_torch.train.loop import MetricsLogger

    logger = MetricsLogger(str(tmp_path))
    metrics = logger.log_confusion(CMATS['four'], epoch=3, prefix='val_mesa')
    png = tmp_path / 'val_mesa_conf_mats' / '0003.png'
    assert png.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
    line = json.loads((tmp_path / 'metrics.jsonl').read_text().splitlines()[-1])
    assert line['val_mesa_kappa'] == metrics['val_mesa_kappa']


def test_missing_matplotlib_is_skipped(tmp_path, monkeypatch):
    """Without matplotlib the metrics are logged and no figure is made."""
    from wav2sleep_tpu_torch.log import log_aux_metrics

    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    metrics = log_aux_metrics(CMATS['four'], 1, 'val_x', artifact_dir=str(tmp_path))
    assert set(metrics) == {'val_x_acc', 'val_x_kappa'}
    assert os.listdir(tmp_path / 'val_x_conf_mats') == []
