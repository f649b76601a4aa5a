"""The port's synthetic corpus against the JAX package's.

``wav2sleep_tpu_torch.data.synth.write_nights`` and
``wav2sleep_tpu.data.synth.write_nights`` with the same seed and arguments
write the same EDF files and return the same labels, for the cardio and EOG
kinds, the default and custom rates and each difficulty knob. Tolerance is
exact: byte-equal files and equal label arrays (dtype included).
"""

import os

import numpy as np
import pytest

from wav2sleep_tpu.data import synth as jax_synth
from wav2sleep_tpu_torch.data import synth

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

CASES = {
    'cardio': dict(kind='cardio'),
    'cardio_overlap': dict(kind='cardio', overlap=0.6),
    'cardio_label_noise': dict(kind='cardio', label_noise=0.25),
    'cardio_rates': dict(kind='cardio', rates={'ECG': 200.0, 'Pleth': 64.0, 'ABDO RES': 8.0, 'THOR RES': 8.0}),
    'eog': dict(kind='eog'),
    'eog_knobs': dict(kind='eog', overlap=0.3, label_noise=0.1),
}


def _same_nights(tmp_path, n_nights, hours, seed, **kwargs):
    out = {}
    for name, mod in (('jax', jax_synth), ('port', synth)):
        folder = tmp_path / name
        folder.mkdir(parents=True, exist_ok=True)
        fps, labels = mod.write_nights(str(folder), n_nights, hours, seed, **kwargs)
        out[name] = ([os.path.basename(fp) for fp in fps], [open(fp, 'rb').read() for fp in fps], labels)
    (jax_names, jax_bytes, jax_labels), (names, data, labels) = out['jax'], out['port']
    assert names == jax_names
    assert [d == j for d, j in zip(data, jax_bytes)] == [True] * n_nights
    assert labels.dtype == jax_labels.dtype
    np.testing.assert_array_equal(labels, jax_labels)
    return labels


@pytest.mark.parametrize('case', sorted(CASES))
def test_write_nights_bytes_and_labels_match_jax(case, tmp_path):
    """Exact: two nights of 0.25 h, byte-equal EDFs and equal labels."""
    labels = _same_nights(tmp_path, 2, 0.25, seed=7, **CASES[case])
    assert labels.shape == (2, 30)


def test_caches_across_calls_match_jax(tmp_path):
    """Exact over a sequence of calls that reuses and resizes the scratch
    and time-grid caches (lengths and rates that change between calls)."""
    for i, (hours, kwargs) in enumerate([(0.5, {}), (0.25, {'kind': 'eog'}), (0.25, {}),
                                         (0.5, CASES['cardio_rates']), (0.5, {'kind': 'eog'})]):
        _same_nights(tmp_path / str(i), 1, hours, seed=i, **kwargs)
