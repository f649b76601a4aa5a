"""K3's plain version (wav2sleep_tpu_torch.ops.ema_norm) against the JAX
package's Pallas EMA kernel in interpret mode (atol 1e-4, both f32) and the
f64 host normalizer (atol 5e-3, the tolerance of tests/data/
test_pallas_ema.py), on that file's shapes; the causal-prefix property the
on-card check relies on; and the port's native host EMA against the JAX
package's. On the CPU ``ema_normalize`` runs its plain version; the kernel
is checked on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from wav2sleep_tpu.ops.ema_norm import causal_rolling_normalize, causal_rolling_normalize_f32
from wav2sleep_tpu.ops.pallas_ema import ema_normalize_pallas
from wav2sleep_tpu_torch.ops import ema_norm
from wav2sleep_tpu_torch.settings import CAUSAL_NORM_BASELINE_TAU_SECONDS, CAUSAL_NORM_TAU_SECONDS


def _rows(case):
    """tests/data/test_pallas_ema.py's inputs: (x [N, T], fs, baseline tau, Pallas block)."""
    if case == 'multichannel':
        x = np.random.default_rng(0).normal(size=(3, 20_000)).astype(np.float32)
        x[0, 5_000] = 40.0  # outlier
        x[2] = x[2] * 0.01  # low-variance row (sigma floor active)
        return x, 34.0, 120.0, 512
    if case == 'single':
        return np.random.default_rng(1).normal(size=(1, 4_096)).astype(np.float32), 8.533, None, 512
    return np.random.default_rng(2).normal(size=(5, 1_111)).astype(np.float32), 34.0, None, 256


CASES = ['multichannel', 'single', 'ragged']


@pytest.fixture(scope='module')
def port_out():
    out = {}
    for case in CASES:
        x, fs, btau, _ = _rows(case)
        (got,) = ema_norm.ema_normalize([torch.from_numpy(x)], [fs], baseline_tau_seconds=btau)
        out[case] = got.numpy()
    return out


@pytest.mark.parametrize('case', CASES)
def test_matches_pallas_interpret(port_out, case):
    x, fs, btau, block = _rows(case)
    want = np.asarray(ema_normalize_pallas(x, fs, baseline_tau_seconds=btau, block=block, interpret=True))
    got = port_out[case]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('case', CASES)
def test_matches_host_f64(port_out, case):
    x, fs, btau, _ = _rows(case)
    for i in range(x.shape[0]):
        want = causal_rolling_normalize(x[i], fs, baseline_tau_seconds=btau)
        np.testing.assert_allclose(port_out[case][i], want, atol=5e-3, rtol=0)


def test_groups_in_one_call_equal_separate_calls():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(2, 3_000)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(3, 700)) * 5 + 2).astype(np.float32))
    both = ema_norm.ema_normalize([a, b], [34.13, 8.53], baseline_tau_seconds=120.0)
    assert [t.shape for t in both] == [a.shape, b.shape]
    torch.testing.assert_close(both[0], ema_norm.ema_normalize([a], [34.13], baseline_tau_seconds=120.0)[0], rtol=0, atol=0)
    torch.testing.assert_close(both[1], ema_norm.ema_normalize([b], [8.53], baseline_tau_seconds=120.0)[0], rtol=0, atol=0)


def test_causal_prefix():
    """The recurrence is causal, so a row's first samples normalize alone
    as they do inside the whole row whenever both lengths give the same
    warm-up window; chip_smoke.py's check of the kernel against the plain
    version on the first 65,536 samples of ten-hour rows relies on it."""
    fs, prefix = 256 / 30, 12_000
    x = np.random.default_rng(4).normal(size=(2, 20_000)).astype(np.float32)
    args = dict(tau_seconds=CAUSAL_NORM_TAU_SECONDS, baseline_tau_seconds=CAUSAL_NORM_BASELINE_TAU_SECONDS)
    assert ema_norm.warmup_length(20_000, fs, **args) == ema_norm.warmup_length(prefix, fs, **args) == 1024
    (full,) = ema_norm.ema_normalize([torch.from_numpy(x)], [fs], **args)
    (head,) = ema_norm.ema_normalize([torch.from_numpy(x[:, :prefix])], [fs], **args)
    torch.testing.assert_close(head, full[:, :prefix], rtol=0, atol=0)
    # The warm-up windows of the on-card check's rows: ten-hour grids and
    # their 65,536-sample prefixes.
    for spe in (1024, 256):
        for T in (1200 * spe, 65_536):
            assert ema_norm.warmup_length(T, spe / 30, **args) == ema_norm.warmup_length(1200 * spe, spe / 30, **args)


def test_native_host_ema_equals_the_jax_packages():
    x = np.random.default_rng(5).normal(size=20_000).astype(np.float32) * 0.7 + 0.2
    x[9_000] = 30.0
    for fs, btau in ((1024 / 30, 120.0), (256 / 30, None)):
        got = ema_norm.ema_normalize_host(x, fs, baseline_tau_seconds=btau)
        want = causal_rolling_normalize_f32(x, fs, baseline_tau_seconds=btau)
        np.testing.assert_array_equal(got, want)


def test_refusals():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match='one sampling frequency'):
        ema_norm.ema_normalize([x], [34.0, 8.5])
    with pytest.raises(ValueError, match='float32'):
        ema_norm.ema_normalize([x.double()], [34.0])
    with pytest.raises(ValueError, match='float32'):
        ema_norm.ema_normalize([x[0]], [34.0])
