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

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse


def _rows(case):
    """tests/data/test_pallas_ema.py's inputs: (x [N, T], fs, baseline tau, Pallas block)."""
    if case == 'multichannel':
        x = np.random.default_rng(0).normal(size=(3, 20_000)).astype(np.float32)
        x[0, 5_000] = 40.0  # outlier
        x[2] = x[2] * 0.01  # low-variance row (sigma floor active)
        return x, 34.0, 120.0, 512
    if case == 'single':
        return np.random.default_rng(1).normal(size=(1, 4_096)).astype(np.float32), 8.533, None, 512
    if case == 'clip_binds':
        # A spike of 25 (about 25 sigma) every 250-400 samples: the clip
        # binds at every spike.
        rng = np.random.default_rng(6)
        x = rng.normal(size=(2, 12_000)).astype(np.float32)
        for row in x:
            row[np.cumsum(rng.integers(250, 400, size=30))] = 25.0
        return x, 1024 / 30, 120.0, 512
    if case == 'floor_binds':
        # Variance 1e-4 and 0, under min_sigma**2 = 1e-2: the floor binds.
        rng = np.random.default_rng(7)
        x = np.stack([rng.normal(size=3_000) * 0.01 + 3.0, np.full(3_000, -2.0)]).astype(np.float32)
        return x, 256 / 30, 120.0, 256
    if case.startswith('length'):
        T = int(case[len('length'):])
        return np.random.default_rng(T).normal(size=(3, T)).astype(np.float32) * 2 + 1, 34.13, 120.0, 256
    return np.random.default_rng(2).normal(size=(5, 1_111)).astype(np.float32), 34.0, None, 256


# Lengths around the kernel's 32-sample chunks (one sample, a part of one
# chunk, one, one and a bit, many and a bit).
LENGTHS = [f'length{T}' for T in (1, 31, 32, 33, 2_049)]
CASES = ['multichannel', 'single', 'ragged', 'clip_binds', 'floor_binds'] + LENGTHS


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


@pytest.mark.parametrize('thr', [2.5, 3.0, 4.0, 5.0])
def test_matches_pallas_interpret_at_outlier_thresholds(thr):
    """Away from the default 4 (thr**2 16, a power of two, where the plain
    version's sqrt-free clip is bit for bit the clipped form), on the rows
    with spikes of 25, where the clip binds: atol 1e-4, as above."""
    x, fs, btau, block = _rows('clip_binds')
    (got,) = ema_norm.ema_normalize_reference([torch.from_numpy(x)], [fs], baseline_tau_seconds=btau,
                                              outlier_threshold_sigma=thr)
    want = np.asarray(ema_normalize_pallas(x, fs, baseline_tau_seconds=btau, outlier_threshold_sigma=thr,
                                           block=block, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('case', CASES)
def test_matches_host_f64(port_out, case):
    x, fs, btau, _ = _rows(case)
    for i in range(x.shape[0]):
        want = causal_rolling_normalize(x[i], fs, baseline_tau_seconds=btau)
        np.testing.assert_allclose(port_out[case][i], want, atol=5e-3, rtol=0)


def _binds(x, fs, btau):
    """Steps of the f64 recurrence at which the clip binds, and at which
    the variance floor does, over all rows."""
    ab, av = ema_norm._rates(fs, CAUSAL_NORM_TAU_SECONDS, btau)
    min_ss = 0.1**2
    clips = floors = 0
    for row in x.astype(np.float64):
        warm = row[: ema_norm.warmup_length(len(row), fs, CAUSAL_NORM_TAU_SECONDS, btau)]
        mu, ss = warm.mean(), max(warm.var(), min_ss)
        for v in row[1:]:
            mu = ab * v + (1 - ab) * mu
            m = max(ss, min_ss)
            floors += ss < min_ss
            clips += (v - mu) ** 2 > 16 * m
            ss = av * min((v - mu) ** 2, 16 * m) + (1 - av) * ss
    return clips, floors


def test_cases_reach_the_clip_and_the_floor():
    """The clip and floor cases exercise what they are named for."""
    clips, _ = _binds(*_rows('clip_binds')[:3])
    assert clips >= 50
    _, floors = _binds(*_rows('floor_binds')[:3])
    assert floors >= 2 * 2_999 - 10


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
