"""Waveform resampling onto the model's uniform per-signal grids.

The port's copy of the numpy resamplers of ``wav2sleep_tpu/data/
preprocessing.py``: each signal is linearly interpolated onto a right-aligned
uniform grid of ``samples_per_epoch / 30`` Hz spanning ``max_length_hours``;
grid points outside the recorded range become 0.0. ``NightDecoder`` uses
``resample_uniform`` when the native host library is absent;
``interp_to_grid`` (the core of ``data/utils.py::interp_to_grid``) is the
general (timestamps, values) form it is tested against.

The inference API's preprocessing (``process_waveform_arrays``,
``process_waveform_frame``) gives a night as the JAX package's
``process_waveform_dataframe`` frames it: every signal on its grid, the
grids' union as the index, NaN where a signal has no grid point, and a
datetime index (start + grid) where the input had one.
"""

from __future__ import annotations

import datetime
import functools
from collections import OrderedDict

import numpy as np

from ..settings import (ABD, COLS_TO_SAMPLES_PER_EPOCH, ECG, EOG_L, EOG_R, EPOCH_SECONDS, PPG, THX,
                        TRAINING_LENGTH_HOURS)
from .edf import sample_seconds
from .frame import Frame, datetime_to_ns, seconds_to_ns

CARDIO_RESP_COLS = [ECG, PPG, ABD, THX]
NEURAL_COLS = [EOG_L, EOG_R]
EDF_COLS = CARDIO_RESP_COLS + NEURAL_COLS

# The label grid of a training night: the end of each 30 s epoch, 30 ... 36,000 s.
TARGET_LABEL_INDEX = np.arange(0, TRAINING_LENGTH_HOURS * 60 * 60 + 1, 30.0)[1:]


def signal_target_grid(col: str, max_length_hours: float) -> np.ndarray:
    """Right-aligned uniform timestamp grid (seconds) for one signal."""
    step = EPOCH_SECONDS / COLS_TO_SAMPLES_PER_EPOCH[col]
    return np.arange(0, max_length_hours * 60 * 60 + 1e-9, step)[1:]


def interp_to_grid(
    t_src: np.ndarray,
    values: np.ndarray,
    t_target: np.ndarray,
    interior_only: bool = True,
    fill_value: float = np.nan,
) -> np.ndarray:
    """Linear interpolation of (t_src, values) onto t_target; with
    ``interior_only`` points outside [t_src[0], t_src[-1]] get
    ``fill_value`` instead of clamped extrapolation."""
    t_src = np.asarray(t_src, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    t_target = np.asarray(t_target, dtype=np.float64)
    out = np.interp(t_target, t_src, values)
    if interior_only and len(t_src):
        outside = (t_target < t_src[0]) | (t_target > t_src[-1])
        if outside.any():
            out = out.copy()
            out[outside] = fill_value
    return out


_RESAMPLE_PLAN_CACHE: OrderedDict = OrderedDict()
# Keyed by the per-night sample count, which differs for nearly every night
# of a variable-length corpus: a small LRU bounds the plans kept.
_RESAMPLE_PLAN_MAX = 8


def _resample_plan(fs: float, n: int, col: str, max_length_hours: float):
    """Cached gather indices + lerp weights for a (rate, length) pair."""
    key = (round(fs, 9), n, col, max_length_hours)
    plan = _RESAMPLE_PLAN_CACHE.get(key)
    if plan is None:
        pos = signal_target_grid(col, max_length_hours) * fs
        idx = np.floor(pos).astype(np.int64)
        frac = (pos - idx).astype(np.float32)
        invalid = (pos < 0) | (pos > n - 1)
        idx0 = np.clip(idx, 0, n - 1)
        idx1 = np.clip(idx + 1, 0, n - 1)
        plan = (idx0, idx1, frac, invalid if invalid.any() else None)
        _RESAMPLE_PLAN_CACHE[key] = plan
        if len(_RESAMPLE_PLAN_CACHE) > _RESAMPLE_PLAN_MAX:
            _RESAMPLE_PLAN_CACHE.popitem(last=False)
    else:
        _RESAMPLE_PLAN_CACHE.move_to_end(key)
    return plan


def resample_uniform(
    values: np.ndarray, fs: float, col: str, max_length_hours: float, out: np.ndarray | None = None
) -> np.ndarray:
    """Resample a uniformly sampled signal (rate ``fs``, first sample at
    t=0) onto the model grid: ``interp_to_grid(arange(n) / fs, values,
    grid, fill_value=0.0)`` as one gather + lerp pass in f32, into an
    optional caller-owned ``out``."""
    idx0, idx1, frac, invalid = _resample_plan(fs, len(values), col, max_length_hours)
    v = values.astype(np.float32, copy=False)
    m = len(idx0)
    if out is None:
        out = np.empty(m, dtype=np.float32)
    tmp = _take_scratch(m)
    # out = v0 + frac * (v1 - v0), staged through pooled scratch only.
    np.take(v, idx0, out=tmp)
    np.take(v, idx1, out=out)
    out -= tmp
    out *= frac
    out += tmp
    if invalid is not None:
        out[invalid] = 0.0
    return out


_TAKE_SCRATCH: dict[int, np.ndarray] = {}


def _take_scratch(n: int) -> np.ndarray:
    """Pooled scratch (not thread-safe across concurrent resamples of the
    same length; the streaming pipeline has one producer)."""
    buf = _TAKE_SCRATCH.get(n)
    if buf is None:
        buf = np.empty(n, dtype=np.float32)
        _TAKE_SCRATCH[n] = buf
    return buf


def resample_to_frame(
    series: dict[str, tuple[np.ndarray, np.ndarray]], columns: list[str], max_length_hours: float
) -> Frame:
    """Each of ``columns`` found in ``series`` (``{col: (t_seconds,
    values)}``) interpolated onto its grid (interior only, 0.0 outside), as
    float32 columns over the union of their grids, NaN where a signal's grid
    has no point, the rows in time order (the JAX package's ``pd.concat(
    axis=1)`` rows sorted by time: ROADMAP §C.19). Raises ``ValueError``
    when none is found."""
    resampled, grids = {}, {}
    for col in columns:
        if col not in series:
            continue
        t, values = series[col]
        grids[col] = signal_target_grid(col, max_length_hours)
        resampled[col] = interp_to_grid(t, values, grids[col], interior_only=True, fill_value=0.0).astype(np.float32)
    if not resampled:
        raise ValueError(f'None of {columns} present in signals {list(series)}')
    index = functools.reduce(np.union1d, grids.values())
    out = Frame(index)
    for col, values in resampled.items():
        full = np.full(len(index), np.nan, np.float32)
        full[np.searchsorted(index, grids[col])] = values
        out.columns[col] = full
    return out


def process_waveform_arrays(
    arrays: dict[str, tuple[np.ndarray, float]],
    columns: list[str],
    max_length_hours: float = TRAINING_LENGTH_HOURS,
    start: datetime.datetime | None = None,
) -> Frame:
    """``load_edf_arrays``' ``{col: (values, fs)}`` resampled onto the
    model grids (``resample_to_frame``), each signal's samples at
    ``arange(n) / fs`` seconds: the JAX package's ``process_waveform_arrays``.
    With ``start`` it is the inference API's EDF path instead (the JAX
    package's ``load_edf_data(convert_time=True)`` then
    ``process_waveform_dataframe``): the sample times as its datetime index
    rounds them (``edf.sample_seconds``), and the index ``start`` + grid."""
    series = {col: (sample_seconds(len(sig), fs, convert_time=start is not None), sig)
              for col, (sig, fs) in arrays.items()}
    out = resample_to_frame(series, columns, max_length_hours)
    if start is not None:
        out = Frame(datetime_to_ns(start) + seconds_to_ns(out.index), out.columns, datetime=True)
    return out


def process_waveform_frame(
    frame: Frame, columns: list[str], max_length_hours: float = TRAINING_LENGTH_HOURS
) -> Frame:
    """The JAX package's ``process_waveform_dataframe`` on a ``Frame``: each
    of ``columns`` without its NaNs, at the index's seconds from its first
    value (datetime) or as they are (seconds), resampled onto the model
    grids (``resample_to_frame``); a datetime index comes back as the first
    stamp + grid. Raises ``ValueError`` for an empty frame."""
    if len(frame.index) == 0:
        raise ValueError('empty frame')
    t = frame.seconds()
    series = {}
    for col in columns:
        if col in frame.columns:
            values = np.asarray(frame.columns[col], dtype=np.float64)
            keep = ~np.isnan(values)
            series[col] = (t[keep], values[keep])
    out = resample_to_frame(series, columns, max_length_hours)
    if frame.datetime:
        out = Frame(frame.index[0] + seconds_to_ns(out.index), out.columns, datetime=True)
    return out
