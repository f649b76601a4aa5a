"""K3: causal EMA normalization of signal rows, on the card.

``ema_normalize`` replaces ``wav2sleep_tpu/ops/pallas_ema.py::_ema_kernel``
(behind ``ema_normalize_pallas``) with a CUDA C++ kernel for sm_90a,
``csrc/ema_norm.cu``. It normalizes groups of rows ``[N_i, T_i]`` (one
group per modality, each with its own sampling rate) in ONE launch: a
two-time-constant exponential moving average tracks each row's baseline and
variance, residuals are clipped at ``outlier_threshold_sigma`` times the
previous sigma, and sigma is floored at ``min_sigma``. The clip makes the
recurrence non-associative, so each row is walked serially.

The variance update is written without a square root: the TPU kernel's
``alpha_v * clip(d, +-thr * sqrt(m))**2`` (``m = max(ss, min_sigma**2)``) is
``min(alpha_v * d * d, max(c * ss, c * min_sigma**2))`` here, ``c = alpha_v *
thr**2`` per row, equal in real numbers and within 1e-5 of it in f32 (bit
for bit when ``thr**2`` is a power of two). That leaves four dependent f32
operations a step on the kernel's serial chain; the kernel walks each row
with one warp, the mean one chunk ahead of the variance, keeps the next
chunks' loads in flight, and computes each output once. On an NVIDIA H100
80GB HBM3 (700 W) one serving batch's 32 rows (8 ten-hour nights x 4
modalities) take ~23 ms, from ~80 ms with the square root on the chain
(``python -m wav2sleep_tpu_torch.bench_ema``, ``chip_smoke.py`` phase 5,
PERF.md). The note at the top of the CUDA source has the design.

The warm-up state (mean and floored variance of each row's first
``n_warm = max(1, min(tau_w * fs, T // 10))`` samples, ``tau_w`` the smaller
time constant) is computed here in torch, as the JAX package computes it in
XLA outside its Pallas call. ``ema_normalize_reference`` is the plain
PyTorch version (a time loop over ``[N]`` vectors); ``ema_normalize`` runs it
for CPU tensors and launches the kernel, or raises, for CUDA tensors.
``ema_normalize_host`` is the native host library's f64 recurrence, the
full-length reference for the kernel; ``causal_rolling_normalize`` is the
JAX package's f64 host normalization (f64 out), on the library's
``w2s_ema_stats`` or a Python loop, which the dataset's causal mode takes
for input that is not f32.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..settings import CAUSAL_NORM_MIN_SIGMA, NORM_OUTLIER_THRESHOLD
from .cuda_build import compile_library

# Kernel launches made by ``ema_normalize`` (CUDA tensors only).
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ''


def build() -> ctypes.CDLL:
    """Compile ``csrc/ema_norm.cu`` (once per source and flags) and load it."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, BUILD_LOG = compile_library('ema_norm.cu')
        lib = ctypes.CDLL(str(path))
        lib.w2s_ema_normalize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.w2s_ema_normalize.restype = ctypes.c_int
        _lib = lib
        return lib


def warmup_length(T: int, sampling_freq: float, tau_seconds: float, baseline_tau_seconds: float | None) -> int:
    """Samples of a length-``T`` row that set its warm-up state."""
    baseline_tau = baseline_tau_seconds if baseline_tau_seconds is not None else tau_seconds
    return max(1, min(int(min(baseline_tau, tau_seconds) * sampling_freq), T // 10))


def _rates(sampling_freq: float, tau_seconds: float, baseline_tau_seconds: float | None):
    baseline_tau = baseline_tau_seconds if baseline_tau_seconds is not None else tau_seconds
    return 1.0 / sampling_freq / baseline_tau, 1.0 / sampling_freq / tau_seconds


def _warmup_state(x_NT, sampling_freq, tau_seconds, baseline_tau_seconds, min_sigma, eps):
    """(mu0, ss0), f32 [N]: mean and variance of the warm-up window, the
    variance floored at ``min_sigma**2`` and ``eps``."""
    warm = x_NT[:, : warmup_length(x_NT.shape[1], sampling_freq, tau_seconds, baseline_tau_seconds)]
    var, mu0 = torch.var_mean(warm.float(), dim=1, correction=0)
    return mu0, var.clamp_min(min_sigma * min_sigma).clamp_min(eps)


def _row_state(xs, sampling_freqs, tau_seconds, baseline_tau_seconds, outlier_threshold_sigma, min_sigma, eps):
    """Per group, the f32 [N_i] columns (mu0, ss0, alpha_b, 1 - alpha_b,
    alpha_v, 1 - alpha_v, c = alpha_v * thr**2, c * min_sigma**2) of its
    rows: the state and the constants of the recurrence, the same tensors
    for the kernel and the plain version."""
    per_row = []
    for x, fs in zip(xs, sampling_freqs):
        mu0, ss0 = _warmup_state(x, fs, tau_seconds, baseline_tau_seconds, min_sigma, eps)
        ab, av = _rates(fs, tau_seconds, baseline_tau_seconds)
        cols = [mu0, ss0, *(torch.full_like(mu0, r) for r in (ab, 1.0 - ab, av, 1.0 - av))]
        c = cols[4] * (outlier_threshold_sigma * outlier_threshold_sigma)
        per_row.append(cols + [c, c * (min_sigma * min_sigma)])
    return per_row


def _check_groups(xs, sampling_freqs):
    if len(xs) != len(sampling_freqs) or not xs:
        raise ValueError('ema_normalize: one sampling frequency per group of rows, at least one group')
    for x in xs:
        if x.dim() != 2 or x.dtype != torch.float32 or x.device != xs[0].device:
            raise ValueError(
                f'ema_normalize: groups must be float32 [N, T] on one device, got {x.dtype} '
                f'{tuple(x.shape)} on {x.device}'
            )


def ema_normalize_reference(
    xs: Sequence[torch.Tensor],
    sampling_freqs: Sequence[float],
    tau_seconds: float = 900.0,
    baseline_tau_seconds: float | None = None,
    outlier_threshold_sigma: float = NORM_OUTLIER_THRESHOLD,
    min_sigma: float = CAUSAL_NORM_MIN_SIGMA,
    eps: float = 1e-6,
) -> list[torch.Tensor]:
    """Plain PyTorch version of K3: the recurrence as a loop over time on
    ``[N]`` vectors of per-row state and rates, in f32, one operation at a
    time in the kernel's order. Groups of one length share the loop."""
    _check_groups(xs, sampling_freqs)
    min_ss = min_sigma * min_sigma
    per_row = _row_state(xs, sampling_freqs, tau_seconds, baseline_tau_seconds, outlier_threshold_sigma, min_sigma, eps)
    outs = [None] * len(xs)
    for T in sorted({x.shape[1] for x in xs}):
        idx = [i for i, x in enumerate(xs) if x.shape[1] == T]
        x = torch.cat([xs[i] for i in idx])
        mu, ss, ab, omab, av, omav, c, c_floor = (torch.cat([per_row[i][k] for i in idx]) for k in range(8))
        cols = [(x[:, 0] - mu) * torch.rsqrt(ss.clamp_min(min_ss))] if T else []
        for t in range(1, T):
            xt = x[:, t]
            mu = ab * xt + omab * mu
            d = xt - mu
            ss = torch.minimum(av * (d * d), torch.maximum(c * ss, c_floor)) + omav * ss
            cols.append(d * torch.rsqrt(ss.clamp_min(min_ss)))
        out = torch.stack(cols, dim=1) if T else torch.empty_like(x)
        for i, part in zip(idx, out.split([xs[i].shape[0] for i in idx])):
            outs[i] = part
    return outs


def ema_normalize(
    xs: Sequence[torch.Tensor],
    sampling_freqs: Sequence[float],
    tau_seconds: float = 900.0,
    baseline_tau_seconds: float | None = None,
    outlier_threshold_sigma: float = NORM_OUTLIER_THRESHOLD,
    min_sigma: float = CAUSAL_NORM_MIN_SIGMA,
    eps: float = 1e-6,
) -> list[torch.Tensor]:
    """Causal EMA-normalize groups of rows: ``xs[i]`` is f32 ``[N_i, T_i]``
    sampled at ``sampling_freqs[i]`` Hz. Returns one f32 tensor per group,
    shaped like its input. CUDA tensors go through K3 in one launch; CPU
    tensors through ``ema_normalize_reference``."""
    _check_groups(xs, sampling_freqs)
    dev = xs[0].device
    if dev.type == 'cpu':
        return ema_normalize_reference(
            xs, sampling_freqs, tau_seconds, baseline_tau_seconds, outlier_threshold_sigma, min_sigma, eps
        )
    if dev.type != 'cuda':
        raise ValueError(f'ema_normalize kernel needs CUDA tensors, got {dev}')
    global LAUNCHES
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    per_row = _row_state(xs, sampling_freqs, tau_seconds, baseline_tau_seconds, outlier_threshold_sigma, min_sigma, eps)
    params_t = torch.stack([torch.cat([p[k] for p in per_row]) for k in range(8)], dim=1).contiguous()
    rows = [
        [x.data_ptr() + 4 * i * x.shape[1], out.data_ptr() + 4 * i * x.shape[1], x.shape[1]]
        for x, out in zip(xs, outs)
        for i in range(x.shape[0])
    ]
    rows_t = torch.tensor(rows, dtype=torch.int64).to(dev)
    lib = build()
    with torch.cuda.device(dev):
        rc = lib.w2s_ema_normalize(
            rows_t.data_ptr(), params_t.data_ptr(), len(rows), float(min_sigma * min_sigma),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f'ema_normalize launch failed: error {rc} over {len(rows)} rows')
    LAUNCHES += 1
    return outs


def ema_normalize_host(
    x_T: np.ndarray,
    sampling_freq: float,
    tau_seconds: float = 900.0,
    baseline_tau_seconds: float | None = None,
    outlier_threshold_sigma: float = NORM_OUTLIER_THRESHOLD,
    min_sigma: float = CAUSAL_NORM_MIN_SIGMA,
    eps: float = 1e-6,
) -> np.ndarray:
    """One row through the native host library's recurrence (f64 per
    sample, f32 out), with the JAX package's host warm-up statistics."""
    x = np.ascontiguousarray(x_T, np.float32)
    if x.ndim != 1 or not len(x):
        raise ValueError(f'ema_normalize_host: expected a non-empty 1-D row, got shape {x.shape}')
    min_ss = min_sigma * min_sigma
    warm = x[: warmup_length(len(x), sampling_freq, tau_seconds, baseline_tau_seconds)]
    ab, av = _rates(sampling_freq, tau_seconds, baseline_tau_seconds)
    out = np.empty_like(x)
    native.build().w2s_ema_normalize_f32(
        x, len(x), ab, av, float(np.mean(warm)), max(float(np.var(warm)), min_ss),
        outlier_threshold_sigma, min_ss, eps, out, None,
    )
    return out


def _warmup_stats(signal: np.ndarray, sampling_freq: float, tau_seconds: float,
                  baseline_tau_seconds: float | None, min_sigma_sq: float) -> tuple[float, float, float, float]:
    """(alpha_b, alpha_v, mu_init, sigma_sq_init) of a row, as the JAX
    package's host normalization computes them."""
    ab, av = _rates(sampling_freq, tau_seconds, baseline_tau_seconds)
    warm = signal[: warmup_length(len(signal), sampling_freq, tau_seconds, baseline_tau_seconds)]
    return ab, av, float(np.mean(warm)), max(float(np.var(warm)), min_sigma_sq)


def _ema_stats_numpy(signal, alpha_b, alpha_v, mu_init, sigma_sq_init, threshold_sigma, min_sigma_sq, eps):
    """The recurrence as a Python loop in f64: (mu, sigma_sq, outlier)."""
    n = len(signal)
    mu = np.empty(n, dtype=np.float64)
    sigma_sq = np.empty(n, dtype=np.float64)
    outlier = np.zeros(n, dtype=bool)
    mu[0] = mu_init
    sigma_sq[0] = max(sigma_sq_init, min_sigma_sq, eps)
    for t in range(1, n):
        mu[t] = alpha_b * signal[t] + (1.0 - alpha_b) * mu[t - 1]
        residual = signal[t] - mu[t]
        threshold = threshold_sigma * np.sqrt(max(sigma_sq[t - 1], min_sigma_sq))
        if abs(residual) > threshold:
            outlier[t] = True
            residual = threshold if residual > 0 else -threshold
        sigma_sq[t] = alpha_v * residual * residual + (1.0 - alpha_v) * sigma_sq[t - 1]
    return mu, sigma_sq, outlier


def causal_rolling_normalize(
    signal: np.ndarray,
    sampling_freq: float,
    tau_seconds: float = 900.0,
    eps: float = 1e-6,
    outlier_threshold_sigma: float = NORM_OUTLIER_THRESHOLD,
    return_outlier_mask: bool = False,
    baseline_tau_seconds: float | None = None,
    min_sigma: float = CAUSAL_NORM_MIN_SIGMA,
    backend: str = 'auto',
):
    """Causal EMA z-score of a 1-D numpy row, ``(x - mu_t) / sqrt(max(
    sigma_sq_t, min_sigma**2))`` with the recurrence in f64; returns f64
    (and the outlier mask with ``return_outlier_mask``). ``backend`` is
    'auto' (the native library where it builds, else the loop), 'cpp' or
    'numpy'."""
    x = np.asarray(signal)
    if x.ndim != 1:
        raise ValueError(f'Expected 1-D signal, got shape {x.shape}')
    if not len(x):
        return (signal, np.zeros(0, dtype=bool)) if return_outlier_mask else signal
    min_ss = min_sigma * min_sigma
    args = (*_warmup_stats(x, sampling_freq, tau_seconds, baseline_tau_seconds, min_ss),
            outlier_threshold_sigma, min_ss, eps)
    x64 = np.ascontiguousarray(x, dtype=np.float64)
    lib = native.get_lib() if backend in ('auto', 'cpp') else None
    if backend == 'cpp' and lib is None:
        raise RuntimeError('C++ backend requested but native library unavailable.')
    if lib is not None:
        mu, sigma_sq, outlier = np.empty(len(x)), np.empty(len(x)), np.zeros(len(x), np.uint8)
        lib.w2s_ema_stats(x64, len(x), *args, mu, sigma_sq, outlier)
        outlier = outlier.astype(bool)
    else:
        mu, sigma_sq, outlier = _ema_stats_numpy(x64, *args)
    normalized = (x - mu) / np.sqrt(np.maximum(sigma_sq, min_ss))
    return (normalized, outlier) if return_outlier_mask else normalized
