"""Streaming EDF -> hypnogram serving, on the card.

Port of ``wav2sleep_tpu/pipeline.py``, every transport. The host turns each
night into rows of its transport; the device decodes them, normalizes and
runs the model:

- **f32** (``StreamingPipeline``): the host decodes each night's channels
  onto the model grid as f32 rows (``NightDecoder``, native decode +
  resample); the device normalizes them (per-night z-score, or causal EMA
  through K3, ``ops/ema_norm.py``) and runs the model
  (``make_streaming_forward``). This is the streaming / real-time serving
  mode.
- **q16** (``StreamingPipelineQ16``, the serving default): int16 digital
  codes resampled onto the model grid (``Q16NightExtractor``), within
  0.5 LSB of the EDF's own quantization; the device applies the affine,
  masks and z-scores (``make_streaming_forward_q16``).
- **q8** (``StreamingPipelineQ8``): mu-law int8 codes plus per-row metadata
  (``Q8NightExtractor``); the device expands them first
  (``make_streaming_forward_q8``).
- **q4** (``StreamingPipelineQ4``): packed 4-bit block-DPCM codes
  (``Q4NightExtractor``); the device unpacks them and decodes with one
  cumsum (``make_streaming_forward_q4``).
- **raw** (``StreamingPipelineRaw``): the EDF's int16 channels as they are
  (``RawNightExtractor``); the device applies the affine and resamples by
  gather at anchor-precise positions (``make_streaming_forward_raw``).

All fill pooled, pinned host buffers, copy them to the device without
blocking, and overlap host decode with device compute: a producer thread
fills and launches batch ``k + 1`` while the consumer fetches batch ``k``.
A ``precision='float32'`` forward runs every conv and matmul in full f32
(no TF32).

Data-parallel serving (``devices=[...]`` on q16, q8 and q4, the JAX
pipelines' ``mesh``): each device holds a replica of the weights; a batch's
rows go to the devices in contiguous blocks, each block's copy and forward
run on a stream of its own device, and the argmax is gathered in row order.
A slot's per-device copy events all complete before the slot is reused.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import logging
import math
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from . import native, tracing
from .data.edf import EdfFile, channel_norm_affine, get_column_match, read_edf_header, units_map_first
from .data.preprocessing import resample_uniform, signal_target_grid
from .ops.ema_norm import ema_normalize
from .settings import (
    CAUSAL_NORM_BASELINE_TAU_SECONDS,
    CAUSAL_NORM_TAU_SECONDS,
    COLS_TO_SAMPLES_PER_EPOCH,
    EPOCH_SECONDS,
)
from .utils import full_f32, resolve_device, stop_aware_put

logger = logging.getLogger(__name__)

MU_LAW = 255.0
# Per-(night, signal) row metadata of each transport, as its extractor
# writes it. The device forward takes the fields as operands in this order.
Q16_META_DTYPE = np.dtype([('a', 'f4'), ('b', 'f4'), ('n_valid', 'i4'), ('n_pad', 'i4'), ('present', '?')])
Q8_META_DTYPE = np.dtype(
    [('a', 'f4'), ('b', 'f4'), ('vmax', 'f4'), ('n_valid', 'i4'), ('n_pad', 'i4'), ('present', '?')]
)
# Raw rows: n is the raw sample count; n_pad, as in every transport, the
# night's whole-epoch grid length (the z-score and the -inf padding are
# epoch-granular).
META_DTYPE = np.dtype([('a', 'f4'), ('b', 'f4'), ('fs', 'f8'), ('n', 'i4'), ('n_pad', 'i4'), ('present', '?')])

ANCHOR_K = 4096  # Grid points per anchor block of the raw transport's resampler.
RAW_BUCKET = 65536  # Raw row lengths are rounded up to a multiple of this.

Q4_BLOCK = 64
# Scale index e (uint8) of the q4 transport decodes to 2^(e/16). The table
# is computed once, in f64, and handed to the native encoder as data, so
# the C++ and numpy encoders pick scales from the same values (a last-ulp
# difference of libm's exp2 at a threshold would fork their codes).
_EXP8_SCALE = np.exp2(np.arange(256, dtype=np.float64) / 16.0)


def grid_length(col: str, max_length_hours: float) -> int:
    """Samples of ``col``'s model grid for ``max_length_hours``."""
    return len(signal_target_grid(col, max_length_hours))


def q4_row_len(n: int) -> int:
    """Bytes of an n-sample q4 row: packed 4-bit codes, then one uint8
    scale exponent per ``Q4_BLOCK`` samples."""
    return (n + 1) // 2 + (n + Q4_BLOCK - 1) // Q4_BLOCK


def _row_affine(col: str, ch) -> tuple[float, float]:
    """``(a, b)`` with ``a * digital + b`` the normalized physical value."""
    _, scale, offset = channel_norm_affine(col, ch.unit, ch.physical_min, ch.physical_max)
    return ch.bitvalue * scale, (ch.physical_min - ch.digital_min * ch.bitvalue) * scale + offset


def _usable_channel(f: EdfFile, col: str, labels, units_map):
    """The EDF channel serving ``col``, or None when there is none or it
    carries no samples (a salvaged or empty channel): missing."""
    actual = get_column_match(col, labels, units_map=units_map, raise_error=False)
    ch = None if actual is None else f.channel(actual)
    if ch is None or ch.samples_per_record <= 0 or f.header.n_records <= 0:
        return None
    return ch


class NightDecoder:
    """EDF -> f32 model-grid rows, single-threaded.

    Uses the native fused decode + resample (strided int16 gather, affine
    and lerp off the memmap in one pass) when the native host library is
    available, numpy otherwise.
    """

    def __init__(self, signals: list[str], max_length_hours: float = 10.0, use_native: bool = True):
        self.signals = list(signals)
        self.max_length_hours = max_length_hours
        self._raw_scratch = np.empty(0, np.float32)
        self._lib = native.get_lib() if use_native else None
        self._grids = {
            col: np.ascontiguousarray(signal_target_grid(col, max_length_hours), dtype=np.float64)
            for col in self.signals
        }

    def _raw_buffer(self, n: int) -> np.ndarray:
        # One growing scratch buffer, sliced per request, so a sweep over
        # nights of many lengths keeps one buffer.
        if self._raw_scratch.size < n:
            self._raw_scratch = np.empty(n, dtype=np.float32)
        return self._raw_scratch[:n]

    def decode_into(self, fp: str, out: dict[str, np.ndarray]) -> int:
        """Decode + resample each signal of one night into the caller's rows
        ``out[col]``. A missing signal is all ``-inf``, and so is the grid
        past the night's last whole epoch (the padding the model's
        missing-data masking and the masked z-score expect). Returns the
        night's whole-epoch count."""
        with EdfFile(fp) as f:
            n_epochs = int(f.header.duration_seconds // EPOCH_SECONDS)
            labels = f.labels()
            units_map = units_map_first(f.header)
            for col in self.signals:
                dst = out[col]
                ch = _usable_channel(f, col, labels, units_map)
                if ch is None:
                    dst.fill(-np.inf)
                    continue
                _, scale, offset = channel_norm_affine(col, ch.unit, ch.physical_min, ch.physical_max)
                fs = f.sampling_freq(ch.label)
                if self._lib is not None and dst.flags.c_contiguous:
                    grid = self._grids[col]
                    records = f._records  # [n_records, stride] int16 memmap
                    self._lib.w2s_decode_resample(
                        records, f.header.n_records, records.shape[1], int(f._offsets[ch.index]),
                        ch.samples_per_record, float(ch.digital_min), float(ch.bitvalue),
                        float(ch.physical_min), float(scale), float(offset), float(fs), grid, len(grid), dst,
                    )
                else:
                    raw = f.read_physical(ch.label, dtype=np.float32, out=self._raw_buffer(f.n_samples(ch.label)))
                    if scale != 1.0:
                        raw *= np.float32(scale)
                    if offset != 0.0:
                        raw += np.float32(offset)
                    resample_uniform(raw, fs, col, self.max_length_hours, out=dst)
                # Zero-filled samples inside the night's epochs stay data;
                # whole epochs past the night are padding.
                pad_from = n_epochs * COLS_TO_SAMPLES_PER_EPOCH[col]
                if pad_from < len(dst):
                    dst[pad_from:] = -np.inf
        return n_epochs


def _resample_digital_f64(dig: np.ndarray, ratio: float, m: int) -> tuple[np.ndarray, int]:
    """numpy mirror of the native kernels' double-precision lerp, so the
    fallback's codes equal the native path's bit for bit."""
    n = len(dig)
    pos = (np.arange(m, dtype=np.float64) + 1.0) * ratio
    n_valid = int(np.searchsorted(pos, n - 1, side='right'))
    i0 = np.floor(pos[:n_valid]).astype(np.int64)
    frac = pos[:n_valid] - i0
    v0 = dig[i0]
    v1 = dig[np.minimum(i0 + 1, n - 1)]
    out = np.zeros(m, np.float64)
    out[:n_valid] = v0 + frac * (v1 - v0)
    return out, n_valid


def _digital_samples(f: EdfFile, ch) -> np.ndarray:
    """One channel's int16 samples, contiguous, as f64."""
    lo = f._offsets[ch.index]
    return np.ascontiguousarray(f._records[:, lo : lo + ch.samples_per_record]).reshape(-1).astype(np.float64)


class Q16NightExtractor:
    """EDF -> int16 digital codes on the model grid plus per-row metadata.

    Each channel is lerped onto the grid in the digital (int16) domain and
    rounded back to int16 (at most 0.5 LSB, the EDF's own quantization);
    the device applies the row's affine ``a, b``.
    """

    def __init__(self, signals: list[str], max_length_hours: float = 10.0, use_native: bool = True):
        self.signals = list(signals)
        self.max_length_hours = max_length_hours
        self._lib = native.get_lib() if use_native else None
        self._step = {col: EPOCH_SECONDS / COLS_TO_SAMPLES_PER_EPOCH[col] for col in self.signals}

    def extract_into(self, fp: str, out_i16: dict[str, np.ndarray], meta: dict[str, np.ndarray], row: int) -> int:
        """Fill row ``row`` of ``out_i16[col]`` and ``meta[col]`` for one
        night; returns its whole-epoch count."""
        with EdfFile(fp) as f:
            n_epochs = int(f.header.duration_seconds // EPOCH_SECONDS)
            labels = f.labels()
            units_map = units_map_first(f.header)
            for col in self.signals:
                m = meta[col]
                dst = out_i16[col][row]
                ch = _usable_channel(f, col, labels, units_map)
                if ch is None:
                    dst.fill(0)
                    m[row] = (0.0, 0.0, 0, 0, False)
                    continue
                fs = f.sampling_freq(ch.label)
                a, b = _row_affine(col, ch)
                if self._lib is not None and dst.flags.c_contiguous:
                    n_valid = self._lib.w2s_resample_q16(
                        f._records, f.header.n_records, f._records.shape[1], int(f._offsets[ch.index]),
                        ch.samples_per_record, float(fs), float(self._step[col]), len(dst), dst,
                    )
                else:
                    res, n_valid = _resample_digital_f64(_digital_samples(f, ch), self._step[col] * fs, len(dst))
                    dst[:] = np.rint(res).astype(np.int16)
                m[row] = (a, b, n_valid, n_epochs * COLS_TO_SAMPLES_PER_EPOCH[col], True)
            return n_epochs


class Q8NightExtractor:
    """EDF -> mu-law int8 model-grid codes plus per-row metadata.

    Each channel is resampled onto the model grid in the digital (int16)
    domain and companded against its digital peak V (mu = 255); the device
    undoes both with the row's affine ``a, b`` and ``vmax``.
    """

    def __init__(self, signals: list[str], max_length_hours: float = 10.0, use_native: bool = True):
        self.signals = list(signals)
        self.max_length_hours = max_length_hours
        self._lib = native.get_lib() if use_native else None
        self._step = {col: EPOCH_SECONDS / COLS_TO_SAMPLES_PER_EPOCH[col] for col in self.signals}
        self._vmax_out = ctypes.c_double(0.0)

    def extract_into(self, fp: str, out_i8: dict[str, np.ndarray], meta: dict[str, np.ndarray], row: int) -> int:
        """Fill row ``row`` of ``out_i8[col]`` and ``meta[col]`` for one
        night; returns its whole-epoch count."""
        with EdfFile(fp) as f:
            n_epochs = int(f.header.duration_seconds // EPOCH_SECONDS)
            labels = f.labels()
            units_map = units_map_first(f.header)
            for col in self.signals:
                m = meta[col]
                dst = out_i8[col][row]
                ch = _usable_channel(f, col, labels, units_map)
                if ch is None:
                    dst.fill(0)
                    m[row] = (0.0, 0.0, 1.0, 0, 0, False)
                    continue
                fs = f.sampling_freq(ch.label)
                a, b = _row_affine(col, ch)
                n_valid, vmax = self._quantize_channel(f, ch, fs, col, dst)
                m[row] = (a, b, vmax, n_valid, n_epochs * COLS_TO_SAMPLES_PER_EPOCH[col], True)
            return n_epochs

    def _quantize_channel(self, f, ch, fs: float, col: str, dst: np.ndarray) -> tuple[int, float]:
        """Resample one channel in the digital domain and mu-law quantize it
        into ``dst``; returns (n_valid, digital peak)."""
        if self._lib is not None and dst.flags.c_contiguous:
            n_valid = self._lib.w2s_resample_q8(
                f._records, f.header.n_records, f._records.shape[1], int(f._offsets[ch.index]),
                ch.samples_per_record, float(fs), float(self._step[col]), len(dst), dst,
                ctypes.byref(self._vmax_out),
            )
            return n_valid, self._vmax_out.value
        dig = _digital_samples(f, ch)
        vmax = max(1.0, float(np.abs(dig).max()))
        res, n_valid = _resample_digital_f64(dig, self._step[col] * fs, len(dst))
        # As the native kernel: round the lerp to a digital value, then
        # mu-law quantize that.
        d = np.rint(res)
        x = np.clip(np.abs(d) / vmax, 0.0, 1.0)
        q = np.rint(127.0 * np.log1p(MU_LAW * x) / np.log1p(MU_LAW))
        dst[:] = (np.sign(d) * q).astype(np.int8)
        dst[n_valid:] = 0
        return n_valid, vmax


class Q4NightExtractor(Q8NightExtractor):
    """EDF -> packed 4-bit block-DPCM codes plus q8's per-row metadata.

    Each channel is resampled onto the model grid in the digital domain and
    rounded (as q16). Per block of ``Q4_BLOCK`` samples, with anchor A the
    reconstruction of the previous block's last sample (0 at the start):
    the scale s = 2^(e/16) is the smallest table entry >= max(largest
    step / 6, |x_0 - A| / 6.5); each sample quantizes against the anchor,
    c_j = rint((x_j - A) / s), and the codes are first differences
    k_0 = c_0, k_j = c_j - c_{j-1}, which the scale rule bounds by 7, so
    they fit a sign-magnitude nibble. The device decodes with one cumsum of
    k * s.

    Row layout: ceil(n/2) code bytes (sample 2i in the low nibble), then
    ceil(n/Q4_BLOCK) scale-exponent bytes (``q4_row_len``). ``n_valid`` and
    ``n_pad`` count unpacked samples; ``vmax`` keeps the digital peak, which
    the decode does not use. The numpy fallback loops over blocks and gives
    the native encoder's codes bit for bit.
    """

    def __init__(
        self,
        signals: list[str],
        n_grid: dict[str, int],
        max_length_hours: float = 10.0,
        use_native: bool = True,
    ):
        super().__init__(signals, max_length_hours, use_native=use_native)
        self._n_grid = dict(n_grid)
        self._exp8 = np.ascontiguousarray(_EXP8_SCALE)
        # The fallback's nibble row, padded to even length so the pack
        # never reads a half byte that was not written.
        self._snib = {c: np.zeros(self._n_grid[c] + (self._n_grid[c] & 1), np.uint8) for c in self.signals}

    def _quantize_channel(self, f, ch, fs: float, col: str, dst: np.ndarray) -> tuple[int, float]:
        n = self._n_grid[col]
        K = Q4_BLOCK
        if self._lib is not None and dst.flags.c_contiguous:
            n_valid = self._lib.w2s_resample_dpcm4(
                f._records, f.header.n_records, f._records.shape[1], int(f._offsets[ch.index]),
                ch.samples_per_record, float(fs), float(self._step[col]), n, K, self._exp8, dst,
                ctypes.byref(self._vmax_out),
            )
            return n_valid, self._vmax_out.value
        dig = _digital_samples(f, ch)
        vmax = max(1.0, float(np.abs(dig).max()))
        res, n_valid = _resample_digital_f64(dig, self._step[col] * fs, n)
        x = np.rint(res[:n_valid])
        mp = (n + 1) // 2
        nib = self._snib[col]
        nib.fill(0)
        dst[mp:] = 0
        A = 0.0
        for bi in range((n_valid + K - 1) // K):
            row = x[bi * K : min((bi + 1) * K, n_valid)]
            pk = float(np.abs(np.diff(row)).max()) if row.size > 1 else 0.0
            need = max(pk / 6.0, abs(float(row[0]) - A) / 6.5)
            e = min(int(np.searchsorted(_EXP8_SCALE, need, side='left')), 255)
            s = _EXP8_SCALE[e]
            c = np.rint((row - A) / s)
            k = np.diff(c, prepend=0.0).astype(np.int64)
            nib[bi * K : bi * K + row.size] = np.where(k < 0, 0x8 | (-k), k).astype(np.uint8)
            dst[mp + bi] = e
            A += float(c[-1]) * s
        np.left_shift(nib[1::2], 4, out=dst[:mp])
        np.bitwise_or(dst[:mp], nib[0::2], out=dst[:mp])
        return n_valid, vmax


class RawNightExtractor:
    """EDF -> each channel's int16 samples as they are, plus metadata.

    The affine, the resampling and the z-score all run on the device.
    """

    def __init__(self, signals: list[str]):
        self.signals = list(signals)

    def probe_bucket(self, fp: str) -> dict[str, int]:
        """Raw row length per signal from one file's header, rounded up to
        a multiple of ``RAW_BUCKET`` so files of slightly different lengths
        share one shape."""
        h = read_edf_header(fp)
        labels = [c.label for c in h.channels]
        units = {c.label: c.unit for c in h.channels}
        bucket = {}
        for col in self.signals:
            actual = get_column_match(col, labels, units_map=units, raise_error=False)
            if actual is None:
                bucket[col] = RAW_BUCKET
                continue
            ch = next(c for c in h.channels if c.label == actual)
            n = ch.samples_per_record * h.n_records
            bucket[col] = max(1, -(-n // RAW_BUCKET)) * RAW_BUCKET
        return bucket

    def extract_into(self, fp: str, out_i16: dict[str, np.ndarray], meta: dict[str, np.ndarray], row: int) -> int:
        """Fill ``out_i16[col][row]`` and the metadata row (``META_DTYPE``);
        returns the night's whole-epoch count."""
        with EdfFile(fp) as f:
            n_epochs = int(f.header.duration_seconds // EPOCH_SECONDS)
            labels = f.labels()
            units_map = units_map_first(f.header)
            for col in self.signals:
                m = meta[col]
                ch = _usable_channel(f, col, labels, units_map)
                if ch is None:
                    m[row] = (0.0, 0.0, 1.0, 0, 0, False)
                    continue
                cap = out_i16[col].shape[1]
                # A file longer than the row keeps its first whole records
                # (the copy below works in records).
                n = min(f.n_samples(ch.label), cap - cap % ch.samples_per_record)
                lo = f._offsets[ch.index]
                dst = out_i16[col][row, :n].reshape(-1, ch.samples_per_record)
                np.copyto(dst, f._records[: dst.shape[0], lo : lo + ch.samples_per_record])
                a, b = _row_affine(col, ch)
                m[row] = (a, b, f.sampling_freq(ch.label), n, n_epochs * COLS_TO_SAMPLES_PER_EPOCH[col], True)
            return n_epochs


def compute_resample_anchors(fs: float, step: float, n_grid: int):
    """Block anchors of the raw transport's device resampler.

    Grid point j reads source position ``(j + 1) * step * fs``. f32 cannot
    hold sub-sample fractions at million-sample positions, so the host splits
    the start position of each block of ``ANCHOR_K`` points into an integer
    and a fraction in f64; the device adds ``offset * ratio`` (below
    ``ANCHOR_K * ratio``, exact enough in f32) to the fraction. Returns
    ``(base_int int32 [nb], base_frac f32 [nb], ratio f32)``.
    """
    nb = int(np.ceil(n_grid / ANCHOR_K))
    ratio = step * fs
    starts = (np.arange(nb, dtype=np.float64) * ANCHOR_K + 1.0) * ratio
    base_int = np.floor(starts).astype(np.int32)
    base_frac = (starts - np.floor(starts)).astype(np.float32)
    return base_int, base_frac, np.float32(ratio)


def _serving_forward(fn: Callable, precision: str) -> Callable:
    """``fn`` under inference mode, and in full f32 for ``precision='float32'``."""
    f32 = precision != 'bfloat16'

    @functools.wraps(fn)
    @torch.inference_mode()
    def forward(*args):
        with full_f32() if f32 else contextlib.nullcontext():
            return fn(*args)

    return forward


def _input_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == 'bfloat16' else torch.float32


def _masked_zscore(v: torch.Tensor, valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-row z-score (ddof 1, eps 1e-6) over the ``valid`` grid points, with
    everything else set to the ``-inf`` padding sentinel. ``v`` must already
    be zero outside the data region."""
    cnt = valid.sum(dim=1, keepdim=True, dtype=torch.float32)
    mu = v.sum(dim=1, keepdim=True) / cnt.clamp_min(1.0)
    centered = torch.where(valid, v - mu, 0.0)
    std = torch.sqrt(centered.square().sum(dim=1, keepdim=True) / (cnt - 1.0).clamp_min(1.0))
    z = ((v - mu) / std.clamp_min(1e-6)).to(dtype)
    return torch.where(valid, z, torch.tensor(-torch.inf, dtype=dtype, device=z.device))


def _grid_input(v: torch.Tensor, n_valid, n_pad, present, dtype: torch.dtype) -> torch.Tensor:
    """Model input from decoded grid rows ``v``: zero past ``n_valid``, the
    masked z-score over the night's whole epochs (``n_pad``), and ``-inf``
    for an absent signal."""
    iot = torch.arange(v.shape[1], dtype=torch.int32, device=v.device)[None, :]
    v = torch.where(iot < n_valid[:, None], v, 0.0)
    z = _masked_zscore(v, iot < n_pad[:, None], dtype)
    return torch.where(present[:, None], z, -torch.inf)


def _model_output(logits: torch.Tensor, output: str) -> torch.Tensor:
    if output == 'logits':
        return logits.float()
    return logits.argmax(dim=-1).to(torch.int32)


def make_streaming_forward(
    model: torch.nn.Module, precision: str = 'bfloat16', normalize: str = 'zscore', output: str = 'argmax'
) -> Callable:
    """Device forward over f32 model-grid rows: normalize, model, then
    argmax (int32 [B, S]) or f32 logits ([B, S, K]).

    ``normalize='zscore'``: per-row z-score (ddof 1, eps 1e-6) over the real
    samples only. ``'causal'``: causal EMA normalization (K3), one launch
    over all modalities, with ``-inf`` set to 0 on the way in. ``'none'``:
    the rows are already normalized. ``-inf`` samples (a missing channel,
    the grid past a short night) come out as ``-inf`` for the model's
    missing-data masking. The returned function takes a dict of f32 [B, T]
    rows keyed by signal, on the model's device.
    """
    if normalize not in ('zscore', 'causal', 'none'):
        raise ValueError(f"normalize must be 'zscore', 'causal' or 'none', got {normalize!r}")
    dtype = _input_dtype(precision)

    def forward(x: dict[str, torch.Tensor]) -> torch.Tensor:
        cols = list(x)
        if normalize == 'none':
            return _model_output(model({c: x[c].to(dtype) for c in cols}), output)
        finite = [torch.isfinite(x[c]) for c in cols]
        safe = [torch.where(m, x[c], 0.0) for c, m in zip(cols, finite)]
        if normalize == 'zscore':
            z = [_masked_zscore(v, m, dtype) for v, m in zip(safe, finite)]
        else:
            normed = ema_normalize(
                safe,
                [COLS_TO_SAMPLES_PER_EPOCH[c] / EPOCH_SECONDS for c in cols],
                tau_seconds=CAUSAL_NORM_TAU_SECONDS,
                baseline_tau_seconds=CAUSAL_NORM_BASELINE_TAU_SECONDS,
            )
            z = [torch.where(m, v, -torch.inf).to(dtype) for v, m in zip(normed, finite)]
        return _model_output(model(dict(zip(cols, z))), output)

    return _serving_forward(forward, precision)


def make_streaming_forward_q16(model: torch.nn.Module, precision: str = 'bfloat16', output: str = 'argmax') -> Callable:
    """Device forward over int16 grid codes: affine, mask, z-score, model,
    then argmax (int32 [B, S]) or f32 logits ([B, S, K]).

    Arguments of the returned function are dicts keyed by signal: codes
    int16 [B, T] and the ``Q16_META_DTYPE`` fields as [B] tensors, in that
    order, all on the model's device.
    """
    dtype = _input_dtype(precision)

    def forward(q, a, b, n_valid, n_pad, present):
        x = {}
        for col, r in q.items():
            v = r.float() * a[col][:, None] + b[col][:, None]
            x[col] = _grid_input(v, n_valid[col], n_pad[col], present[col], dtype)
        return _model_output(model(x), output)

    return _serving_forward(forward, precision)


def make_streaming_forward_q8(model: torch.nn.Module, precision: str = 'bfloat16', output: str = 'argmax') -> Callable:
    """Device forward over mu-law int8 rows: expand, affine, mask, z-score,
    model, then argmax (int32 [B, S]) or f32 logits ([B, S, K]).

    Arguments of the returned function are dicts keyed by signal: codes
    int8 [B, T] and the ``Q8_META_DTYPE`` fields a, b, vmax, n_valid, n_pad,
    present as [B] tensors, all on the model's device.
    """
    dtype = _input_dtype(precision)
    scale = math.log1p(MU_LAW) / 127.0

    def forward(q, a, b, vmax, n_valid, n_pad, present):
        x = {}
        for col, r in q.items():
            qf = r.float()
            dig = torch.sign(qf) * torch.expm1(qf.abs() * scale) * (vmax[col][:, None] / MU_LAW)
            v = dig * a[col][:, None] + b[col][:, None]
            x[col] = _grid_input(v, n_valid[col], n_pad[col], present[col], dtype)
        return _model_output(model(x), output)

    return _serving_forward(forward, precision)


def make_streaming_forward_q4(
    model: torch.nn.Module,
    n_grid: dict[str, int],
    precision: str = 'bfloat16',
    output: str = 'argmax',
) -> Callable:
    """Device forward over packed 4-bit block-DPCM rows: nibble unpack,
    sign-magnitude codes, per-block scale 2^(e/16), one cumsum, affine,
    mask, z-score, model, then argmax or f32 logits.

    Takes uint8 rows of ``q4_row_len(n_grid[col])`` bytes and the
    ``Q8_META_DTYPE`` fields, as ``make_streaming_forward_q8``.
    """
    dtype = _input_dtype(precision)

    def forward(q, a, b, vmax, n_valid, n_pad, present):
        x = {}
        for col, r in q.items():
            B, n = r.shape[0], n_grid[col]
            mp, nbk = (n + 1) // 2, (n + Q4_BLOCK - 1) // Q4_BLOCK
            p = r[:, :mp].to(torch.int32)
            nib = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(B, -1)[:, :n]
            k = ((1 - 2 * (nib >> 3)) * (nib & 7)).float()
            s = torch.exp2(r[:, mp : mp + nbk].float() / 16.0)
            step = s[:, :, None].expand(B, nbk, Q4_BLOCK).reshape(B, nbk * Q4_BLOCK)[:, :n]
            dig = torch.cumsum(k * step, dim=-1)
            v = dig * a[col][:, None] + b[col][:, None]
            x[col] = _grid_input(v, n_valid[col], n_pad[col], present[col], dtype)
        return _model_output(model(x), output)

    return _serving_forward(forward, precision)


def make_streaming_forward_raw(
    model: torch.nn.Module, n_grid: dict[str, int], precision: str = 'bfloat16', output: str = 'argmax'
) -> Callable:
    """Device forward over raw int16 channels: affine, linear resample onto
    the model grid by gather at anchor-precise positions
    (``compute_resample_anchors``), mask, z-score, model, then argmax or f32
    logits.

    Arguments of the returned function are dicts keyed by signal: raw int16
    rows [B, L], a and b [B], the anchors base_int int32 [B, nb], base_frac
    f32 [B, nb] and ratio f32 [B], then n, n_pad and present [B].
    """
    dtype = _input_dtype(precision)

    def forward(raw, a, b, base_int, base_frac, ratio, n, n_pad, present):
        x = {}
        for col, r in raw.items():
            B, Tg, nb = r.shape[0], n_grid[col], base_int[col].shape[1]
            v = r.float() * a[col][:, None] + b[col][:, None]
            off = torch.arange(ANCHOR_K, dtype=torch.float32, device=r.device)
            # po stays below ANCHOR_K * ratio: exact enough in f32.
            po = off[None, None, :] * ratio[col][:, None, None] + base_frac[col][:, :, None]
            po_floor = torch.floor(po)
            idx = (base_int[col][:, :, None] + po_floor.to(torch.int32)).reshape(B, nb * ANCHOR_K)[:, :Tg]
            frac = (po - po_floor).reshape(B, nb * ANCHOR_K)[:, :Tg]
            last = n[col][:, None] - 1
            invalid = (idx < 0) | (idx > last) | ((idx == last) & (frac > 0))
            # Clamped below at 0 too, for a row with no samples (n = 0):
            # its reads are masked out.
            idx0 = torch.minimum(idx, last).clamp_min(0)
            idx1 = torch.minimum(idx0 + 1, last).clamp_min(0)
            s0 = torch.gather(v, 1, idx0.long())
            s1 = torch.gather(v, 1, idx1.long())
            s = torch.where(invalid, 0.0, s0 + frac * (s1 - s0))
            iot = torch.arange(Tg, dtype=torch.int32, device=r.device)[None, :]
            z = _masked_zscore(s, iot < n_pad[col][:, None], dtype)
            x[col] = torch.where(present[col][:, None], z, -torch.inf)
        return _model_output(model(x), output)

    return _serving_forward(forward, precision)


class _Slot:
    """One pooled batch buffer: a [batch, T] row per signal (pinned on
    CUDA) with numpy views for the host side, optional per-row metadata,
    and the event that marks the end of the last host-to-device copy out
    of it."""

    def __init__(self, lengths: dict[str, int], batch_size: int, dtype: torch.dtype, pin: bool, meta_dtype=None):
        self.rows = {c: torch.zeros((batch_size, n), dtype=dtype, pin_memory=pin) for c, n in lengths.items()}
        self.rows_np = {c: t.numpy() for c, t in self.rows.items()}
        self.meta = {} if meta_dtype is None else {c: np.zeros(batch_size, dtype=meta_dtype) for c in lengths}
        self.copied: list[torch.cuda.Event] = []  # one per device copy in flight

    def wait_free(self) -> None:
        for event in self.copied:
            event.synchronize()
        self.copied.clear()

    def dup_row(self, src: int, dst: int) -> None:
        for part in (self.rows_np, self.meta):
            for arr in part.values():
                arr[dst] = arr[src]

    def to_device(self, device: torch.device, rows: slice = slice(None)) -> dict[str, torch.Tensor]:
        """Non-blocking copy of ``rows`` of every signal to ``device``, on the
        current stream; the slot is free again once ``wait_free`` returns."""
        dev = {c: t[rows].to(device, non_blocking=True) for c, t in self.rows.items()}
        if device.type == 'cuda':
            event = torch.cuda.Event()
            event.record()
            self.copied.append(event)
        return dev

    def meta_fields(self, names, device: torch.device, rows: slice = slice(None)) -> list[dict[str, torch.Tensor]]:
        """Per metadata field in ``names``, a dict of tensors of ``rows`` on
        ``device`` keyed by signal."""
        return [{c: torch.from_numpy(m[name][rows].copy()).to(device) for c, m in self.meta.items()}
                for name in names]


def _stream(fps: list[str], batch_size: int, get_slots: Callable[[], list[_Slot]], fill_row: Callable,
            launch: Callable[[_Slot], torch.Tensor],
            ensure: Callable[[str], None] | None = None) -> Iterator[tuple[str, np.ndarray]]:
    """Producer/consumer loop: the producer thread takes each batch's nights
    (``ensure(fp)``, where given, readies the slots for a night first),
    fills a slot (``fill_row(slot, fp, row)`` returns the night's
    whole-epoch count; a night that fails either step is logged and
    skipped), pads a short batch by repeating its last row and enqueues
    ``launch(slot)``; the consumer fetches each result and trims every
    hypnogram to its night's epochs. ``put`` gives up once the consumer has
    stopped, and the consumer joins the producer. Each part runs in a
    program span (``tracing``; ``pipeline/*``), recorded while the recorder
    is on or torch's profiler records on the consumer's thread."""
    if not fps:
        return
    # Two slots: the producer fills one while the other's batch runs.
    out_q: queue.Queue = queue.Queue(maxsize=1)
    stop = threading.Event()

    def producer():
        try:
            used = 0
            for start in range(0, len(fps), batch_size):
                if stop.is_set():
                    return
                chunk = []
                for fp in fps[start : start + batch_size]:
                    try:
                        if ensure is not None:
                            ensure(fp)
                    except Exception:  # noqa: BLE001 - one bad night must not end the run
                        logger.warning(f'Skipping unreadable night {fp}', exc_info=True)
                        continue
                    chunk.append(fp)
                if not chunk:
                    continue
                slots = get_slots()
                slot = slots[used % len(slots)]
                used += 1
                with tracing.span('pipeline/slot_wait'):
                    slot.wait_free()
                good, counts = [], []
                for fp in chunk:
                    try:
                        n_epochs = fill_row(slot, fp, len(good))
                    except Exception:  # noqa: BLE001 - one bad night must not end the run
                        logger.warning(f'Skipping unreadable night {fp}', exc_info=True)
                        continue
                    good.append(fp)
                    counts.append(n_epochs)
                if not good:
                    continue
                for i in range(len(good), batch_size):
                    slot.dup_row(len(good) - 1, i)
                with tracing.span('pipeline/launch'):
                    result = launch(slot)
                with tracing.span('pipeline/put'):
                    if not stop_aware_put(out_q, stop, ('ok', good, counts, result)):
                        return
            stop_aware_put(out_q, stop, ('done', None, None, None))
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            stop_aware_put(out_q, stop, ('err', e, None, None))

    with tracing.follow_profiler():
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with tracing.span('pipeline/result_wait'):
                    kind, chunk, counts, result = out_q.get()
                if kind == 'done':
                    return
                if kind == 'err':
                    raise chunk
                with tracing.span('pipeline/fetch'):
                    # One tensor, or a replica's block each (data-parallel serving).
                    preds = np.concatenate([r.cpu().numpy() for r in result]) if isinstance(result, list) \
                        else result.cpu().numpy()
                for i, fp in enumerate(chunk):
                    hyp = preds[i]
                    yield fp, hyp[: min(int(counts[i]), len(hyp))]
        finally:
            stop.set()
            thread.join()  # bounded: stop_aware_put polls stop every 0.2 s


class _Pipeline:
    """What every serving pipeline shares: the model, moved to ``device``
    (the card when None; raises without one) once, at construction, keeping
    its parameters' dtype; the pooled slots; and the producer/consumer
    loop. ``fill_seconds`` adds up the host time spent filling slots
    (decoding nights)."""

    _ensure: Callable[[str], None] | None = None

    def __init__(self, model: torch.nn.Module, signals: list[str], batch_size: int, max_length_hours: float,
                 device: torch.device | str | None):
        self.signals = list(signals)
        self.batch_size = batch_size
        self.max_length_hours = max_length_hours
        self.device = resolve_device(device)
        self.model = model.to(device=self.device).eval()
        self._pin = self.device.type == 'cuda'
        self._n_grid = {c: grid_length(c, max_length_hours) for c in self.signals}
        self._slots: list[_Slot] = []
        self.fill_seconds = 0.0

    def _fill(self, slot: _Slot, fp: str, row: int) -> int:
        raise NotImplementedError

    def _launch(self, slot: _Slot) -> torch.Tensor:
        raise NotImplementedError

    def _timed_fill(self, slot: _Slot, fp: str, row: int) -> int:
        t0 = time.perf_counter()
        try:
            with tracing.span('pipeline/fill'):
                return self._fill(slot, fp, row)
        finally:
            self.fill_seconds += time.perf_counter() - t0

    def run(self, fps: list[str]) -> Iterator[tuple[str, np.ndarray]]:
        """Yield ``(fp, hypnogram)`` per readable night, in order, each
        trimmed to the night's whole epochs."""
        return _stream(fps, self.batch_size, lambda: self._slots, self._timed_fill, self._launch, self._ensure)


class StreamingPipeline(_Pipeline):
    """EDF -> hypnogram serving over the f32 transport.

    ``NightDecoder`` fills pooled, pinned f32 rows on the host; the device
    normalizes (``normalize='zscore'``, ``'causal'`` or ``'none'``, see
    ``make_streaming_forward``) and runs the model. ``precision='bfloat16'``
    makes the inputs, and so the encoders' convs, bf16.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        signals: list[str],
        batch_size: int = 8,
        max_length_hours: float = 10.0,
        precision: str = 'bfloat16',
        normalize: str = 'zscore',
        device: torch.device | str | None = None,
        decoder: NightDecoder | None = None,
    ):
        super().__init__(model, signals, batch_size, max_length_hours, device)
        self.forward = make_streaming_forward(self.model, precision, normalize)
        self.decoder = decoder if decoder is not None else NightDecoder(self.signals, max_length_hours)
        self._slots = [_Slot(self._n_grid, batch_size, torch.float32, self._pin) for _ in range(2)]

    def _fill(self, slot: _Slot, fp: str, row: int) -> int:
        return self.decoder.decode_into(fp, {c: slot.rows_np[c][row] for c in self.signals})

    def _launch(self, slot: _Slot) -> torch.Tensor:
        with tracing.span('pipeline/h2d'):
            x = slot.to_device(self.device)
        with tracing.span('pipeline/enqueue'):
            return self.forward(x)

    def warmup(self) -> None:
        """One forward on the pooled buffers (builds kernels, warms caches)."""
        slot = self._slots[0]
        for c in self.signals:
            slot.rows_np[c].fill(0.0)
        self._launch(slot).cpu()


class StreamingPipelineQ16(_Pipeline):
    """EDF -> hypnogram serving over the q16 transport (lossless int16
    grid codes, ``Q16NightExtractor``), and the base of q8 and q4, which
    change the row dtype and length, the metadata, the extractor and the
    forward.

    As in the JAX package, ``precision='bfloat16'`` makes the inputs, and so
    the encoders' convs, bf16. ``extractor`` defaults to the transport's
    own; any object with its ``extract_into(fp, rows, meta, row)`` interface
    will do. ``devices`` serves each batch over a replica per device (the
    module docstring); ``batch_size`` must divide over them.
    """

    transport_dtype = torch.int16
    meta_dtype = Q16_META_DTYPE

    def __init__(
        self,
        model: torch.nn.Module,
        signals: list[str],
        batch_size: int = 8,
        max_length_hours: float = 10.0,
        precision: str = 'bfloat16',
        device: torch.device | str | None = None,
        extractor=None,
        devices: list | None = None,
    ):
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if batch_size % len(devices) != 0:
                raise ValueError(
                    f'batch_size={batch_size} must divide evenly over the data axis ({len(devices)})'
                )
            device = devices[0]
        super().__init__(model, signals, batch_size, max_length_hours, device)
        self.forward = self._make_forward(precision, self.model)
        # A replica of the weights on each device, each with its forward
        # and, over several cards, a stream of its own. The first is the
        # model itself, through ``self.forward``.
        devices = devices or [self.device]
        self._replicas = []
        for i, dev in enumerate(devices):
            forward = (lambda *a: self.forward(*a)) if i == 0 else \
                self._make_forward(precision, copy.deepcopy(self.model).to(dev).eval())
            stream = torch.cuda.Stream(device=dev) if len(devices) > 1 and dev.type == 'cuda' else None
            self._replicas.append((dev, forward, stream))
        self.extractor = extractor if extractor is not None else self._make_extractor()
        lengths = {c: self._transport_len(c) for c in self.signals}
        self._slots = [_Slot(lengths, batch_size, self.transport_dtype, self._pin, self.meta_dtype) for _ in range(2)]

    def _transport_len(self, col: str) -> int:
        return self._n_grid[col]

    def _make_forward(self, precision: str, model: torch.nn.Module) -> Callable:
        return make_streaming_forward_q16(model, precision)

    def _make_extractor(self):
        return Q16NightExtractor(self.signals, self.max_length_hours)

    def _fill(self, slot: _Slot, fp: str, row: int) -> int:
        return self.extractor.extract_into(fp, slot.rows_np, slot.meta, row)

    def _launch(self, slot: _Slot) -> list[torch.Tensor]:
        # The forward takes the metadata fields in the meta dtype's order.
        rows = self.batch_size // len(self._replicas)
        out = []
        for i, (dev, forward, stream) in enumerate(self._replicas):
            block = slice(i * rows, (i + 1) * rows)
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                with tracing.span('pipeline/h2d'):
                    q = slot.to_device(dev, block)
                with tracing.span('pipeline/meta_copy'):
                    meta = slot.meta_fields(self.meta_dtype.names, dev, block)
                with tracing.span('pipeline/enqueue'):
                    preds = forward(q, *meta)
            if stream is not None:
                # The consumer reads the block on the device's default stream.
                default = torch.cuda.default_stream(dev)
                default.wait_stream(stream)
                preds.record_stream(default)
            out.append(preds)
        return out

    def warmup(self) -> None:
        """One forward on the pooled buffers (builds kernels, warms caches)."""
        slot = self._slots[0]
        for m in slot.meta.values():
            m['n_valid'] = m['n_pad'] = 1
            if 'vmax' in m.dtype.names:
                m['vmax'] = 1.0
        for t in self._launch(slot):
            t.cpu()


class StreamingPipelineQ8(StreamingPipelineQ16):
    """EDF -> hypnogram serving over the q8 transport (mu-law int8 codes,
    ``Q8NightExtractor``)."""

    transport_dtype = torch.int8
    meta_dtype = Q8_META_DTYPE

    def _make_forward(self, precision: str, model: torch.nn.Module) -> Callable:
        return make_streaming_forward_q8(model, precision)

    def _make_extractor(self):
        return Q8NightExtractor(self.signals, self.max_length_hours)


class StreamingPipelineQ4(StreamingPipelineQ16):
    """EDF -> hypnogram serving over the q4 transport (packed 4-bit
    block-DPCM codes, ``Q4NightExtractor``): about half of q8's bytes."""

    transport_dtype = torch.uint8
    meta_dtype = Q8_META_DTYPE

    def _transport_len(self, col: str) -> int:
        return q4_row_len(self._n_grid[col])

    def _make_forward(self, precision: str, model: torch.nn.Module) -> Callable:
        return make_streaming_forward_q4(model, self._n_grid, precision)

    def _make_extractor(self):
        return Q4NightExtractor(self.signals, self._n_grid, self.max_length_hours)


class StreamingPipelineRaw(_Pipeline):
    """EDF -> hypnogram serving over the raw transport: the EDF's int16
    channels as they are (``RawNightExtractor``), resampled on the device.

    The rows' lengths come from the files' headers (``probe_bucket``); a
    night longer than the rows so far regrows them before it is filled.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        signals: list[str],
        batch_size: int = 8,
        max_length_hours: float = 10.0,
        precision: str = 'bfloat16',
        device: torch.device | str | None = None,
    ):
        super().__init__(model, signals, batch_size, max_length_hours, device)
        self._step = {c: EPOCH_SECONDS / COLS_TO_SAMPLES_PER_EPOCH[c] for c in self.signals}
        self.forward = make_streaming_forward_raw(self.model, self._n_grid, precision)
        self.extractor = RawNightExtractor(self.signals)
        self._bucket: dict[str, int] | None = None
        self._anchor_cache: dict = {}

    def _ensure(self, fp: str) -> None:
        bucket = self.extractor.probe_bucket(fp)
        if self._bucket is not None:
            if all(bucket[c] <= self._bucket[c] for c in self.signals):
                return
            bucket = {c: max(bucket[c], self._bucket[c]) for c in self.signals}
            logger.info(f'Raw rows regrown to {bucket}')
            # An old slot's pinned rows may still be the source of a
            # non-blocking copy: let it end before the slot is dropped.
            for slot in self._slots:
                slot.wait_free()
        self._bucket = bucket
        self._slots = [_Slot(bucket, self.batch_size, torch.int16, self._pin, META_DTYPE) for _ in range(2)]

    def _anchors(self, fs: float, col: str):
        key = (round(float(fs), 9), col)
        got = self._anchor_cache.get(key)
        if got is None:
            got = self._anchor_cache[key] = compute_resample_anchors(float(fs), self._step[col], self._n_grid[col])
        return got

    def _fill(self, slot: _Slot, fp: str, row: int) -> int:
        return self.extractor.extract_into(fp, slot.rows_np, slot.meta, row)

    def _launch(self, slot: _Slot) -> torch.Tensor:
        with tracing.span('pipeline/h2d'):
            raw = slot.to_device(self.device)
        with tracing.span('pipeline/meta_copy'):
            a, b = slot.meta_fields(('a', 'b'), self.device)
            base_int, base_frac, ratio = {}, {}, {}
            for c in self.signals:
                rows = [self._anchors(fs, c) for fs in slot.meta[c]['fs']]
                base_int[c] = torch.from_numpy(np.stack([r[0] for r in rows])).to(self.device)
                base_frac[c] = torch.from_numpy(np.stack([r[1] for r in rows])).to(self.device)
                ratio[c] = torch.from_numpy(np.asarray([r[2] for r in rows], np.float32)).to(self.device)
            n, n_pad, present = slot.meta_fields(('n', 'n_pad', 'present'), self.device)
        with tracing.span('pipeline/enqueue'):
            return self.forward(raw, a, b, base_int, base_frac, ratio, n, n_pad, present)

    def warmup(self, fp: str) -> None:
        """One forward on rows sized for ``fp`` (builds kernels, warms caches)."""
        self._ensure(fp)
        slot = self._slots[0]
        for m in slot.meta.values():
            m['n'] = m['n_pad'] = 1
            m['fs'] = 1.0
        self._launch(slot).cpu()
