"""Streaming EDF -> hypnogram serving, on the card.

Port of ``wav2sleep_tpu/pipeline.py`` for two transports:

- **f32** (``StreamingPipeline``): the host decodes each night's channels
  onto the model grid as f32 rows (``NightDecoder``, native decode +
  resample); the device normalizes them (per-night z-score, or causal EMA
  through K3, ``ops/ema_norm.py``) and runs the model
  (``make_streaming_forward``). This is the streaming / real-time serving
  mode.
- **q8** (``StreamingPipelineQ8``): the host extracts mu-law int8 codes plus
  per-row metadata (``Q8NightExtractor``); the device expands them, applies
  the affine, masks, z-scores and runs the model
  (``make_streaming_forward_q8``).

Both fill pooled, pinned host buffers, copy them to the device without
blocking, and overlap host decode with device compute: a producer thread
fills and launches batch ``k + 1`` while the consumer fetches batch ``k``.
"""

from __future__ import annotations

import ctypes
import logging
import math
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from . import native
from .data.edf import EdfFile, channel_norm_affine, get_column_match, units_map_first
from .data.preprocessing import resample_uniform, signal_target_grid
from .ops.ema_norm import ema_normalize
from .settings import (
    CAUSAL_NORM_BASELINE_TAU_SECONDS,
    CAUSAL_NORM_TAU_SECONDS,
    COLS_TO_SAMPLES_PER_EPOCH,
    EPOCH_SECONDS,
)
from .utils import resolve_device, stop_aware_put

logger = logging.getLogger(__name__)

MU_LAW = 255.0
# Per-(night, signal) row metadata, as written by Q8NightExtractor.
Q8_META_DTYPE = np.dtype(
    [('a', 'f4'), ('b', 'f4'), ('vmax', 'f4'), ('n_valid', 'i4'), ('n_pad', 'i4'), ('present', '?')]
)


def grid_length(col: str, max_length_hours: float) -> int:
    """Samples of ``col``'s model grid for ``max_length_hours``."""
    return len(signal_target_grid(col, max_length_hours))


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
                actual = get_column_match(col, labels, units_map=units_map, raise_error=False)
                if actual is None:
                    dst.fill(-np.inf)
                    continue
                ch = f.channel(actual)
                if ch.samples_per_record <= 0 or f.header.n_records <= 0:
                    # A salvaged or empty channel carries no samples: missing.
                    dst.fill(-np.inf)
                    continue
                _, scale, offset = channel_norm_affine(col, ch.unit, ch.physical_min, ch.physical_max)
                fs = f.sampling_freq(actual)
                if self._lib is not None and dst.flags.c_contiguous:
                    grid = self._grids[col]
                    records = f._records  # [n_records, stride] int16 memmap
                    self._lib.w2s_decode_resample(
                        records, f.header.n_records, records.shape[1], int(f._offsets[ch.index]),
                        ch.samples_per_record, float(ch.digital_min), float(ch.bitvalue),
                        float(ch.physical_min), float(scale), float(offset), float(fs), grid, len(grid), dst,
                    )
                else:
                    raw = f.read_physical(actual, dtype=np.float32, out=self._raw_buffer(f.n_samples(actual)))
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
                actual = get_column_match(col, labels, units_map=units_map, raise_error=False)
                ch = None if actual is None else f.channel(actual)
                if ch is None or ch.samples_per_record <= 0 or f.header.n_records <= 0:
                    # No match, or a salvaged / empty channel: missing.
                    dst.fill(0)
                    m[row] = (0.0, 0.0, 1.0, 0, 0, False)
                    continue
                fs = f.sampling_freq(actual)
                _, scale, offset = channel_norm_affine(col, ch.unit, ch.physical_min, ch.physical_max)
                a = ch.bitvalue * scale
                b = (ch.physical_min - ch.digital_min * ch.bitvalue) * scale + offset
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
        lo = f._offsets[ch.index]
        dig = np.ascontiguousarray(f._records[:, lo : lo + ch.samples_per_record]).reshape(-1).astype(np.float64)
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
    dtype = torch.bfloat16 if precision == 'bfloat16' else torch.float32

    @torch.inference_mode()
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

    return forward


def make_streaming_forward_q8(model: torch.nn.Module, precision: str = 'bfloat16', output: str = 'argmax') -> Callable:
    """Device forward over mu-law int8 rows: expand, affine, mask, z-score,
    model, then argmax (int32 [B, S]) or f32 logits ([B, S, K]).

    Arguments of the returned function are dicts keyed by signal: codes
    int8 [B, T] and the metadata fields a, b, vmax, n_valid, n_pad, present
    as [B] tensors, all on the model's device.
    """
    dtype = torch.bfloat16 if precision == 'bfloat16' else torch.float32
    scale = math.log1p(MU_LAW) / 127.0

    @torch.inference_mode()
    def forward(q, a, b, vmax, n_valid, n_pad, present):
        x = {}
        for col, r in q.items():
            qf = r.float()
            dig = torch.sign(qf) * torch.expm1(qf.abs() * scale) * (vmax[col][:, None] / MU_LAW)
            v = dig * a[col][:, None] + b[col][:, None]
            iot = torch.arange(r.shape[1], dtype=torch.int32, device=r.device)[None, :]
            v = torch.where(iot < n_valid[col][:, None], v, 0.0)
            z = _masked_zscore(v, iot < n_pad[col][:, None], dtype)
            x[col] = torch.where(present[col][:, None], z, -torch.inf)
        return _model_output(model(x), output)

    return forward


class _Slot:
    """One pooled batch buffer: a [batch, T] row per signal (pinned on
    CUDA) with numpy views for the host side, optional per-row metadata,
    and the event that marks the end of the last host-to-device copy out
    of it."""

    def __init__(self, lengths: dict[str, int], batch_size: int, dtype: torch.dtype, pin: bool, meta_dtype=None):
        self.rows = {c: torch.zeros((batch_size, n), dtype=dtype, pin_memory=pin) for c, n in lengths.items()}
        self.rows_np = {c: t.numpy() for c, t in self.rows.items()}
        self.meta = {} if meta_dtype is None else {c: np.zeros(batch_size, dtype=meta_dtype) for c in lengths}
        self.copied: torch.cuda.Event | None = None

    def wait_free(self) -> None:
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None

    def dup_row(self, src: int, dst: int) -> None:
        for part in (self.rows_np, self.meta):
            for arr in part.values():
                arr[dst] = arr[src]

    def to_device(self, device: torch.device) -> dict[str, torch.Tensor]:
        """Non-blocking copy of every row to ``device``; the slot is free
        again once ``wait_free`` returns."""
        dev = {c: t.to(device, non_blocking=True) for c, t in self.rows.items()}
        if device.type == 'cuda':
            self.copied = torch.cuda.Event()
            self.copied.record()
        return dev


def _stream(fps: list[str], batch_size: int, slots: list[_Slot], fill_row: Callable,
            launch: Callable[[_Slot], torch.Tensor]) -> Iterator[tuple[str, np.ndarray]]:
    """Producer/consumer loop: the producer thread fills a slot per batch
    (``fill_row(slot, fp, row)`` returns the night's whole-epoch count; an
    unreadable night is logged and skipped), pads a short batch by repeating
    its last row and enqueues ``launch(slot)``; the consumer fetches each
    result and trims every hypnogram to its night's epochs. ``put`` gives up
    once the consumer has stopped, and the consumer joins the producer."""
    if not fps:
        return
    out_q: queue.Queue = queue.Queue(maxsize=max(len(slots) - 1, 1))
    stop = threading.Event()

    def producer():
        try:
            for k, start in enumerate(range(0, len(fps), batch_size)):
                if stop.is_set():
                    return
                slot = slots[k % len(slots)]
                slot.wait_free()
                good, counts = [], []
                for fp in fps[start : start + batch_size]:
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
                if not stop_aware_put(out_q, stop, ('ok', good, counts, launch(slot))):
                    return
            stop_aware_put(out_q, stop, ('done', None, None, None))
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            stop_aware_put(out_q, stop, ('err', e, None, None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            kind, chunk, counts, result = out_q.get()
            if kind == 'done':
                return
            if kind == 'err':
                raise chunk
            preds = result.cpu().numpy()
            for i, fp in enumerate(chunk):
                hyp = preds[i]
                yield fp, hyp[: min(int(counts[i]), len(hyp))]
    finally:
        stop.set()
        thread.join()  # bounded: stop_aware_put polls stop every 0.2 s


class StreamingPipeline:
    """EDF -> hypnogram serving over the f32 transport.

    ``NightDecoder`` fills pooled, pinned f32 rows on the host; the device
    normalizes (``normalize='zscore'``, ``'causal'`` or ``'none'``, see
    ``make_streaming_forward``) and runs the model. The model is moved to
    ``device`` (the card when None; raises without one) once, at
    construction, and keeps its parameters' dtype; ``precision='bfloat16'``
    makes the inputs, and so the encoders' convs, bf16. ``fill_seconds``
    adds up the host time spent decoding nights.
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
        self.signals = list(signals)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.model = model.to(device=self.device).eval()
        self.forward = make_streaming_forward(self.model, precision, normalize)
        self.decoder = decoder if decoder is not None else NightDecoder(self.signals, max_length_hours)
        lengths = {c: grid_length(c, max_length_hours) for c in self.signals}
        pin = self.device.type == 'cuda'
        # Two slots: the producer fills one while the other's batch runs.
        self._slots = [_Slot(lengths, batch_size, torch.float32, pin) for _ in range(2)]
        self.fill_seconds = 0.0

    def _launch(self, slot: _Slot) -> torch.Tensor:
        return self.forward(slot.to_device(self.device))

    def _fill(self, slot: _Slot, fp: str, row: int) -> int:
        t0 = time.perf_counter()
        try:
            return self.decoder.decode_into(fp, {c: slot.rows_np[c][row] for c in self.signals})
        finally:
            self.fill_seconds += time.perf_counter() - t0

    def warmup(self) -> None:
        """One forward on the pooled buffers (builds kernels, warms caches)."""
        slot = self._slots[0]
        for c in self.signals:
            slot.rows_np[c].fill(0.0)
        self._launch(slot).cpu()

    def run(self, fps: list[str]) -> Iterator[tuple[str, np.ndarray]]:
        """Yield ``(fp, hypnogram)`` per readable night, in order."""
        return _stream(fps, self.batch_size, self._slots, self._fill, self._launch)


class StreamingPipelineQ8:
    """EDF -> hypnogram serving over the q8 transport.

    The model is moved to ``device`` (the card when None; raises without
    one) once, at construction, and keeps its parameters' dtype. As in the
    JAX package, ``precision='bfloat16'`` makes the inputs, and so the
    encoders' convs, bf16; the encoders' output layers promote back to f32
    parameters. ``extractor`` defaults to ``Q8NightExtractor``; any object
    with its ``extract_into(fp, out_i8, meta, row)`` interface will do.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        signals: list[str],
        batch_size: int = 8,
        max_length_hours: float = 10.0,
        precision: str = 'bfloat16',
        device: torch.device | str | None = None,
        extractor=None,
    ):
        self.signals = list(signals)
        self.batch_size = batch_size
        self.max_length_hours = max_length_hours
        self.device = resolve_device(device)
        self.model = model.to(device=self.device).eval()
        self.forward = make_streaming_forward_q8(self.model, precision)
        self.extractor = extractor if extractor is not None else Q8NightExtractor(self.signals, max_length_hours)
        lengths = {c: grid_length(c, max_length_hours) for c in self.signals}
        pin = self.device.type == 'cuda'
        # Two slots: the producer fills one while the other's batch runs.
        self._slots = [_Slot(lengths, batch_size, torch.int8, pin, Q8_META_DTYPE) for _ in range(2)]

    def _launch(self, slot: _Slot) -> torch.Tensor:
        q = slot.to_device(self.device)
        fields = [
            {
                c: torch.from_numpy(slot.meta[c][name].astype(Q8_META_DTYPE[name])).to(self.device)
                for c in self.signals
            }
            for name in Q8_META_DTYPE.names
        ]
        return self.forward(q, *fields)

    def warmup(self) -> None:
        """One forward on the pooled buffers (builds kernels, warms caches)."""
        slot = self._slots[0]
        for c in self.signals:
            slot.meta[c]['n_valid'] = 1
            slot.meta[c]['n_pad'] = 1
            slot.meta[c]['vmax'] = 1.0
        self._launch(slot).cpu()

    def run(self, fps: list[str]) -> Iterator[tuple[str, np.ndarray]]:
        """Yield ``(fp, hypnogram)`` per readable night, in order."""
        return _stream(
            fps,
            self.batch_size,
            self._slots,
            lambda slot, fp, row: self.extractor.extract_into(fp, slot.rows_np, slot.meta, row),
            self._launch,
        )
