"""Quantized input transports of the training step: mu-law int8 (q8) and
linear int16 (q16).

Port of ``wav2sleep_tpu/ops/q8_transport.py``. The host half encodes each
(night, signal) row against its own peak with numpy; the device half decodes
on the card, before the polarity flip and the modality dropout (mu-law is
odd-symmetric, so flipping the decode equals flipping before the encode).

Contract:
    peak  = max |x| over the row
    q8:   code = round(sign(x) * 127 * log(1 + 255 |x| / peak) / log(256))
          x_hat = sign(code) * peak * (256^(|code| / 127) - 1) / 255
    q16:  code = round(x / peak * 32767), x_hat = code * peak / 32767
A fully non-finite row (the ``-inf`` missing-modality sentinel) ships as
(codes 0, peak 0, present False) and decodes back to ``-inf``; a row that
mixes finite and non-finite samples is refused.

An encoded batch is ``{signal: (codes [B, T] int8 or int16, peak [B] f32,
present [B] bool)}``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_LOG256 = math.log(256.0)
_CODES = 127
_Q16_CODES = 32767
_MIXED = ('{} transport row mixes finite data with non-finite samples; '
          'the -inf sentinel is only supported for whole rows.')

# t-domain rounding boundaries 2**((k - 0.5) * 8 / 127), k = 1..127, in f32.
_THRESHOLDS = np.exp2((np.arange(1, _CODES + 1, dtype=np.float64) - 0.5) * 8.0 / _CODES).astype(np.float32)


def encode_row_numpy(x: np.ndarray, out: np.ndarray | None = None):
    """Encode one row to q8; returns (codes int8, peak f32, present bool).

    The rounding decision is an f32 threshold comparison on ``1 + 255 |x| /
    peak`` with one f32 divide for the scale, so the codes do not depend on
    a float64 log round trip.
    """
    x = np.asarray(x, np.float32)
    finite = np.isfinite(x)
    if out is None:
        out = np.empty(x.shape, np.int8)
    if not finite.any():
        out[:] = 0
        return out, np.float32(0.0), False
    if not finite.all():
        raise ValueError(_MIXED.format('q8'))
    peak = np.float32(np.abs(x).max())
    scale = np.float32(255.0) / (peak if peak > 0 else np.float32(1.0))
    t = (1.0 + np.minimum(np.abs(x) * scale, np.float32(255.0))).astype(np.float32)
    k = np.searchsorted(_THRESHOLDS, t, side='right').astype(np.int8)
    np.negative(k, out=out, where=np.signbit(x))
    np.copyto(out, k, where=~np.signbit(x))
    return out, np.float32(peak), True


def _slot_buffers(slot: dict, name: str, shape: tuple, code_dtype) -> tuple:
    """The pooled (codes, peaks, present) buffers of ``name`` in ``slot``,
    made or remade for ``shape``."""
    bufs = slot.get(name)
    if bufs is None or bufs[0].shape != shape:
        bufs = (np.empty(shape, code_dtype), np.empty((shape[0],), np.float32), np.empty((shape[0],), bool))
        slot[name] = bufs
    return bufs


def encode_batch(x: dict[str, np.ndarray], slot: dict | None = None) -> dict[str, tuple]:
    """q8-encode a host batch ``{signal: f32 [B, T]}`` row by row.

    ``slot`` is an optional dict of pooled output buffers, reused across
    calls (created or resized on demand); its arrays may be views of pinned
    tensors.
    """
    slot = {} if slot is None else slot
    out = {}
    for name, arr in x.items():
        arr = np.ascontiguousarray(arr, np.float32)
        codes, peaks, present = _slot_buffers(slot, name, arr.shape, np.int8)
        for b in range(arr.shape[0]):
            _, peaks[b], present[b] = encode_row_numpy(arr[b], out=codes[b])
        out[name] = (codes, peaks, present)
    return out


def encode_batch_q16(x: dict[str, np.ndarray], slot: dict | None = None) -> dict[str, tuple]:
    """Linear int16 encoding of a host batch, one vectorized pass per signal;
    the same contract and ``slot`` pooling as ``encode_batch``."""
    slot = {} if slot is None else slot
    out = {}
    for name, arr in x.items():
        arr = np.ascontiguousarray(arr, np.float32)
        codes, peaks, present = _slot_buffers(slot, name, arr.shape, np.int16)
        finite = np.isfinite(arr)
        row_all = finite.all(axis=1)
        if (finite.any(axis=1) & ~row_all).any():
            raise ValueError(_MIXED.format('q16'))
        np.copyto(present, row_all)
        f32s = np.abs(arr)
        peaks[:] = f32s.max(axis=1, where=finite, initial=np.float32(0.0))
        # f32 peak * (32767 / peak) can exceed 32767 by an ulp; clip so the
        # int16 cannot wrap to -32768.
        scale = np.float32(_Q16_CODES) / np.maximum(peaks, np.float32(1e-30))
        np.multiply(arr, scale[:, None], out=f32s)
        np.rint(f32s, out=f32s)
        np.clip(f32s, -_Q16_CODES, _Q16_CODES, out=f32s)
        f32s[~row_all] = 0.0
        codes[:] = f32s
        out[name] = (codes, peaks, present)
    return out


def dequant_q8(codes: torch.Tensor, peak: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Device-side mu-law decode to f32 [B, T]; missing rows decode to -inf."""
    c = codes.to(torch.float32)
    mag = torch.expm1(c.abs() * (_LOG256 / _CODES)) * (1.0 / 255.0)
    x = torch.sign(c) * mag * peak[:, None]
    return torch.where(present[:, None], x, -torch.inf)


def dequant_q16(codes: torch.Tensor, peak: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Device-side linear int16 decode to f32 [B, T]; -inf for missing rows."""
    x = codes.to(torch.float32) * (peak * (1.0 / _Q16_CODES))[:, None]
    return torch.where(present[:, None], x, -torch.inf)


def dequant_batch(x: dict) -> dict[str, torch.Tensor]:
    """Decode an encoded batch to ``{signal: f32 [B, T]}``: int8 codes are
    the mu-law rung, int16 the linear one."""
    return {k: (dequant_q8 if codes.dtype == torch.int8 else dequant_q16)(codes, peak, present)
            for k, (codes, peak, present) in x.items()}


def is_encoded_batch(x: dict) -> bool:
    return bool(x) and all(isinstance(v, tuple) and len(v) == 3 for v in x.values())
