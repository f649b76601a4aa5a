"""Streaming EDF -> hypnogram serving over the mu-law int8 ("q8") transport.

Port of the q8 path of ``wav2sleep_tpu/pipeline.py``. The host extracts each
night's channels onto the model grid as mu-law int8 codes plus per-row
metadata (``Q8NightExtractor`` of the JAX package, shared as it is, or any
object with its ``extract_into(fp, out_i8, meta, row)`` interface) into
pooled, pinned host buffers; the codes go to the device with non-blocking
copies, and the device expands them, applies the affine, masks, z-scores and
runs the model (``make_streaming_forward_q8``). A producer thread fills and
launches batch ``k + 1`` while the consumer fetches batch ``k``.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from wav2sleep_tpu.settings import COLS_TO_SAMPLES_PER_EPOCH
from wav2sleep_tpu.utils import stop_aware_put

logger = logging.getLogger(__name__)

MU_LAW = 255.0
# Per-(night, signal) row metadata, as written by Q8NightExtractor.
Q8_META_DTYPE = np.dtype(
    [('a', 'f4'), ('b', 'f4'), ('vmax', 'f4'), ('n_valid', 'i4'), ('n_pad', 'i4'), ('present', '?')]
)


def grid_length(col: str, max_length_hours: float) -> int:
    """Samples of ``col``'s model grid for ``max_length_hours`` (the length
    of the JAX package's ``signal_target_grid``)."""
    step = 30.0 / COLS_TO_SAMPLES_PER_EPOCH[col]
    return len(np.arange(0, max_length_hours * 60 * 60 + 1e-9, step)) - 1


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
        logits = model(x)
        if output == 'logits':
            return logits.float()
        return logits.argmax(dim=-1).to(torch.int32)

    return forward


class _Slot:
    """One pooled batch buffer: int8 codes per signal (pinned on CUDA) with
    numpy views for the extractor, metadata rows, and the event that marks
    the end of the last host-to-device copy out of it."""

    def __init__(self, signals, batch_size: int, lengths: dict[str, int], pin: bool):
        self.codes = {
            c: torch.zeros((batch_size, lengths[c]), dtype=torch.int8, pin_memory=pin) for c in signals
        }
        self.codes_np = {c: t.numpy() for c, t in self.codes.items()}
        self.meta = {c: np.zeros(batch_size, dtype=Q8_META_DTYPE) for c in signals}
        self.copied: torch.cuda.Event | None = None

    def wait_free(self) -> None:
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None

    def dup_row(self, src: int, dst: int) -> None:
        for c in self.codes_np:
            self.codes_np[c][dst] = self.codes_np[c][src]
            self.meta[c][dst] = self.meta[c][src]


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


class StreamingPipelineQ8:
    """EDF -> hypnogram serving over the q8 transport.

    The model is moved to ``device`` (default: where its parameters are)
    once, at construction, and keeps its parameters' dtype. As in the JAX
    package, ``precision='bfloat16'`` makes the inputs, and so the encoders'
    convs, bf16; the encoders' output layers promote back to f32 parameters.
    ``extractor`` defaults to the JAX package's native ``Q8NightExtractor``
    (which needs pandas).
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
        self.device = torch.device(device) if device is not None else next(model.parameters()).device
        self.model = model.to(device=self.device).eval()
        self.forward = make_streaming_forward_q8(self.model, precision)
        if extractor is None:
            from wav2sleep_tpu.pipeline import Q8NightExtractor

            extractor = Q8NightExtractor(self.signals, max_length_hours)
        self.extractor = extractor
        lengths = {c: grid_length(c, max_length_hours) for c in self.signals}
        pin = self.device.type == 'cuda'
        # Two slots: the producer fills one while the other's batch runs.
        self._slots = [_Slot(self.signals, batch_size, lengths, pin) for _ in range(2)]

    def _launch(self, slot: _Slot) -> torch.Tensor:
        q = {c: slot.codes[c].to(self.device, non_blocking=True) for c in self.signals}
        if self.device.type == 'cuda':
            slot.copied = torch.cuda.Event()
            slot.copied.record()
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
            lambda slot, fp, row: self.extractor.extract_into(fp, slot.codes_np, slot.meta, row),
            self._launch,
        )
