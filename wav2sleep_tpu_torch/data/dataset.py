"""Per-night parquet dataset -> numpy batches.

The port's counterpart of ``wav2sleep_tpu/data/dataset.py``, with the same
semantics and, item for item, the same bits:

- one item = one night; each column without its NaNs, as float32, the rows
  first put in time order where the JAX package wrote them out of it
  (``parquet.read_layout``; here the port departs from the JAX package's
  items, ROADMAP §C.19);
- all present signals agree on the recording length (in 30 s epochs);
- truncation to ``max_length_hours``;
- per-recording z-score (eps 1e-6, ``ddof=1``) or causal EMA normalization;
- missing columns filled with ``-inf`` at the signal's length;
- 5-class labels mapped through ``INTEGER_LABEL_MAPS``, unscored -> -1.

The JAX package reads a pandas frame; here ``data.parquet.read_columns``
gives the columns as numpy arrays (nulls as NaN), and the frame's
``dropna``, ``map`` and ``fillna`` are numpy on them. Batching
(``collate``, ``batch_iterator``) stacks nights into fixed-shape arrays; the
trainer moves them to the card.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .. import native
from ..ops.ema_norm import causal_rolling_normalize, ema_normalize_host
from ..settings import (
    CAUSAL_NORM_BASELINE_TAU_SECONDS,
    CAUSAL_NORM_MIN_SIGMA,
    CAUSAL_NORM_TAU_SECONDS,
    COLS_TO_SAMPLES_PER_EPOCH,
    IGNORE_LABEL,
    INTEGER_LABEL_MAPS,
    LABEL,
    NORM_OUTLIER_THRESHOLD,
)
from ..utils import stop_aware_put
from .parquet import read_columns, read_layout

logger = logging.getLogger(__name__)

NightItem = tuple[Dict[str, np.ndarray], np.ndarray]

_CAUSAL = dict(tau_seconds=CAUSAL_NORM_TAU_SECONDS, outlier_threshold_sigma=NORM_OUTLIER_THRESHOLD,
               baseline_tau_seconds=CAUSAL_NORM_BASELINE_TAU_SECONDS, min_sigma=CAUSAL_NORM_MIN_SIGMA)


def zscore_normalize(signals: Dict[str, np.ndarray], eps: float = 1e-6) -> Dict[str, np.ndarray]:
    """Global per-recording z-score; empty or non-finite signals pass as they are."""
    out: Dict[str, np.ndarray] = {}
    for k, x in signals.items():
        if x.size == 0 or not np.isfinite(x).all():
            out[k] = x
            continue
        mu = np.mean(x)
        std = np.std(x, ddof=1) if x.size > 1 else 0.0
        std = std if std > eps else eps
        out[k] = ((x - mu) / std).astype(x.dtype)
    return out


def causal_normalize(signals: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Causal EMA normalization per signal, in f64 per sample: f32 input
    through the native fused entry (``ema_normalize_host``), anything else,
    or f32 where the native library cannot be built, through
    ``causal_rolling_normalize`` and a cast back to the input's dtype."""
    out: Dict[str, np.ndarray] = {}
    for k, x in signals.items():
        if x.size == 0 or not np.isfinite(x).all():
            out[k] = x
            continue
        if k not in COLS_TO_SAMPLES_PER_EPOCH:
            logger.warning(f'Unknown signal {k}, skipping causal normalization')
            out[k] = x
            continue
        fs = COLS_TO_SAMPLES_PER_EPOCH[k] / 30.0
        if x.dtype == np.float32 and native.get_lib() is not None:
            out[k] = ema_normalize_host(x, fs, **_CAUSAL)
        else:
            out[k] = np.asarray(causal_rolling_normalize(x, fs, **_CAUSAL), dtype=x.dtype)
    return out


def map_labels(stage: np.ndarray, label_map: dict[int, int]) -> np.ndarray:
    """The scored stages of a night (NaN dropped) mapped through
    ``label_map``, stages outside it as ``IGNORE_LABEL``; float32."""
    stage = np.asarray(stage, dtype=np.float64)
    stage = stage[~np.isnan(stage)]
    out = np.full(stage.shape, IGNORE_LABEL, dtype=np.float32)
    for raw, label in label_map.items():
        out[stage == raw] = label
    return out


class ParquetDataset:
    """Map-style dataset over per-night parquet files."""

    def __init__(
        self,
        parquet_fps: list[str],
        columns: list[str],
        num_classes: int = 4,
        require_labels: bool = True,
        max_length_hours: float | None = None,
        causal: bool = False,
    ):
        self.files = list(parquet_fps)
        self.columns = list(columns)
        for col in self.columns:
            if col not in COLS_TO_SAMPLES_PER_EPOCH:
                raise ValueError(f'Column {col} unrecognised.')
        self.map = INTEGER_LABEL_MAPS[num_classes]
        self.num_classes = num_classes
        self.require_labels = require_labels
        # Fractional hours are allowed (short recordings in tests).
        self.max_length_epochs = 1_000_000 if max_length_hours is None else int(round(max_length_hours * 60 * 2))
        self.causal = causal
        # The columns to read, and whether the rows need sorting by time,
        # probed once per file from its footer.
        self._want_cols: Dict[str, tuple[list, bool]] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _wanted(self, fp: str) -> tuple[list[str], bool]:
        """The requested columns (and the label) that ``fp`` holds, empty,
        which reads every column, when the footer cannot be read; and whether
        its rows must be sorted by the stored index (a JAX-written file with
        a finer grid after a coarser one, ``parquet.read_layout``)."""
        want = self._want_cols.get(fp)
        if want is None:
            try:
                avail, time_order = read_layout(fp)
                cols = [c for c in self.columns if c in avail]
                if LABEL in avail:
                    cols.append(LABEL)
                want = cols, time_order
            except Exception:  # noqa: BLE001 - a footer flake: the full read retries
                want = [], False
            self._want_cols[fp] = want
        return want

    def __getitem__(self, idx: int) -> NightItem:
        fp = self.files[idx]
        want, time_order = self._wanted(fp)
        cols = read_columns(fp, want or None, time_order=time_order)
        signal_dict: Dict[str, np.ndarray] = {}
        cols_to_pad: list[str] = []
        recording_epochs: int | None = None
        for col in self.columns:
            if col in cols:
                x = cols[col]
                x = x[~np.isnan(x)].astype(np.float32)
                if np.isinf(x).any():
                    raise ValueError(f'{fp=} has inf. values for {col=}')
                epochs = x.shape[0] // COLS_TO_SAMPLES_PER_EPOCH[col]
                if recording_epochs is None:
                    recording_epochs = epochs
                elif recording_epochs != epochs:
                    raise ValueError(
                        f'Signals disagree on recording length: {recording_epochs} != {epochs} epochs for {fp=}'
                    )
                keep = COLS_TO_SAMPLES_PER_EPOCH[col] * min(epochs, self.max_length_epochs)
                signal_dict[col] = x[:keep]
            else:
                cols_to_pad.append(col)
        if recording_epochs is None:
            raise ValueError(f'No relevant columns found in {fp=}. {self.columns=}')
        signal_dict = causal_normalize(signal_dict) if self.causal else zscore_normalize(signal_dict)
        kept_epochs = min(recording_epochs, self.max_length_epochs)
        for col in cols_to_pad:
            signal_dict[col] = np.full((COLS_TO_SAMPLES_PER_EPOCH[col] * kept_epochs,), -np.inf, dtype=np.float32)
        if self.require_labels or LABEL in cols:
            if LABEL not in cols:
                raise KeyError(LABEL)
            labels = map_labels(cols[LABEL], self.map)
            if labels.shape[0] != recording_epochs:
                raise ValueError(f'{labels.shape=} != {recording_epochs=} for {fp=}')
            labels = labels[: self.max_length_epochs]
        else:
            labels = np.full((kept_epochs,), IGNORE_LABEL, dtype=np.float32)
        return signal_dict, labels


def collate(items: list[NightItem]) -> tuple[Dict[str, np.ndarray], np.ndarray]:
    """Stack nights into fixed-shape batch arrays (the nights of a batch share
    one epoch count)."""
    signals = {k: np.stack([item[0][k] for item in items]) for k in items[0][0]}
    labels = np.stack([item[1] for item in items])
    return signals, labels


def pad_or_truncate_item(item: NightItem, target_epochs: int) -> NightItem:
    """Pad (zeros for a signal, -1 for labels) or truncate a night to
    ``target_epochs``, so ragged nights share one batch shape. A missing
    (``-inf``) or empty signal pads with ``-inf``."""
    signals, labels = item
    out_signals = {}
    for col, x in signals.items():
        target = COLS_TO_SAMPLES_PER_EPOCH[col] * target_epochs
        if x.shape[0] >= target:
            out_signals[col] = x[:target]
        else:
            pad_value = -np.inf if (x.size == 0 or np.isinf(x[:1]).any()) else 0.0
            out = np.full((target,), pad_value, dtype=x.dtype)
            out[: x.shape[0]] = x
            out_signals[col] = out
    if labels.shape[0] >= target_epochs:
        out_labels = labels[:target_epochs]
    else:
        out_labels = np.full((target_epochs,), IGNORE_LABEL, dtype=labels.dtype)
        out_labels[: labels.shape[0]] = labels
    return out_signals, out_labels


def batch_iterator(
    dataset: ParquetDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    num_threads: int = 2,
    pad_to_epochs: int | None = None,
    prefetch: int = 2,
    block: tuple[int, int] | None = None,
) -> Iterator[tuple[Dict[str, np.ndarray], np.ndarray]]:
    """Batches of ``dataset`` in order (shuffled by ``seed`` with
    ``shuffle``), loaded by ``num_threads`` threads (pyarrow reads release
    the GIL) at most ``num_threads + prefetch`` batches ahead of the
    consumer; serial with ``num_threads <= 1``.

    ``block=(i, n)`` yields block ``i`` of ``n`` equal row blocks of each
    batch, and reads only its nights: each batch is first padded to
    ``batch_size`` rounded up to a multiple of ``n`` by repeating its nights
    from the first, with every label of a repeated row -1 (the trainer's
    padding of a short batch, ``Trainer._pad_batch``). A rank of a
    data-parallel group reads its rows of the global batch so."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    batches = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch_size]
    if block is not None:
        i, n = block
        rows = -(-batch_size // n)
        pad = [np.arange(rows * n) >= len(b) for b in batches]
        batches = [np.concatenate([b, b[np.arange(rows * n - len(b)) % len(b)]]) for b in batches]
        batches = [(b[i * rows : (i + 1) * rows], p[i * rows : (i + 1) * rows]) for b, p in zip(batches, pad)]
    else:
        batches = [(b, None) for b in batches]

    def load_batch(idxs_pad) -> tuple[Dict[str, np.ndarray], np.ndarray]:
        idxs, pad = idxs_pad
        items = [dataset[int(i)] for i in idxs]
        if pad_to_epochs is not None:
            items = [pad_or_truncate_item(it, pad_to_epochs) for it in items]
        x, y = collate(items)
        if pad is not None and pad.any():
            y[pad] = IGNORE_LABEL
        return x, y

    if num_threads <= 1:
        for idxs in batches:
            yield load_batch(idxs)
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        # A sliding window of submitted batches: submitting every batch up
        # front would let the workers run an epoch ahead of the consumer
        # (the queue bounds only dequeued batches, not finished futures).
        window = max(num_threads + prefetch, 1)
        pending: deque = deque()
        it = iter(batches)
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            try:
                while not stop.is_set():
                    while len(pending) < window:
                        idxs = next(it, None)
                        if idxs is None:
                            break
                        pending.append(pool.submit(load_batch, idxs))
                    if not pending:
                        stop_aware_put(q, stop, ('done', None))
                        return
                    fut = pending.popleft()
                    try:
                        item = ('ok', fut.result())
                    except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                        stop_aware_put(q, stop, ('err', e))
                        return
                    if not stop_aware_put(q, stop, item):
                        return
            finally:
                for fut in pending:
                    fut.cancel()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == 'done':
                return
            if kind == 'err':
                raise payload
            yield payload
    finally:
        stop.set()
