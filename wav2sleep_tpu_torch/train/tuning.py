"""Batch-size tuning (the Lightning Tuner's power scaling).

The port's counterpart of ``wav2sleep_tpu/train/tuning.py``: probe doubling
batch sizes with one real training step each, on zero-filled nights, until
the card runs out of memory, and return the last size that fitted.
"""

from __future__ import annotations

import copy
import gc
import logging

import torch
from torch import nn

from ..settings import COLS_TO_SAMPLES_PER_EPOCH
from ..utils import resolve_device
from . import step as step_mod

logger = logging.getLogger(__name__)


def _probe(model: nn.Module, columns, num_classes, epochs_per_night, b, family, ema, grad_accum, device) -> None:
    """One training step at batch ``b`` on a copy of ``model`` (its weights
    stay as they were), with the persistent state the real step carries."""
    probe_model = copy.deepcopy(model).to(device)
    opt = step_mod.make_optimizer(1e-3, accumulate_steps=2 if grad_accum else 1)
    state = step_mod.init_train_state(probe_model, opt, ema=ema)
    x = {c: torch.zeros((b, COLS_TO_SAMPLES_PER_EPOCH[c] * epochs_per_night), device=device) for c in columns}
    y = torch.zeros((b, epochs_per_night), device=device)
    step = step_mod.make_train_step(probe_model, opt, num_classes, flip_polarity=False, family=family,
                                    **({'ema_decay': 0.999} if ema else {}))
    _, metrics = step(state, (x, y), 0)
    float(metrics['loss'])  # waits for the step


def tune_batch_size(
    model: nn.Module,
    columns: list[str],
    num_classes: int = 4,
    epochs_per_night: int = 1200,
    start: int = 4,
    max_batch: int = 512,
    family: str = 'wav2sleep',
    ema: bool = False,
    grad_accum: bool = False,
    device: torch.device | str | None = None,
) -> int:
    """The largest power of two from ``start`` up to ``max_batch`` whose
    training step fits on ``device`` (the card when None; raises without
    one); 0 when ``start`` does not fit.

    The probe carries the parameter-sized state of the real step, or a size
    that just fits the probe runs out on the first real step:
    ``grad_accum=True`` adds the accumulation buffers (their size does not
    depend on the count, which is chosen after tuning) and ``ema=True`` the
    in-graph EMA. The offloaded EMA's snapshots live in pinned host memory,
    not on the card, so they need nothing here. Polarity flip and the masker
    keep no state and are left off.

    Only ``torch.cuda.OutOfMemoryError`` ends the search; any other error
    propagates. After it, the probe's tensors are freed and the allocator's
    cache emptied, so what runs next starts clean."""
    device = resolve_device(device)
    best, b = 0, start
    while b <= max_batch:
        oom = False
        try:
            _probe(model, columns, num_classes, epochs_per_night, b, family, ema, grad_accum, device)
        except torch.cuda.OutOfMemoryError:
            oom = True  # the exception (and the frames it holds) dies with this block
        gc.collect()
        torch.cuda.empty_cache()
        if oom:
            logger.info(f'batch {b}: out of memory; settling on {best}.')
            break
        logger.info(f'batch {b}: OK')
        best = b
        b *= 2
    return best
