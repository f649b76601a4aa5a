"""Training throughput of the flagship on one card.

    python -m wav2sleep_tpu_torch.train_bench [--batch 4] [--epochs-per-night 1200]
        [--feature-dim 128] [--precision bfloat16|float32] [--transport lossless|q8]
        [--k 5] [--reps 3] [--remat on|off] [--device cuda|cpu]

The port's sibling of ``scripts/train_bench.py``: the whole training step
(polarity flip, modality dropout, forward, backward, global-norm clip, AdamW,
weight EMA, confusion matrix) on full nights of the flagship cardio model
(ECG+PPG+ABD+THX, feature_dim 128, seeded random weights) with the cardio
masker, AdamW 1e-3 on the expdecay schedule (2000, 10000), weight decay
1e-4, clip 1.0 and EMA 0.9999 from step 2000; the encoders rematerialise
each block (``--remat on``, the training config's setting). Two numbers:

- compute: the marginal time of a step on operands resident on the device,
  between 1 and ``k`` chained steps, timed with CUDA events (median of
  ``reps``);
- e2e: each step's batch staged on the host into a ring of 4 pinned slots
  (a cast for lossless input, the numpy mu-law encoder for q8), copied
  without blocking, with a CUDA event per slot waited on before the slot is
  staged again.

Prints one JSON line: ms per step both ways, nights per hour of training,
peak device memory, K1/K2 launches per step and the card's name and power
limit. Runs on the card unless ``--device cpu`` is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .models.wav2sleep import build_wav2sleep, flagship_config
from .ops import conv_k3
from .ops.q8_transport import encode_batch
from .settings import COLS_TO_SAMPLES_PER_EPOCH
from .train.masker import SignalMasker
from .train.scheduler import exp_warmup_schedule
from .train.step import TrainState, init_train_state, make_optimizer, make_train_step
from .utils import card_line, resolve_device

SIGNALS = ('ABD', 'THX', 'ECG', 'PPG')
NUM_CLASSES = 4
# scripts/config/inputs/cardiorespiratory/all.yaml
DROPOUTS = {'ABD': 0.7, 'THX': 0.7, 'ECG': 0.5, 'PPG': 0.1}
BACKUPS = ['ECG', 'PPG']
RING = 4
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def example_batch(B: int, S: int, seed: int = 0) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """A seeded host batch: N(0, 1) f32 signals of S epochs and labels in
    -1..3 (-1 ignored), as ``__graft_entry__._example_batch``."""
    rng = np.random.default_rng(seed)
    x = {sig: rng.normal(size=(B, COLS_TO_SAMPLES_PER_EPOCH[sig] * S)).astype(np.float32) for sig in SIGNALS}
    y = rng.integers(-1, NUM_CLASSES, size=(B, S)).astype(np.float32)
    return x, y


@dataclass
class Setup:
    state: TrainState
    step: Callable
    device: torch.device
    dtype: torch.dtype


def build(precision: str = 'bfloat16', feature_dim: int = 128, device=None, remat: bool = True,
          ema: bool = True) -> Setup:
    """The flagship (weights from seed 0), its train state and its step
    with the bench's options, on ``device`` (the card when None)."""
    device = resolve_device(device)
    cfg = flagship_config(feature_dim)
    cfg['encoders']['remat'] = remat
    model = build_wav2sleep(**cfg, generator=torch.Generator().manual_seed(0)).to(device)
    opt = make_optimizer(exp_warmup_schedule(1e-3, 2000, 10000), weight_decay=1e-4, grad_clip=1.0)
    state = init_train_state(model, opt, ema=ema)
    dtype = DTYPES[precision]
    step = make_train_step(
        model, opt, NUM_CLASSES, masker=SignalMasker(DROPOUTS, BACKUPS), flip_polarity=True,
        ema_decay=0.9999 if ema else None, ema_start_step=2000,
        compute_dtype=dtype if dtype != torch.float32 else None,
    )
    return Setup(state, step, device, dtype)


def device_batch(x: dict[str, np.ndarray], y: np.ndarray, transport: str, dtype: torch.dtype, device):
    """The batch on the device: signals in ``dtype`` (lossless) or q8 codes."""
    if transport == 'q8':
        xd = {k: tuple(torch.from_numpy(a).to(device) for a in v) for k, v in encode_batch(x).items()}
    else:
        xd = {k: torch.from_numpy(v).to(device=device, dtype=dtype) for k, v in x.items()}
    return xd, torch.from_numpy(y).to(device)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def chain_ms(s: Setup, batch, k: int, seed: int = 0) -> tuple[float, list[dict]]:
    """ms of ``k`` chained steps on one resident batch (CUDA events on the
    card), and each step's metrics; raises unless every step's loss and
    gradient norm are finite."""
    _sync(s.device)
    metrics = []
    if s.device.type == 'cuda':
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            metrics.append(s.step(s.state, batch, seed)[1])
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(k):
            metrics.append(s.step(s.state, batch, seed)[1])
        ms = 1e3 * (time.perf_counter() - t0)
    if not bool(torch.isfinite(torch.stack([m[key] for m in metrics for key in ('loss', 'grad_norm')])).all()):
        raise AssertionError('a chained step has a non-finite loss or gradient norm')
    return ms, metrics


def compute_ms(s: Setup, batch, k: int, reps: int) -> float:
    """Median over ``reps`` of the marginal ms per step between 1 and ``k``
    chained steps."""
    chain_ms(s, batch, 1)  # warm
    return statistics.median((chain_ms(s, batch, k)[0] - chain_ms(s, batch, 1)[0]) / (k - 1) for _ in range(reps))


def e2e_ms(s: Setup, x: dict[str, np.ndarray], y: np.ndarray, transport: str, k: int, reps: int) -> float:
    """Median over ``reps`` of the wall ms per step of ``k`` steps, each
    staging its batch on the host into a ring of pinned slots."""
    pin = s.device.type == 'cuda'
    slots = []
    for _ in range(RING):
        if transport == 'q8':
            host = {n: (torch.empty(v.shape, dtype=torch.int8, pin_memory=pin),
                        torch.empty(v.shape[:1], dtype=torch.float32, pin_memory=pin),
                        torch.empty(v.shape[:1], dtype=torch.bool, pin_memory=pin)) for n, v in x.items()}
        else:
            host = {n: torch.empty(v.shape, dtype=s.dtype, pin_memory=pin) for n, v in x.items()}
        slots.append((host, torch.empty(y.shape, dtype=torch.float32, pin_memory=pin)))
    events: list = [None] * RING

    def stage(j: int):
        host, host_y = slots[j]
        if transport == 'q8':
            encode_batch(x, slot={n: tuple(t.numpy() for t in v) for n, v in host.items()})
            xd = {n: tuple(t.to(s.device, non_blocking=True) for t in v) for n, v in host.items()}
        else:
            for n, v in x.items():
                host[n].copy_(torch.from_numpy(v))
            xd = {n: t.to(s.device, non_blocking=True) for n, t in host.items()}
        host_y.copy_(torch.from_numpy(y))
        return xd, host_y.to(s.device, non_blocking=True)

    def put(i: int):
        j = i % RING
        if events[j] is not None:
            events[j].synchronize()  # slot j's last copy has landed
        batch = stage(j)
        if pin:
            events[j] = torch.cuda.Event()
            events[j].record()
        return batch

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        batch, losses = put(0), []
        for i in range(n):
            losses.append(s.step(s.state, batch, 0)[1]['loss'])
            if i + 1 < n:
                batch = put(i + 1)
        _sync(s.device)
        if not bool(torch.isfinite(torch.stack(losses)).all()):
            raise AssertionError('a step of the e2e run has a non-finite loss')
        return 1e3 * (time.perf_counter() - t0) / n

    timed(1)
    return statistics.median(timed(k) for _ in range(reps))


def launches_per_step(s: Setup, batch) -> dict[str, int]:
    """K1 and K2 launches of one step."""
    conv_k3.LAUNCHES = conv_k3.STATS_LAUNCHES = 0
    s.step(s.state, batch, 0)
    _sync(s.device)
    return {'K1': conv_k3.LAUNCHES, 'K2': conv_k3.STATS_LAUNCHES}


def run(batch: int = 4, epochs_per_night: int = 1200, feature_dim: int = 128, precision: str = 'bfloat16',
        transport: str = 'lossless', k: int = 5, reps: int = 3, device=None, remat: bool = True,
        e2e: bool = True) -> dict:
    """The bench's measurements as a dict (its JSON line). ``e2e=False``
    skips the staged run."""
    if k < 2:
        raise ValueError('k must be >= 2 (the marginal timing divides by k - 1)')
    s = build(precision, feature_dim, device, remat)
    x, y = example_batch(batch, epochs_per_night)
    cuda = s.device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(s.device)
    resident = device_batch(x, y, transport, s.dtype, s.device)
    launches = launches_per_step(s, resident)
    compute = compute_ms(s, resident, k, reps)
    loss = float(chain_ms(s, resident, 1)[1][-1]['loss'])
    del resident
    e2e_per_step = e2e_ms(s, x, y, transport, k, reps) if e2e else None
    return {
        'metric': (f'train step (B={batch}, S={epochs_per_night}, cardio signals, fd={feature_dim}, {precision}, '
                   f'transport={transport}, remat={"on" if remat else "off"})'),
        'device': torch.cuda.get_device_name(s.device) if cuda else 'cpu',
        'card': card_line() if cuda else None,
        'compute_ms_per_step': compute,
        'e2e_ms_per_step': e2e_per_step,
        'nights_per_hour_e2e': None if e2e_per_step is None else batch / e2e_per_step * 3.6e6,
        'steps_per_sec_compute': 1e3 / compute,
        'peak_gib': torch.cuda.max_memory_allocated(s.device) / 2**30 if cuda else None,
        'k1_launches_per_step': launches['K1'],
        'k2_launches_per_step': launches['K2'],
        'loss': loss,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--epochs-per-night', type=int, default=1200)
    parser.add_argument('--feature-dim', type=int, default=128)
    parser.add_argument('--precision', default='bfloat16', choices=sorted(DTYPES))
    parser.add_argument('--transport', default='lossless', choices=['lossless', 'q8'],
                        help='lossless ships signals at compute precision; q8 ships mu-law int8 codes '
                             'decoded on the device')
    parser.add_argument('--k', type=int, default=5, help='chained steps for the marginal timing (>= 2)')
    parser.add_argument('--reps', type=int, default=3, help='timing repetitions; the median is reported')
    parser.add_argument('--remat', default='on', choices=['on', 'off'],
                        help="recompute each encoder block in the backward (the training config's setting)")
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    args = parser.parse_args(argv)
    if args.k < 2:
        parser.error('--k must be >= 2 (marginal timing divides by k - 1)')
    print(json.dumps(run(args.batch, args.epochs_per_night, args.feature_dim, args.precision, args.transport,
                         args.k, args.reps, args.device, args.remat == 'on')), flush=True)


if __name__ == '__main__':
    main()
