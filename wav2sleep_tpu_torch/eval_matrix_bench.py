"""The eval matrix's fetch A/B: per-batch metric reads against the deferred
drain, and the q16 and q8 eval transports, on one card.

    python -m wav2sleep_tpu_torch.eval_matrix_bench [--data DIR] [--reps 3] [--val-batch-size 8]
        [--precision bfloat16|float32] [--device cuda|cpu]

The port's counterpart of ``scripts/eval_matrix_bench.py``, with its output
keys. A full ``Trainer.evaluate('val')`` pass (the combined loader, each
dataset and its signal subsets) over a prepared corpus (``--data``: the
``data`` folder of ``convergence_drive --prepare``, or any corpus laid out
as ``<data>/<dataset>/val``) is timed with ``eval_fetch_every=1`` (a metric
read after every batch) and with the default 16, and under the q16 and q8
eval transports, in alternating order, ``--reps`` times; the medians are
reported, with each transport's largest loss difference from the lossless
pass on the same weights and batches. The weights are the flagship's seeded
random init: eval time does not depend on them. Nights are padded to the
longest scored val night of the corpus, at most 10 h (the JAX script's
fixed 10 h, which the drive's 10 h nights give).

Prints one JSON line. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def night_hours(data: str, cap: float = 10.0) -> float:
    """The hours to the last scored epoch of the longest MESA val night
    under ``data`` (ingest pads every night to 10 h with unscored epochs),
    at most ``cap``."""
    from .data.parquet import read_columns
    from .settings import LABEL

    def scored_epochs(fp):
        stage = read_columns(fp, [LABEL])[LABEL]
        scored = np.flatnonzero(stage[np.isfinite(stage)] >= 0)
        return int(scored[-1]) + 1 if scored.size else 0

    fps = glob.glob(os.path.join(data, 'mesa', 'val', '*.parquet'))
    if not fps:
        raise FileNotFoundError(f'no MESA val nights under {data}')
    return min(cap, max(map(scored_epochs, fps)) / 120)


def run(args) -> dict:
    import torch

    from .models.wav2sleep import build_wav2sleep, flagship_config
    from .settings import ABD, ECG, PPG, THX
    from .train.datamodule import SleepDataModule
    from .train.loop import Trainer
    from .utils import resolve_device

    device = resolve_device(args.device)
    model = build_wav2sleep(**flagship_config(), generator=torch.Generator().manual_seed(0))
    dm = SleepDataModule(
        columns=[ECG, PPG, ABD, THX],
        data_location=args.data,
        train_datasets=['mesa'],
        val_datasets=['mesa'],
        test_datasets=['mesa'],
        batch_size=4,
        val_batch_size=args.val_batch_size,
        num_workers=1,
        max_length_hours=night_hours(args.data),
        device=device,
    )
    trainer = Trainer(
        model=model,
        datamodule=dm,
        num_classes=4,
        epochs=1,
        lr=1e-3,
        masker=None,
        log_dir=args.log_dir,
        precision=args.precision,
        seed=0,
        progress_bar=False,
    )
    trainer.ensure_state()

    # Warm-up pass (untimed): the loader's pages and the card's kernels.
    trainer.eval_fetch_every = 16
    trainer.evaluate('val', epoch=0)

    def timed(fetch_every: int, transport: str | None = None) -> float:
        trainer.eval_fetch_every = fetch_every
        trainer.eval_transport = transport
        t0 = time.time()
        trainer.evaluate('val', epoch=0)
        trainer.eval_transport = None
        return time.time() - t0

    # The transports' metrics against the lossless pass's (same parameters,
    # same batches: the difference is the transport's quantization).
    def metrics(transport):
        trainer.eval_transport = transport
        out = trainer.evaluate('val', epoch=0)
        trainer.eval_transport = None
        return out

    base = metrics(None)
    deltas = {t: max(abs(m[k] - base[k]) for k in base) for t, m in (('q16', metrics('q16')), ('q8', metrics('q8')))}

    arms: dict[str, list[float]] = {k: [] for k in ('per_batch', 'deferred', 'q16', 'q8')}
    for _ in range(args.reps):
        arms['per_batch'].append(timed(1))
        arms['deferred'].append(timed(16))
        arms['q16'].append(timed(16, 'q16'))
        arms['q8'].append(timed(16, 'q8'))
    n_val = len(dm._val_fps_combined)
    med = {k: float(np.median(v)) for k, v in arms.items()}
    return {
        'metric': 'full val eval-matrix wall seconds (combined + per-dataset + subsets)',
        'device': str(trainer.device),
        'val_nights': n_val,
        'val_batch_size': args.val_batch_size,
        'precision': args.precision,
        'per_batch_fetch_s': round(med['per_batch'], 2),
        'deferred_drain_s': round(med['deferred'], 2),
        'q16_transport_s': round(med['q16'], 2),
        'q8_transport_s': round(med['q8'], 2),
        'speedup_drain': round(med['per_batch'] / med['deferred'], 3),
        'speedup_q16': round(med['deferred'] / med['q16'], 3),
        'speedup_q8': round(med['deferred'] / med['q8'], 3),
        'max_abs_loss_delta_q16': float(f'{deltas["q16"]:.3g}'),
        'max_abs_loss_delta_q8': float(f'{deltas["q8"]:.3g}'),
        **{f'{k}_all_s': [round(v, 2) for v in vs] for k, vs in arms.items()},
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--data', default=os.path.join(REPO, 'build', 'convergence_drive', 'data'))
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--val-batch-size', type=int, default=8)
    ap.add_argument('--precision', default='bfloat16', choices=['float32', 'bfloat16'])
    ap.add_argument('--device', default=None, help='cuda (the default) or cpu')
    ap.add_argument('--log-dir', default=os.path.join(REPO, 'runs', 'eval_matrix_bench'))
    return ap


def main(argv=None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
