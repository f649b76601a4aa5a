"""The trainer's host loader at corpus scale, on one card.

Does the host loader (parquet read -> normalization -> collate -> q8 encode,
the threaded batch iterator with its epoch-seeded shuffle) keep up with the
card's step over about 1,000 distinct ingested nights? The port's
counterpart of ``scripts/pipeline_scale_bench.py``, with its output keys.

Corpus phase (host only, once):

    python -m wav2sleep_tpu_torch.convergence_drive --prepare --root build/pipeline_scale \\
        --nights 1000 --label-noise 0.0 --signals cardio

Measure phase (the card unless ``--device cpu``):

    python -m wav2sleep_tpu_torch.pipeline_scale_bench [--root build/pipeline_scale] [--epochs 3]
        [--batch-size 4] [--out FILE] [--distil-only RUN_DIR] [<train overrides>...]

drives ``python -m wav2sleep_tpu_torch.train`` (supervised,
``train.supervise``) for ``--epochs`` full epochs with bf16 over the q8
training transport, then distils per-epoch ms per step and the host-loader
share (``host_loader_frac``: the seconds the host spent producing batches
over the epoch's wall time) from the run's ``metrics.jsonl`` into ``--out``
and one JSON line. Epoch 0 pays the cold file reads and the kernel builds
(which dilute its loader share); the sustained means are over epochs >= 1,
where a corpus that fits the host's page cache is read warm.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def distil(metrics_fp: str, meta: dict) -> dict:
    """Per-epoch loader evidence from a run's metrics.jsonl: ms/step,
    host_loader_frac, derived epoch seconds; sustained (epoch >= 1) means."""
    epochs = {}
    with open(metrics_fp) as f:
        for line in f:
            row = json.loads(line)
            if 'train_steps_per_sec' in row:
                epochs[row['step']] = row
    if not epochs:
        raise RuntimeError(f'no train rows in {metrics_fp}')
    steps = meta.get('steps_per_epoch')
    rows = []
    for e, r in sorted(epochs.items()):
        sps = r['train_steps_per_sec']
        rows.append(
            {
                'epoch': e,
                'ms_per_step': round(1000.0 / sps, 2),
                'host_loader_frac': r.get('host_loader_frac'),
                'epoch_seconds': round(steps / sps, 1) if steps else None,
            }
        )
    sustained = [r for r in rows if r['epoch'] >= 1] or rows
    return {
        **meta,
        'epochs': rows,
        'sustained_ms_per_step': round(sum(r['ms_per_step'] for r in sustained) / len(sustained), 2),
        'sustained_host_loader_frac': round(sum(r['host_loader_frac'] for r in sustained) / len(sustained), 4),
        'cold_epoch0_ms_per_step': rows[0]['ms_per_step'],
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=os.path.join(REPO, 'build', 'pipeline_scale'))
    ap.add_argument('--epochs', type=int, default=3)
    ap.add_argument('--batch-size', type=int, default=4)
    ap.add_argument('--out', default=os.path.join(REPO, 'runs', 'pipeline_scale.json'))
    ap.add_argument('--distil-only', metavar='RUN_DIR', default=None, help='skip the fit; distil an existing run dir')
    ap.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return ap


def main(argv=None) -> dict:
    args, extra = build_parser().parse_known_args(argv)
    name = 'pipeline_scale'
    if args.distil_only:
        run_dir = args.distil_only
    else:
        from .train.supervise import run_supervised

        run_dir = os.path.join(args.root, 'storage', 'logs', name, 'supervised', 'run')
        t0 = time.time()
        overrides = [
            f'name={name}',
            f'data_location={os.path.join(args.root, "data")}',
            f'log_root={os.path.join(args.root, "storage")}',
            'datasets=mesa',
            'inputs=cardiorespiratory/all',
            f'epochs={args.epochs}',
            f'batch_size={args.batch_size}',
            f'target_batch_size={args.batch_size}',
            'precision=bfloat16',
            'input_transport=q8',
            'training.val_batch_size=8',
            'test=false',
            'restore_best=false',
            'num_cpus=1',
        ]
        if args.device is not None:
            overrides.append(f'device={args.device}')
        run_supervised(overrides + extra, run_dir)
        print(f'[scale] fit wall {time.time() - t0:.0f}s', flush=True)

    train_fps = glob.glob(os.path.join(args.root, 'data', 'mesa', 'train', '*.parquet'))
    n_train = len(train_fps)
    corpus_bytes = sum(os.path.getsize(fp) for fp in train_fps)
    meta = {
        'train_nights': n_train,
        'corpus_gib': round(corpus_bytes / 2**30, 2),
        'batch_size': args.batch_size,
        'steps_per_epoch': -(-n_train // args.batch_size),
        'input_transport': 'q8',
        'precision': 'bfloat16',
        'cache_caveat': (
            'epoch 0 pays cold file reads (and its loader fraction is diluted by the kernel builds); '
            'a corpus that fits the host page cache is read warm from epoch 1, so sustained rows '
            'measure decode+collate+encode, not disk'
        ),
    }
    out = distil(os.path.join(run_dir, 'metrics.jsonl'), meta)
    out['run_dir'] = run_dir
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k != 'epochs'}), flush=True)
    return out


if __name__ == '__main__':
    main()
