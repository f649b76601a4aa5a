"""Convergence-scale training drive: the whole training loop run to early
stopping, on the card.

    python -m wav2sleep_tpu_torch.convergence_drive --prepare [--nights 128] [--hours 10]
        [--signals cardio|eog] [--label-noise 0.12] [--overlap 0] [--seed 0]
    python -m wav2sleep_tpu_torch.convergence_drive [--epochs 60] [--batch-size 4] [--device cpu]
        [<train overrides>...]

The port's counterpart of ``scripts/convergence_drive.py``, with its
arguments, defaults and output keys. Everything a short fit leaves idle
runs here: early stopping (patience 5) before the epoch cap, the plateau LR
controller (``training/scheduler=decay``: patience 2, factor 0.1, visible in
the logged ``lr``), the EMA eval swap over tens of epochs, best-versus-last
checkpoint selection, the shadow q16 eval every epoch, the test pass on the
restored best weights, and the export reloaded through the inference API.

The default corpus is hard on purpose (``--label-noise`` 0.12): label flips
put a floor under val_loss, so it plateaus and the selection machinery
fires.

Two phases:

``--prepare`` (host only): N distinct nights (``data.synth``) written as EDF
and NSRR annotation XML, then ingested by ``ingest.process_night`` (EDF
reader, alias matching, unit QC, grid resample, parquet with the label join)
into ``<root>/data/mesa/{train,val,test}``. Night i is seeded ``(seed, i)``,
so an interrupted prepare resumes to the same corpus. The nights are
ingested in spawned processes, one for each of the host's cores.

default: ``python -m wav2sleep_tpu_torch.train`` under the stall watchdog of
``train.supervise.run_supervised`` on that corpus, with the production knobs
(plateau scheduler, EMA 0.999 from step 50, shadow q16 eval, bf16 over the
q8 input transport, best-checkpoint restore, test pass, export); then the
exported model through ``api.load_model`` and ``predict_on_folder`` on the
test nights: accuracy, kappa and the confusion matrix. The run's
``metrics.jsonl`` and ``config.yaml`` and a ``summary.json`` go to
``--out``. Arguments the script does not know are passed to the train CLI
as overrides (``feature_dim=16``, ...). Runs on the card unless
``--device cpu`` is given.

``--signals eog`` switches to wav2sleep-eog: EOG-L/EOG-R at 4,096 samples
an epoch, 5 classes, ``inputs=neural/eog``. (The JAX script also defers
its EOG metric reads, ``training.metric_fetch_every=64``, to spare its
device link; the port keeps the trainer's default.)
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import logging
import os
import shutil
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

logger = logging.getLogger('convergence_drive')

# Synthetic 4-class stages (Wake/Light/Deep/REM, data/synth.py) -> raw NSRR
# stage codes as scored in annotation XMLs: Light is scored N2 (2), Deep N3
# (3), REM carries raw code 5 (data/utils.py maps 5 -> 4).
SYNTH_TO_NSRR = {0: 0, 1: 2, 2: 3, 3: 5}
# 5-class EOG stages (Wake/N1/N2/N3/REM) -> raw NSRR codes (REM scored 5).
SYNTH_TO_NSRR_5 = {0: 0, 1: 1, 2: 2, 3: 3, 4: 5}


def write_nsrr_xml(fp: str, stages, stage_map=None) -> None:
    """NSRR-format annotation XML for one night (30 s epochs, run-length
    encoded like real NSRR exports; the format ``data/xml.py`` parses)."""
    stage_map = SYNTH_TO_NSRR if stage_map is None else stage_map
    parts = [
        '<Events>',
        '<ScoredEvent>',
        '<EventConcept>Recording Start Time</EventConcept>\n<Start>0</Start>',
        '</ScoredEvent>',
    ]
    t = 0.0
    run_stage, run_len = int(stages[0]), 0
    runs = []
    for s in stages:
        if int(s) == run_stage:
            run_len += 1
        else:
            runs.append((run_stage, run_len))
            run_stage, run_len = int(s), 1
    runs.append((run_stage, run_len))
    for stage, n in runs:
        dur = 30.0 * n
        parts.append(
            '<ScoredEvent>\n'
            '<EventType>Stages.Stages</EventType>\n'
            f'<EventConcept>Stage|{stage_map[stage]}</EventConcept>\n'
            f'<Start>{t:g}</Start>\n'
            f'<Duration>{dur:g}</Duration>\n'
            '</ScoredEvent>'
        )
        t += dur
    parts.append('</Events>')
    with open(fp, 'w') as f:
        f.write('\n'.join(parts))


def _prepare_night(job: tuple, signals: str, hours: float, seed: int, overlap: float, label_noise: float,
                   edf_dir: str) -> bool:
    """Synthesize, write and ingest night ``i`` into ``out_fp``; the EDF and
    XML are removed after (they are only scaffolding for the ingest)."""
    from .data.synth import synth_night, synth_night_eog, write_night_edf
    from .ingest import process_night
    from .settings import ABD, ECG, EOG_L, EOG_R, PPG, THX

    i, out_fp = job
    if signals == 'eog':
        gen, columns, stage_map = synth_night_eog, [EOG_L, EOG_R], SYNTH_TO_NSRR_5
    else:
        gen, columns, stage_map = synth_night, [ECG, PPG, ABD, THX], SYNTH_TO_NSRR
    night, stages = gen(np.random.default_rng((seed, i)), hours, overlap=overlap, label_noise=label_noise)
    edf_fp = os.path.join(edf_dir, f'night{i:04d}.edf')
    xml_fp = os.path.join(edf_dir, f'night{i:04d}-nsrr.xml')
    write_night_edf(edf_fp, night)
    write_nsrr_xml(xml_fp, stages, stage_map)
    ok = process_night(edf_fp, xml_fp, out_fp, columns=columns)
    os.remove(edf_fp)
    os.remove(xml_fp)
    return ok


def prepare(root: str, nights: int, hours: float, seed: int, args) -> None:
    """Synthetic EDF + XML pairs -> ingest -> split-partitioned parquet.

    Nights are seeded per index (seed, i), so the corpus is resume-safe: a
    prepare that resumes (skipping existing parquets) writes the nights a
    fresh run of the same seed writes.
    """
    from .parallel.map import parallelise

    n_val = n_test = max(2, nights // 8)
    n_train = nights - n_val - n_test
    splits = ['train'] * n_train + ['val'] * n_val + ['test'] * n_test
    edf_dir = os.path.join(root, 'edfs')
    os.makedirs(edf_dir, exist_ok=True)
    jobs = [(i, os.path.join(root, 'data', 'mesa', split, f'night{i:04d}.parquet')) for i, split in enumerate(splits)]
    jobs = [job for job in jobs if not os.path.exists(job[1])]
    work = functools.partial(_prepare_night, signals=args.signals, hours=hours, seed=seed, overlap=args.overlap,
                             label_noise=args.label_noise, edf_dir=edf_dir)
    t0 = time.time()
    results = parallelise(work, jobs, max_parallel=max(1, min(len(jobs), len(os.sched_getaffinity(0)))))
    failed = [job[0] for job, ok in zip(jobs, results) if not ok]
    if failed:
        raise RuntimeError(f'ingest failed for nights {failed}')
    print(f'[prepare] done: {nights} nights under {root}/data in {time.time() - t0:.0f}s', flush=True)


def drive(root: str, args, extra: list[str], train_command: list[str] | None = None) -> dict:
    """Run the fit supervised (``train.supervise``): the train CLI (or
    ``train_command``, a command line taking the overrides) in a child
    process pinned to one run_dir, stall-watchdogged, restarted from the
    last epoch checkpoint on a stall."""
    from .train.supervise import run_supervised

    inputs = 'neural/eog' if args.signals == 'eog' else 'cardiorespiratory/all'
    t0 = time.time()
    overrides = [
        f'name={args.name}',
        f'data_location={os.path.join(root, "data")}',
        f'log_root={os.path.join(root, "storage")}',
        'datasets=mesa',
        f'inputs={inputs}',
        f'seed={args.seed}',
        f'epochs={args.epochs}',
        f'batch_size={args.batch_size}',
        f'target_batch_size={args.batch_size}',
        'training/scheduler=decay',  # ReduceLROnPlateau role (name: plateau)
        'training.ema.enabled=true',
        'training.ema.decay=0.999',
        'training.ema.start_step=50',
        'training.val_batch_size=8',
        'training.test_batch_size=8',
        'test=true',
        'restore_best=true',
        # Shadow q16 eval each epoch: would best-epoch selection differ under
        # the cheaper eval transport? Selection itself stays lossless.
        'shadow_eval_transport=q16',
        'precision=bfloat16',
        'input_transport=q8',
        'num_cpus=1',
    ]
    if args.signals == 'eog':
        overrides.append('num_classes=5')
    if args.device is not None:
        overrides.append(f'device={args.device}')
    run_dir = os.path.join(root, 'storage', 'logs', args.name, 'supervised', 'run')
    run_supervised(overrides + extra, run_dir, train_command=train_command)
    with open(os.path.join(run_dir, 'final_metrics.json')) as f:
        final = json.load(f)
    final['drive_wall_seconds'] = round(time.time() - t0, 1)
    return final


def selection_evidence(metrics_fp: str, epoch_cap: int) -> dict:
    """The per-epoch log distilled into the three claims the drive exists
    to show: early stopping fired before the cap, the plateau controller
    cut the LR (in the logged ``lr`` values), and the best epoch is not the
    last; plus the shadow q16 series' best-epoch A/B."""
    epochs = {}
    with open(metrics_fp) as f:
        for line in f:
            row = json.loads(line)
            epochs.setdefault(row['step'], {}).update(row)
    val = {e: r['val_loss'] for e, r in sorted(epochs.items()) if 'val_loss' in r}
    lr = {e: r['lr'] for e, r in sorted(epochs.items()) if 'lr' in r}
    if not val:
        raise RuntimeError(f'no val_loss rows in {metrics_fp}')
    last_epoch = max(val)
    best_epoch = min(val, key=val.get)
    lr_values = sorted(set(lr.values()), reverse=True)
    reductions = [e for e in sorted(lr)[1:] if lr[e] < lr[e - 1] * 0.999]
    # The shadow q16 series logged beside the lossless one: would best-epoch
    # selection have differed?
    shadow = {e: r['val_loss_q16'] for e, r in sorted(epochs.items()) if 'val_loss_q16' in r}
    ab = None
    if shadow:
        common = sorted(set(val) & set(shadow))
        best_q16 = min(common, key=lambda e: shadow[e])
        ab = {
            'shadow_transport': 'q16',
            'epochs_compared': len(common),
            'best_epoch_lossless': min(common, key=lambda e: val[e]),
            'best_epoch_q16': best_q16,
            'selection_agrees': min(common, key=lambda e: val[e]) == best_q16,
            'max_abs_val_loss_delta': round(max(abs(val[e] - shadow[e]) for e in common), 8),
        }
    return {
        'eval_transport_ab': ab,
        'epochs_run': last_epoch + 1,
        'epoch_cap': epoch_cap,
        'early_stopped': last_epoch + 1 < epoch_cap,
        'best_epoch': best_epoch,
        'last_epoch': last_epoch,
        'best_is_last': best_epoch == last_epoch,
        'best_val_loss': round(val[best_epoch], 6),
        'last_val_loss': round(val[last_epoch], 6),
        'distinct_lr_values': [round(v, 8) for v in lr_values],
        'lr_reduction_epochs': reductions,
        'plateau_lr_reduced': len(lr_values) > 1,
    }


def collect(root: str, final: dict, args) -> dict:
    """Copy the run's log to ``--out`` and score the exported best model
    on the test nights through the inference API."""
    from .api import load_model, predict_on_folder
    from .settings import IGNORE_LABEL
    from .stats import cohens_kappa

    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    run_dir = sorted(glob.glob(os.path.join(root, 'storage', 'logs', args.name, '*', '*')))[-1]
    for name in ('metrics.jsonl', 'config.yaml'):
        src = os.path.join(run_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, name))

    evidence = selection_evidence(os.path.join(run_dir, 'metrics.jsonl'), args.epochs)

    # The deployment artifact, not the in-process state, is what the kappa
    # table certifies.
    model = load_model(os.path.join(run_dir, 'model'), device=args.device)
    test_folder = os.path.join(root, 'data', 'mesa', 'test')
    test_fps = sorted(glob.glob(os.path.join(test_folder, '*.parquet')))
    preds, labels = predict_on_folder(
        test_folder,
        os.path.join(root, 'storage', 'drive_preds'),
        model=model,
        device=args.device or 'auto',
        preprocess=False,  # the corpus is already grid-resampled parquet
        return_tensors=True,
        overwrite=True,
    )
    n_classes = model.num_classes
    cmat = np.zeros((n_classes, n_classes), np.int64)
    p = np.asarray(preds).reshape(-1).astype(int)
    t = np.asarray(labels).reshape(-1).astype(int)
    keep = t != IGNORE_LABEL
    np.add.at(cmat, (t[keep], p[keep]), 1)
    acc = float(np.trace(cmat) / max(cmat.sum(), 1))
    kappa = float(cohens_kappa(cmat, n_classes))
    summary = {
        'signals': args.signals,
        'num_classes': n_classes,
        'corpus': {
            'nights': args.nights,
            'hours': args.hours,
            'label_noise': args.label_noise,
            'overlap': args.overlap,
        },
        'selection': evidence,
        'final_metrics': final,
        'exported_checkpoint_test': {
            'nights': len(test_fps),
            'scored_epochs': int(keep.sum()),
            'accuracy': round(acc, 5),
            'kappa': round(kappa, 5),
            'confusion_matrix': cmat.tolist(),
        },
        'run_dir': run_dir,
    }
    with open(os.path.join(out_dir, 'summary.json'), 'w') as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({'selection': evidence, **summary['exported_checkpoint_test']}), flush=True)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=os.path.join(REPO, 'build', 'convergence_drive'))
    ap.add_argument('--name', default='convergence_drive', help='run name (storage/logs subdir)')
    ap.add_argument('--nights', type=int, default=128)
    ap.add_argument('--hours', type=float, default=10.0)
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--batch-size', type=int, default=4)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--signals', default='cardio', choices=['cardio', 'eog'])
    ap.add_argument('--label-noise', type=float, default=0.12,
                    help='fraction of epochs whose LABEL is re-scored to a random other stage (signals stay '
                         'true): puts an irreducible floor under val_loss')
    ap.add_argument('--overlap', type=float, default=0.0,
                    help='0..1 blend of per-stage physiology toward the mean (lowers the accuracy ceiling; '
                         'see data/synth.py)')
    ap.add_argument('--prepare', action='store_true', help='corpus phase only (host)')
    ap.add_argument('--device', default=None, help='cuda (the default) or cpu, for the fit and the re-score')
    ap.add_argument('--out', default=os.path.join(REPO, 'runs', 'convergence_drive'),
                    help="where the run's log and summary.json are copied")
    return ap


def main(argv=None, train_command: list[str] | None = None) -> dict | None:
    args, extra = build_parser().parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.prepare:
        prepare(args.root, args.nights, args.hours, args.seed, args)
        return None
    final = drive(args.root, args, extra, train_command)
    print('FINAL', json.dumps(final), flush=True)
    return collect(args.root, final, args)


if __name__ == '__main__':
    main()
