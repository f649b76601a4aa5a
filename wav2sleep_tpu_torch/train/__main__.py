"""Training entry point: ``python -m wav2sleep_tpu_torch.train <overrides>``.

The port's counterpart of ``scripts/train.py``, with the same Hydra-style
overrides on the same configs (``scripts/config``)::

    python -m wav2sleep_tpu_torch.train name=joint datasets=all inputs=cardiorespiratory/all
    python -m wav2sleep_tpu_torch.train name=mesa_ecg datasets=mesa inputs=cardiorespiratory/ecg epochs=10
    python -m wav2sleep_tpu_torch.train -m training.optimizer.lr=1e-3,3e-4   # a sweep, run by run

It trains on one card (``device=cpu`` asks for the CPU; without a card it
raises), with gradient accumulation ``target_batch_size // batch_size``,
then optionally restores the best checkpoint, evaluates the test sets and
exports the deployable folder to ``<run_dir>/model`` and the final metrics
to ``<run_dir>/final_metrics.json``. ``profile=true`` traces epoch 0 with
``torch.profiler`` into ``<run_dir>/profile``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
CONFIG_DIR = REPO_ROOT / 'scripts' / 'config'

logger = logging.getLogger('train')


def warn_if_dirty_git(repo_root: Path = REPO_ROOT, debug: bool = False) -> bool:
    """Warn when training from a dirty git tree (the reference's Hydra git
    callback refuses to launch outside debug mode; this warns). Returns
    whether the tree is dirty."""
    if debug:
        return False
    try:
        out = subprocess.run(['git', 'status', '--porcelain'], cwd=repo_root, capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return False
    dirty = out.returncode == 0 and bool(out.stdout.strip())
    if dirty:
        logger.warning('Git tree is dirty: this run cannot be reproduced from a commit '
                       '(the reference refuses to launch in this state outside debug).')
    return dirty


def _split_device(argv: list[str]) -> tuple[list[str], str | None]:
    """The overrides without ``device=...``, and that device (None: the card)."""
    rest, device = [], None
    for arg in argv:
        if arg.lstrip('+').startswith('device='):
            device = arg.split('=', 1)[1]
        else:
            rest.append(arg)
    return rest, device


def main(argv: list[str] | None = None) -> dict:
    from ..config import compose
    from ..instantiate import build_model, instantiate, model_family, reference_compatible_config
    from ..utils import fix_seeds, resolve_device
    from .datamodule import SleepDataModule
    from .loop import Trainer
    from .tuning import tune_batch_size

    argv, device = _split_device(list(sys.argv[1:] if argv is None else argv))
    t_start = time.time()
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(name)s %(levelname)s %(message)s')
    cfg = compose(str(CONFIG_DIR), 'main', argv)
    if (cfg.get('num_devices') or 1) > 1:
        raise NotImplementedError(
            f'num_devices={cfg["num_devices"]}: the port trains on one card; multi-card training is '
            'not ported yet (ROADMAP.md §A.6)')
    device = resolve_device(device)
    fix_seeds(cfg['seed'])
    warn_if_dirty_git(debug=bool(cfg.get('debug', {}).get('max_nights')))

    model_cfg = cfg['model']
    model = build_model(model_cfg, generator=torch.Generator().manual_seed(cfg['seed']))
    family = model_family(model_cfg)
    masker_cfg = cfg.get('inputs', {}).get('masker')
    masker = instantiate(masker_cfg) if masker_cfg else None
    tcfg = cfg['training']
    columns = list(cfg['inputs']['signal_map'].keys())

    batch_size = cfg['batch_size']
    if cfg.get('tune_batch_size'):
        tuned = tune_batch_size(
            model, columns=columns, num_classes=cfg['num_classes'],
            epochs_per_night=cfg.get('pad_to_epochs') or int(round(cfg['max_length_hours'] * 120)),
            family=family,
            # The persistent state the real step carries: the in-graph EMA,
            # and the accumulation buffers (accumulation is decided from the
            # tuned size, so the probe has them).
            ema=tcfg['ema']['enabled'] and not tcfg['ema'].get('offload', False),
            grad_accum=True, device=device,
        )
        if tuned:
            logger.info(f'Tuned batch size: {tuned}')
            batch_size = tuned
    accumulate = max(cfg['target_batch_size'] // batch_size, 1)
    if accumulate > 1:
        logger.info(f'Gradient accumulation: {accumulate} steps (effective batch {batch_size * accumulate}).')

    dm = SleepDataModule(
        columns=columns,
        data_location=cfg['data_location'],
        train_datasets=cfg['datasets']['train'],
        val_datasets=cfg['datasets']['val'],
        test_datasets=cfg['datasets']['test'],
        num_classes=cfg['num_classes'],
        max_nights=cfg.get('debug', {}).get('max_nights', 1_000_000),
        test=cfg['test'],
        batch_size=batch_size,
        val_batch_size=tcfg['val_batch_size'],
        test_batch_size=tcfg['test_batch_size'],
        num_workers=cfg['num_cpus'],
        drop_last=tcfg['drop_last'],
        causal=cfg['causal'],
        seed=cfg['seed'],
        max_length_hours=cfg['max_length_hours'],
        pad_to_epochs=cfg.get('pad_to_epochs'),
        device=device,
    )
    log_dir = cfg.get('run_dir') or os.path.join(cfg['log_root'], 'logs', cfg['name'],
                                                 time.strftime('%Y-%m-%d/%H-%M-%S'))
    trainer = Trainer(
        model=model,
        datamodule=dm,
        num_classes=cfg['num_classes'],
        family=family,
        lr=float(tcfg['optimizer']['lr']),
        weight_decay=float(tcfg['optimizer']['weight_decay']),
        warmup_steps=int(tcfg['scheduler'].get('warmup_steps', 0) or 0),
        tau=float(tcfg['scheduler'].get('tau', 10_000) or 10_000),
        scheduler={'expdecay': 'expdecay', 'plateau': 'plateau'}.get(tcfg['scheduler'].get('name'), 'none'),
        grad_clip=tcfg['grad_clip'],
        accumulate_grad_batches=accumulate,
        epochs=cfg['epochs'],
        label_smoothing=tcfg['label_smoothing'],
        masker=masker,
        flip_polarity=tcfg['flip_polarity'],
        ema_decay=tcfg['ema']['decay'] if tcfg['ema']['enabled'] else None,
        ema_start_step=tcfg['ema']['start_step'],
        ema_offload=tcfg['ema'].get('offload', False),
        early_stopping_patience=tcfg['early_stopping_patience'],
        reset_early_stopping=tcfg['reset_early_stopping'],
        precision=cfg['precision'],
        input_transport=cfg.get('input_transport'),
        eval_transport=cfg.get('eval_transport'),
        shadow_eval_transport=cfg.get('shadow_eval_transport'),
        metric_fetch_every=int(tcfg.get('metric_fetch_every', 16)),
        eval_fetch_every=int(tcfg.get('eval_fetch_every', 16)),
        stage_ring=int(tcfg.get('stage_ring', 4)),
        seed=cfg['seed'],
        log_dir=log_dir,
        device=device,
    )
    if cfg.get('profile'):
        _with_profile(trainer, log_dir)

    logger.info(f'Training {cfg["name"]} for {cfg["epochs"]} epochs on {device}; logs at {log_dir}')
    final = trainer.fit(resume_from=cfg.get('ckpt_path'))
    if cfg['restore_best']:
        best = os.path.join(log_dir, 'checkpoints', 'best')
        if os.path.isdir(best):
            trainer.restore(best)
            logger.info('Restored best (lowest val_loss) checkpoint.')
    if cfg['test']:
        final = trainer.evaluate('test')

    export_dir = os.path.join(log_dir, 'model')
    trainer.export(export_dir, reference_compatible_config(model_cfg))
    logger.info(f'Exported deployable checkpoint to {export_dir}')
    logger.info(f'Job wall time: {time.time() - t_start:.1f}s')
    # A supervised run (train/supervise.py) reads the result from here.
    with open(os.path.join(log_dir, 'final_metrics.json'), 'w') as f:
        json.dump({k: float(v) for k, v in final.items()}, f, indent=2)
    return final


def _with_profile(trainer, log_dir: str) -> None:
    """Trace the first training epoch with ``torch.profiler`` (the
    reference's opt-in PyTorchProfiler): a Chrome trace in
    ``<log_dir>/profile``."""
    orig = trainer.train_epoch

    def traced(epoch):
        if epoch != 0:
            return orig(epoch)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            out = orig(epoch)
        os.makedirs(os.path.join(log_dir, 'profile'), exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, 'profile', 'trace.json'))
        return out

    trainer.train_epoch = traced


def expand_multirun(argv: list[str]) -> list[list[str]] | None:
    """Hydra-style ``-m``/``--multirun`` sweeps: the Cartesian product of
    every comma-separated override, run one after another, each with a
    ``name`` suffix of its swept values; None when not a sweep. Bracketed
    values are lists of one run, not sweep axes."""
    if '-m' not in argv and '--multirun' not in argv:
        return None
    base = [a for a in argv if a not in ('-m', '--multirun')]
    variants: list[tuple[list[str], list[str]]] = [([], [])]  # (overrides, name parts)
    for arg in base:
        value = arg.split('=', 1)[1] if '=' in arg else ''
        if ',' in value and '[' not in value and not arg.startswith('name='):
            key, values = arg.split('=', 1)
            variants = [
                (ov + [f'{key}={v}'], parts + [f'{key.rsplit(".", 1)[-1]}-{v.replace("/", ".")}'])
                for ov, parts in variants
                for v in values.split(',')
            ]
        else:
            variants = [(ov + [arg], parts) for ov, parts in variants]
    out = []
    for ov, parts in variants:
        name = next((a.split('=', 1)[1] for a in ov if a.startswith('name=')), 'sweep')
        suffix = '_'.join(parts)
        out.append(ov + ([f'name={name}_{suffix}'] if suffix else []))
    return out


def run(argv: list[str] | None = None):
    """``main`` once, or once per variant of a ``-m`` sweep (a dict by index)."""
    argv = sys.argv[1:] if argv is None else argv
    sweeps = expand_multirun(argv)
    if sweeps is None:
        return main(argv)
    results = {}
    for i, sub in enumerate(sweeps):
        logger.info(f'--- multirun {i + 1}/{len(sweeps)}: {sub}')
        results[i] = main(sub)
    return results


if __name__ == '__main__':
    run()
