"""Training entry point: ``python -m wav2sleep_tpu_torch.train <overrides>``.

The port's counterpart of ``scripts/train.py``, with the same Hydra-style
overrides on the same configs (``scripts/config``)::

    python -m wav2sleep_tpu_torch.train name=joint datasets=all inputs=cardiorespiratory/all
    python -m wav2sleep_tpu_torch.train name=mesa_ecg datasets=mesa inputs=cardiorespiratory/ecg epochs=10
    python -m wav2sleep_tpu_torch.train -m training.optimizer.lr=1e-3,3e-4   # a sweep, run by run

It trains on the cards (``device=cpu`` asks for the CPU; without a card it
raises), with gradient accumulation ``target_batch_size // (batch_size x
devices)`` as the JAX script computes it, then optionally restores the best
checkpoint, evaluates the test sets and exports the deployable folder to
``<run_dir>/model`` and the final metrics to ``<run_dir>/final_metrics.json``.
``profile=true`` traces epoch 0 with ``torch.profiler`` into
``<run_dir>/profile``.

Data parallelism (``parallel.mesh``), as the JAX script's ``num_devices``:

- ``num_devices=0`` (the default) uses every visible card, ``num_devices=N``
  the first N; more than the cards raises and names the count. Over N > 1
  one command spawns a rank per card (``cuda:0..N-1``, or N CPU ranks with
  ``device=cpu``), ``batch_size`` is the global batch, and each rank reads
  its rows. Batch-size tuning runs at one device only.
- Under torchrun (``torchrun --nnodes=H --nproc-per-node=G -m
  wav2sleep_tpu_torch.train ...``) each process joins the group from the
  environment and loads ``batch_size`` rows from its shard of the files.

Rank 0 alone writes the logs, checkpoints, export and final metrics.
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


def _rank(argv: list[str], device: str | None) -> dict:
    """One spawned rank's run (``spawn`` formed the group)."""
    return main(argv + ([f'device={device}'] if device is not None else []))


def main(argv: list[str] | None = None) -> dict:
    import torch.distributed as dist

    from ..config import compose
    from ..instantiate import build_model, instantiate, model_family, reference_compatible_config
    from ..parallel import mesh as pmesh
    from ..utils import fix_seeds, resolve_device
    from .datamodule import SleepDataModule
    from .loop import Trainer
    from .tuning import tune_batch_size

    argv, device = _split_device(list(sys.argv[1:] if argv is None else argv))
    t_start = time.time()
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(name)s %(levelname)s %(message)s')
    cfg = compose(str(CONFIG_DIR), 'main', argv)
    # Joins torchrun's group, before anything touches a card.
    pmesh.maybe_initialize_distributed()
    mesh = None
    if dist.is_initialized():
        mesh = pmesh.make_mesh()
        device = mesh.device
        if not mesh.is_primary:
            logging.getLogger().setLevel(logging.WARNING)
    else:
        device = resolve_device(device)
        n = int(cfg.get('num_devices') or 0)
        devices = pmesh.devices_for(n, device, f'num_devices={n}')
        if len(devices) > 1:
            # One launch over N devices: a rank per device, rank 0's result.
            cpu = device.type != 'cuda'
            return pmesh.spawn(_rank, devices, args=(argv, 'cpu' if cpu else None),
                               timeout=pmesh.DEFAULT_TIMEOUT.total_seconds(), threads=1 if cpu else None)[0]
    n_dev = mesh.size if mesh is not None else 1
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
    if cfg.get('tune_batch_size') and n_dev == 1:  # one device only, as the JAX script
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
    accumulate = max(cfg['target_batch_size'] // (batch_size * n_dev), 1)
    if accumulate > 1:
        logger.info(f'Gradient accumulation: {accumulate} steps (effective batch {batch_size * n_dev * accumulate}).')

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
        mesh=mesh,
    )
    log_dir = cfg.get('run_dir') or os.path.join(cfg['log_root'], 'logs', cfg['name'],
                                                 time.strftime('%Y-%m-%d/%H-%M-%S'))
    if mesh is not None:
        # Every rank reads the checkpoints rank 0 writes: one run folder.
        shared = [log_dir]
        dist.broadcast_object_list(shared, src=0)
        log_dir = shared[0]
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
        mesh=mesh,
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
    if trainer.primary:
        # A supervised run (train/supervise.py) reads the result from here.
        with open(os.path.join(log_dir, 'final_metrics.json'), 'w') as f:
            json.dump({k: float(v) for k, v in final.items()}, f, indent=2)
    return final


def _with_profile(trainer, log_dir: str) -> None:
    """Trace the first training epoch with ``torch.profiler`` (the
    reference's opt-in PyTorchProfiler): a Chrome trace in
    ``<log_dir>/profile``."""
    from .. import tracing

    orig = trainer.train_epoch

    def traced(epoch):
        if epoch != 0:
            return orig(epoch)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # The epoch's program spans (``tracing``) are recorded while the
        # profiler is on; the trace holds their record_function twins.
        with torch.profiler.profile(activities=activities) as prof:
            out = orig(epoch)
        tracing.collect()
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
    import torch.distributed as dist

    argv = sys.argv[1:] if argv is None else argv
    sweeps = expand_multirun(argv)
    try:
        if sweeps is None:
            return main(argv)
        results = {}
        for i, sub in enumerate(sweeps):
            logger.info(f'--- multirun {i + 1}/{len(sweeps)}: {sub}')
            results[i] = main(sub)
        return results
    finally:
        if dist.is_initialized():  # the group torchrun's environment formed
            dist.destroy_process_group()


if __name__ == '__main__':
    run()
