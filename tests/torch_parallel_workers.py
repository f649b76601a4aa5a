"""Rank functions of the two-rank tests (``tests/test_torch_parallel*.py``).

Spawned ranks import this module by name, so its functions are module-level;
it imports torch and the port only, never JAX, so a rank starts in seconds.
Each function returns numpy arrays and plain numbers, which pickle back to
the test.
"""

import os

import numpy as np
import torch

from wav2sleep_tpu_torch import instantiate
from wav2sleep_tpu_torch.parallel import mesh as pmesh
from wav2sleep_tpu_torch.train import step as tstep
from wav2sleep_tpu_torch.train.masker import SignalMasker
from wav2sleep_tpu_torch.train.scheduler import exp_warmup_schedule

SCHEDULE = (1e-3, 2, 10.0)
STEP_OPT = dict(weight_decay=1e-4, grad_clip=1.0)
MASKER = {'dropouts': {'ABD': 0.7, 'THX': 0.7, 'ECG': 0.5, 'PPG': 0.1}, 'backups': ['ECG', 'PPG']}


class RecordingAdamW(tstep.AdamW):
    """AdamW that keeps each micro-step's (all-reduced) gradients."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seen = []

    def update(self, grads, state, params):
        self.seen.append([g.detach().clone() for g in grads])
        return super().update(grads, state, params)


def build(cfg: dict, weights: dict | None, device='cpu') -> torch.nn.Module:
    model = instantiate.build_model(cfg, generator=torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()}, strict=True)
    return model.to(device)


def run_steps(cfg, weights, x, y, n_steps=1, masker=False, flip=False, mesh=None, device='cpu', seed=0,
              precision='float32', accumulate=1):
    """``n_steps`` steps of the port's train step from ``weights`` on the batch
    (x, y) (numpy; over a group this rank's rows). Per step: the loss, the
    gradient norm, the confusion matrix, the gradients by name, and the
    parameters and running statistics after it."""
    model = build(cfg, weights, device)
    opt = RecordingAdamW(exp_warmup_schedule(*SCHEDULE), STEP_OPT['weight_decay'], STEP_OPT['grad_clip'],
                         0.9, 0.999, 1e-8, accumulate)
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(model, opt, 4, masker=SignalMasker(**MASKER) if masker else None,
                                 flip_polarity=flip, mesh=mesh,
                                 compute_dtype=torch.bfloat16 if precision == 'bfloat16' else None)
    dtype = torch.bfloat16 if precision == 'bfloat16' else torch.float32
    xt = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype) for k, v in x.items()}
    yt = torch.from_numpy(np.ascontiguousarray(y)).to(device)
    out = []
    for _ in range(n_steps):
        state, m = step(state, (xt, yt), seed)
        out.append({
            'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']), 'cmat': m['cmat'].cpu().numpy(),
            'grads': {k: g.cpu().numpy() for k, g in zip(state.params, opt.seen[-1])},
            'params': {k: p.detach().cpu().numpy().copy() for k, p in state.params.items()},
            'stats': {k: b.cpu().numpy().copy() for k, b in (state.batch_stats or {}).items()},
            'mu': {k: m.cpu().numpy().copy() for k, m in zip(state.params, state.opt_state.mu)},
        })
    return out


def step_cases(cases: list[dict]) -> list:
    """Each case's ``run_steps`` on this rank's rows of its global batch."""
    mesh = pmesh.make_mesh()
    out = []
    for case in cases:
        case = dict(case)
        x, y = pmesh.shard_batch(mesh, (case.pop('x'), case.pop('y')))
        out.append(run_steps(x=x, y=y, mesh=mesh, device=mesh.device, **case))
    return out


def port_trainer(corpus, log_dir, model_cfg, weights, mesh=None, **kw):
    """``tests/test_torch_trainer.port_trainer`` (the JAX smoke test's
    trainer), over ``mesh`` when given."""
    from wav2sleep_tpu_torch.train.datamodule import SleepDataModule
    from wav2sleep_tpu_torch.train.loop import Trainer

    device = mesh.device if mesh is not None else 'cpu'
    dm = SleepDataModule(
        columns=['ECG', 'THX'], data_location=str(corpus), train_datasets=['mesa', 'shhs'],
        val_datasets=['mesa', 'shhs'], test_datasets=['mesa'], test=True, batch_size=4, val_batch_size=4,
        test_batch_size=4, num_workers=1, pad_to_epochs=6, max_length_hours=1, device=device, mesh=mesh)
    args = dict(model=build(model_cfg, weights), datamodule=dm, num_classes=4, epochs=2, lr=3e-3, warmup_steps=5,
                tau=1000.0, masker=None, flip_polarity=False, log_dir=str(log_dir), seed=0, progress_bar=False,
                mesh=mesh)
    args.update(kw)
    return Trainer(**args)


def fit_rank(corpus, log_dir, model_cfg, weights, kw):
    """A two-epoch fit over the group, then a fresh trainer restored from the
    checkpoint that rank 0 wrote: the fit's metrics, every rank's
    parameters, the restored state's parameters, its resume epoch, its eval
    matrix and its predictions on the test loader."""
    mesh = pmesh.make_mesh()
    tr = port_trainer(corpus, log_dir, model_cfg, weights, mesh=mesh, **kw)
    final = tr.fit()
    params = {k: p.detach().cpu().numpy() for k, p in tr.state.params.items()}
    tr2 = port_trainer(corpus, os.path.join(log_dir, f'restored{mesh.rank}'), model_cfg, weights, mesh=mesh, **kw)
    epoch = tr2.restore(os.path.join(log_dir, 'checkpoints', 'last'))
    restored = {k: p.detach().cpu().numpy() for k, p in tr2.state.params.items()}
    val = tr2.evaluate('val')
    _, loader = tr2.datamodule.test_loaders()[0]
    preds = tr2.predict(loader)
    return {'final': final, 'params': params, 'restored': restored, 'epoch': epoch, 'val': val, 'preds': preds,
            'steps': tr.state.step}


def build_native_rank(build_dir: str) -> dict:
    """Every rank builds the native host library into the same empty folder
    at once (after a barrier), loads it and runs the f64 EMA through it."""
    from pathlib import Path

    import torch.distributed as dist

    from wav2sleep_tpu_torch import native
    from wav2sleep_tpu_torch.ops.ema_norm import ema_normalize_host

    native.BUILD_DIR = Path(build_dir)
    dist.barrier()
    lib = native.build()
    x = np.sin(np.arange(4096, dtype=np.float32) / 7.0)
    z = ema_normalize_host(x, 34.0, tau_seconds=900.0, outlier_threshold_sigma=4.0, baseline_tau_seconds=120.0,
                           min_sigma=0.1)
    return {'library': lib._name, 'z': z}


def slow_rank(pause_s: float, rounds: int) -> float:
    """``rounds`` sums across the group, each after ``pause_s`` of work on
    every rank: the run outlasts the group's per-collective timeout while
    no collective waits long."""
    import time

    import torch.distributed as dist

    t = torch.ones(1)
    for _ in range(rounds):
        time.sleep(pause_s)
        dist.all_reduce(t)
    return float(t)


def failing_rank() -> None:
    """Rank 1 fails; rank 0 waits for it in a collective that never comes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError('rank 1 fails on purpose')
    dist.barrier()
