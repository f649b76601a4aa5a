"""Training traffic: the program's ``Trainer.train_epoch`` at a mix's
settings, fed by a stand-in for the data module from a pool of seeded
nights.

Set-up makes the configuration's weights and the pool
(``inputs.training_pool``), builds the ``Trainer`` and drives it through
``train_epoch(0)`` over ``check_steps`` batches whose rows all differ: more
steps than the staging ring has slots, so that the checked steps reuse its
slots as the window does. It reads the program's outputs of those steps:
each step's loss, the Adam first moment after step 1 (the first gradient
as the optimizer got it, clipped), and the parameters and, where the mix
keeps one, the EMA after the last of them. The window is
``train_epoch(1)``, fed until its seconds are up; its rate (under the
name that the mix's ``rate_metric`` gives, in nights/h) is the rows of its
steps over the time from its first batch to the synchronised end of its
last step, and ``train_peak_gib`` the device memory peak allocated in it.

The check runs the plain reference step (``reference.train``) on the same
weights and batches, with its own draws from the same seeds and its own
EMA, and compares the steps' losses (relative gap), and per leaf the norms
of the first gradient, of the parameters' change over the steps and of the
EMA's change, as the gap of the two norms over the reference's norm of that
leaf or of the median leaf, whichever is larger: the worst leaf's and the
median leaf's. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the changes: Adam moves them by
round-off alone.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, inputs
from benchmark.reference import model as ref
from benchmark.reference import train as rtrain

ROUNDOFF_LEAF = 1e-3


class PoolLoader:
    """The data module the trainer reads: ``train_loader(epoch)`` yields
    host batches ``({signal: f32 [B, T]}, f32 labels [B, S])``,
    ``batch_size`` and ``device``. The pool is put in a seeded order once,
    so that a batch is a view of consecutive rows and the loader adds no
    copy of its own to the host's work in the window; the batches cycle
    through it. It stops after ``steps`` batches, or once ``seconds`` have
    passed since its first batch; then it waits for the card and notes the
    time."""

    def __init__(self, pool: dict, batch_size: int, device, seed: int):
        self.pool, self.batch_size, self.device = pool, batch_size, device
        P = len(pool['y'])
        self.order = np.random.default_rng(seed).permutation(P)
        self.ordered = {sig: rows[self.order] for sig, rows in pool['x'].items()}
        self.labels = pool['y'][self.order]
        self.n_batches = P // batch_size
        self.steps, self.seconds = None, None
        self.t0 = self.t_end = None
        self.yielded = 0
        self.batches: list[np.ndarray] = []

    def train_loader(self, epoch: int):
        self.yielded = 0
        B = self.batch_size
        while True:
            now = time.perf_counter()
            if self.t0 is None:
                self.t0 = now
            if (self.steps is not None and self.yielded >= self.steps) or \
                    (self.seconds is not None and now - self.t0 >= self.seconds):
                if self.device.type == 'cuda':
                    torch.cuda.synchronize(self.device)
                self.t_end = time.perf_counter()
                return
            with record_function('bench/loader'):
                rows = slice((self.yielded % self.n_batches) * B, (self.yielded % self.n_batches + 1) * B)
                self.batches.append(self.order[rows])
                x = {sig: v[rows] for sig, v in self.ordered.items()}
                y = self.labels[rows]
            self.yielded += 1
            yield x, y


class State:
    pass


def setup(run: harness.Run) -> State:
    from wav2sleep_tpu_torch.train.loop import Trainer
    from wav2sleep_tpu_torch.train.masker import SignalMasker

    cfg, mix = run.cfg, run.mix
    clock = harness.Stopwatch()
    s = State()
    s.run = run
    s.weights = ref.make_weights(cfg, run.seed, run.device)
    clock.lap('weights')
    pool = inputs.training_pool(cfg, mix, run.seed, run.device)
    clock.lap('pool')
    if mix['check_steps'] * mix['batch_size'] > mix['pool_nights']:
        raise ValueError('the checked steps need rows that all differ: pool_nights >= check_steps * batch_size')
    if mix['check_steps'] < mix['stage_ring'] + 2:
        raise ValueError('the checked steps have to reuse the staging ring: check_steps >= stage_ring + 2')
    s.loader = PoolLoader(pool, mix['batch_size'], run.device, run.seed)
    model = harness.program_model(run, {k: v.clone() for k, v in s.weights.items()},
                                  remat=cfg['encoders']['remat_in_training'])
    opt = mix['optimizer']
    mk = cfg['masker']
    s.log_dir = tempfile.mkdtemp(prefix='bench_train_')
    s.trainer = Trainer(
        model=model, datamodule=s.loader, num_classes=cfg['num_classes'], lr=opt['lr'],
        weight_decay=opt['weight_decay'], warmup_steps=opt.get('warmup_steps', 0), tau=opt.get('tau', 1.0),
        scheduler=opt['scheduler'], grad_clip=opt['grad_clip'], masker=SignalMasker(mk['dropouts'], mk['backups']),
        flip_polarity=mix['flip_polarity'], ema_decay=mix['ema_decay'], ema_start_step=mix['ema_start_step'],
        precision=mix['precision'], input_transport=mix['input_transport'], seed=run.seed,
        log_dir=os.path.join(s.log_dir, 'run'), progress_bar=False,
        metric_fetch_every=mix['metric_fetch_every'], stage_ring=mix['stage_ring'], device=run.device,
    )
    clock.lap('model and trainer')
    # The program's outputs of the checked steps, read as the steps return.
    s.losses, s.mu1, s.params_after, s.ema_after = [], None, None, None
    step_fn = s.trainer._train_step

    def observed(state, batch, seed):
        state, metrics = step_fn(state, batch, seed)
        s.losses.append(metrics['loss'].detach().clone())
        if state.step == 1:
            s.mu1 = {n: m.detach().clone() for n, m in zip(state.params, state.opt_state.mu)}
        if state.step == mix['check_steps']:
            s.params_after = {n: p.detach().clone() for n, p in state.params.items()}
            if state.ema_params is not None:
                s.ema_after = {n: e.detach().clone() for n, e in state.ema_params.items()}
        return state, metrics

    s.trainer._train_step = observed
    s.loader.steps = mix['check_steps']
    s.trainer.train_epoch(0)
    clock.lap(f"{mix['check_steps']} checked steps (kernel build or load)")
    clock.report()
    s.trainer._train_step = step_fn
    s.checked_batches = list(s.loader.batches)
    s.loader.steps, s.loader.t0 = None, None
    return s


def window(s: State, seconds: float) -> dict:
    from wav2sleep_tpu_torch.ops import conv_k3

    run = s.run
    s.loader.seconds = seconds
    launches0 = conv_k3.LAUNCHES
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    out = s.trainer.train_epoch(1)
    peak = torch.cuda.max_memory_allocated(run.device) / 2**30 if run.cuda else 0.0
    steps = s.loader.yielded
    span = s.loader.t_end - s.loader.t0
    B = run.mix['batch_size']
    return {
        'metrics': {run.mix['rate_metric']: steps * B * 3600.0 / span, 'train_peak_gib': peak},
        'attempted': steps,
        'failed': 0 if np.isfinite(out['train_loss']) else steps,
        'counters': {'window_s': span, 'steps': steps, 'k1_launches': conv_k3.LAUNCHES - launches0,
                     'batch': B, 'dtype': run.mix['precision'], 'host_loader_frac': out['host_loader_frac']},
    }


def reference_steps(s: State, precision: str = 'f32', rows: slice = slice(None)) -> dict:
    """The reference's readings of the checked steps: losses, the first
    step's applied gradients, the parameters after the last step and,
    where the mix keeps one, the EMA after it (initialised to the weights,
    ``ema = d * ema + (1 - d) * params`` after each step from
    ``ema_start_step`` on)."""
    run, mix = s.run, s.run.mix
    P = {k: v.clone() for k, v in s.weights.items()}
    o = mix['optimizer']
    lr = rtrain.expdecay_lr(o['lr'], o['warmup_steps'], o['tau']) if o['scheduler'] == 'expdecay' else o['lr']
    opt = rtrain.AdamWRef(lr, o['weight_decay'], o['grad_clip'])
    act = torch.bfloat16 if mix['precision'] == 'bfloat16' else torch.float32
    es = rtrain.epoch_seed(run.seed, 0)
    d = mix['ema_decay']
    ema = {k: v.clone() for k, v in P.items()} if d is not None else None
    losses, g1 = [], None
    for step, idx in enumerate(s.checked_batches):
        x = {sig: torch.as_tensor(rows[idx], device=run.device) for sig, rows in s.loader.pool['x'].items()}
        y = torch.as_tensor(s.loader.pool['y'][idx], device=run.device)
        loss, applied = rtrain.train_step(P, opt, x, y, run.cfg, rtrain.step_seeds(es, step),
                                          mix['input_transport'], act, precision, rows)
        losses.append(loss)
        if step == 0:
            g1 = applied
        if ema is not None and step >= mix['ema_start_step']:
            for k, e in ema.items():
                e.mul_(d).add_(P[k], alpha=1.0 - d)
    return {'losses': losses, 'g1': g1, 'params': P, 'ema': ema}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(s: State, got: dict, want: dict) -> dict[str, dict]:
    """Per leaf, the gap of the first gradients' norms, of the parameters'
    changes' norms and, where both sides keep an EMA, of the EMA's changes'
    norms, each over the reference's norm of that leaf or of the median
    leaf, whichever is larger; the changes only for the leaves that the
    reference's gradient moves by more than round-off."""
    ng, nr = _norms(got['g1']), _norms(want['g1'])
    med_g = float(np.median(list(nr.values())))
    moved = [k for k in nr if nr[k] >= ROUNDOFF_LEAF * med_g]
    out = {'grad': {k: abs(ng[k] - nr[k]) / max(nr[k], med_g) for k in nr}}
    w0 = s.weights
    for key, name in (('params', 'change'), ('ema', 'ema')):
        if want.get(key) is None:
            continue
        mine = got.get(key) or w0  # a program that keeps no EMA reads as one left unchanged
        cg = _norms({k: mine[k] - w0[k] for k in moved})
        cr = _norms({k: want[key][k] - w0[k] for k in moved})
        med = float(np.median(list(cr.values())))
        out[name] = {k: abs(cg[k] - cr[k]) / max(cr[k], med) for k in moved}
    return out


def compare(s: State, got: dict, want: dict) -> dict:
    """The numbers of ``got`` (the program's readings, or a control's)
    against the reference's ``want``: the losses' relative gap, the worst
    of all steps and that of the first alone; the leaves' gaps of the first
    gradient, of the change and of the EMA's change, the worst leaf's
    (``<name>_gap``) and the median leaf's (``<name>_median_gap``). A cell
    compares those its limits name."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got['losses'], want['losses'])]
    out = {'loss_gap': max(losses), 'loss1_gap': losses[0]}
    for name, gaps in leaf_gaps(s, got, want).items():
        out[f'{name}_gap'] = max(gaps.values())
        out[f'{name}_median_gap'] = float(np.median(list(gaps.values())))
    return out


def program_readings(s: State) -> dict:
    b1 = 0.9  # AdamW's first-moment decay: mu after one step is (1 - b1) g
    return {'losses': [float(v) for v in s.losses[:s.run.mix['check_steps']]],
            'g1': {k: v / (1.0 - b1) for k, v in s.mu1.items()}, 'params': s.params_after, 'ema': s.ema_after}


def check(s: State) -> dict:
    got = program_readings(s)
    s.trainer = None
    harness.release()
    shutil.rmtree(s.log_dir, ignore_errors=True)
    return compare(s, got, reference_steps(s))


def calibrate(s: State, seconds: float) -> dict:
    """The program's readings of the checked steps; the control's (the
    reference in the precision below the configured one; below bf16 also
    with its forward alone in fp8, ``control_fwd``); and the fault of half
    the batch left out of the loss, planted in the reference. A state left
    unchanged reads 1 on the change by construction."""
    got = program_readings(s)
    s.trainer = None
    harness.release()
    shutil.rmtree(s.log_dir, ignore_errors=True)
    want = reference_steps(s)
    control = harness.CONTROL[s.run.mix['precision']]
    out = {'program': compare(s, got, want), 'control': compare(s, reference_steps(s, control), want)}
    if control == 'fp8':
        out['control_fwd'] = compare(s, reference_steps(s, 'fp8_fwd'), want)
    out['half_batch'] = compare(s, reference_steps(s, rows=slice(0, s.run.mix['batch_size'] // 2)), want)
    out['worst_leaf'] = {name: max(gaps, key=gaps.get) for name, gaps in leaf_gaps(s, got, want).items()}
    return out
