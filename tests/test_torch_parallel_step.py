"""The training step over two ranks (``gloo`` on the CPU, one torch thread a
rank, spawned by ``parallel.mesh.spawn`` with a timeout on the group and on
the launch), against the one-process port step on the same global batch and
against JAX's step on a 2-device CPU mesh, at ``tests/test_torch_train.py``'s
gates:

- the narrow flagship (mixer dropout 0: dropout draws per rank, so a group
  with dropout on is not the one-card step) over two steps with the flip
  and the masker on, which draw for the global batch;
- the same step with both off, against JAX's sharded step;
- a batch whose ranks hold unequal counts of ``-1`` labels: the loss is the
  global masked mean, which a mean of per-rank means is not;
- a batch-norm model, whose running statistics are the global batch's.

One launch runs every case, so the ranks start once.
"""

import itertools
import os
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wav2sleep_tpu.train import scheduler as jscheduler
from wav2sleep_tpu.train import step as jstep
from wav2sleep_tpu_torch import instantiate
from wav2sleep_tpu_torch.parallel import mesh as pmesh
from wav2sleep_tpu_torch.train import scheduler
from wav2sleep_tpu_torch.train import step as tstep

from . import torch_parallel_workers as workers
from .test_torch_model import uniform_kernel_weights
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_train import (
    ADAM_RATIO,
    NOISY_SHARE,
    PARAM_ATOL,
    SCHEDULE,
    STEP_OPT,
    STEP_TOL,
    _adam_mu,
    _as_torch_params,
    _batch,
    _narrow_pair,
    _noisy,
    _param_diffs,
)
from .train.test_trainer_smoke import MODEL_CFG

LAUNCH_TIMEOUT = 300  # seconds, for the group's collectives and the launch
STATS_TOL = 1e-5  # running statistics, two ranks against one process
GRAD_TOL = STEP_TOL  # each gradient, relative to its tensor's largest |g|


def _bn_cfg():
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in MODEL_CFG.items()}
    cfg['signal_encoders'] = {**cfg['signal_encoders'], 'norm': 'batch'}
    return cfg


def _smoke_batch(seed, B=4, S=6, labels=None):
    rng = np.random.default_rng(seed)
    x = {'ECG': rng.normal(size=(B, S * 1024)).astype(np.float32),
         'THX': rng.normal(size=(B, S * 256)).astype(np.float32)}
    y = rng.integers(0, 4, size=(B, S)).astype(np.float32) if labels is None else labels
    return x, y


def _shifted(batch):
    """Rank 1's rows (2 and 3) shifted by +3: the ranks' own batch
    statistics then differ from the global batch's."""
    x, y = batch
    return {k: v + np.array([0, 0, 3, 3], np.float32)[:, None] for k, v in x.items()}, y


@pytest.fixture(scope='module')
def cases():
    """Every case's arguments, and JAX's narrow pair."""
    jmodel, variables, tmodel = _narrow_pair()
    flagship = {'cfg': instantiate.target_config(**{**_flagship_cfg()}),
                'weights': {k: v.numpy() for k, v in tmodel.state_dict().items()}}
    x, y = _batch(B=4, S=2, seed=1)
    # The smoke model on the seed-0 weights with uniform dense kernels on
    # which the unequal case's spread was set (ROADMAP §C.22).
    small = {'cfg': MODEL_CFG, 'weights': {k: v.numpy() for k, v in
                                           uniform_kernel_weights(instantiate.build_model(MODEL_CFG)).state_dict().items()}}
    unequal = np.full((4, 6), -1.0, np.float32)
    unequal[0, 0] = 2.0  # rank 0: 1 scored epoch; rank 1: all 12
    unequal[2:] = np.random.default_rng(5).integers(0, 4, size=(2, 6))
    return {
        'augmented': dict(flagship, x=x, y=y, n_steps=2, masker=True, flip=True),
        'plain': dict(flagship, x=x, y=y, n_steps=1),
        'unequal': dict(small, **dict(zip('xy', _smoke_batch(3, labels=unequal)))),
        'batchnorm': dict(cfg=_bn_cfg(), weights=None, **dict(zip('xy', _shifted(_smoke_batch(4)))), n_steps=2),
    }, (jmodel, variables)


def _flagship_cfg():
    from wav2sleep_tpu_torch.models.wav2sleep import flagship_config

    cfg = flagship_config(32, 32)
    cfg['epoch_mixer']['dropout'] = cfg['sequence_mixer']['dropout'] = 0.0
    return cfg


@pytest.fixture(scope='module')
def ranks(cases):
    """Both ranks' results of every case, from one launch."""
    args, _ = cases
    out = pmesh.spawn(workers.step_cases, ['cpu', 'cpu'], args=(list(args.values()),), timeout=LAUNCH_TIMEOUT,
                      deadline=LAUNCH_TIMEOUT, threads=1)
    return [dict(zip(args, r)) for r in out]


def _one(case):
    return workers.run_steps(**case)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _ranks_agree(ranks, name):
    """Both ranks end every step with bit-equal parameters, statistics and
    metrics."""
    for s0, s1 in zip(ranks[0][name], ranks[1][name]):
        assert s0['loss'] == s1['loss'] and s0['grad_norm'] == s1['grad_norm']
        np.testing.assert_array_equal(s0['cmat'], s1['cmat'])
        for key in ('params', 'stats', 'grads'):
            for k in s0[key]:
                np.testing.assert_array_equal(s0[key][k], s1[key][k], err_msg=f'{name} {key} {k}')


def test_two_rank_step_with_flip_and_masker_is_the_one_process_step(cases, ranks):
    args, _ = cases
    _ranks_agree(ranks, 'augmented')
    one = _one(args['augmented'])
    for i, (got, want) in enumerate(zip(ranks[0]['augmented'], one)):
        rel = max(_rel(got['loss'], want['loss']), _rel(got['grad_norm'], want['grad_norm']))
        print(f'step {i}: relative |d loss|, |d grad norm| up to {rel:.3e} (gate {STEP_TOL:g})')
        assert rel <= STEP_TOL
        np.testing.assert_array_equal(got['cmat'], want['cmat'])
        for k, g in want['grads'].items():
            np.testing.assert_allclose(got['grads'][k], g, rtol=0, atol=GRAD_TOL * max(np.abs(g).max(), 1e-12),
                                       err_msg=k)
        d = max(np.abs(got['params'][k] - p).max() for k, p in want['params'].items())
        print(f'step {i}: max |d params| {d:.3e} (atol {PARAM_ATOL:g})')
        assert d <= PARAM_ATOL
    # The augmentations ran: the masked and flipped step is not the plain one.
    assert ranks[0]['augmented'][0]['loss'] != ranks[0]['plain'][0]['loss']


def test_two_rank_step_matches_jax_on_a_two_device_mesh(cases, ranks):
    """Flip and masker off (the two stacks' random streams differ): one step
    of the port's two ranks against JAX's step jitted over a 2-device CPU
    mesh on the same global batch and weights; the parameters as in
    ``tests/test_torch_train.py`` (Adam's noisy elements held to its reach)."""
    args, (jmodel, variables) = cases
    _ranks_agree(ranks, 'plain')
    x, y = args['plain']['x'], args['plain']['y']
    tx = jstep.make_optimizer(jscheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    params = variables['params']
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params))
    mesh = jax_make_mesh(jax.devices()[:2], data=2, model=1)
    fn = jstep.parallelize_train_step(jstep.make_train_step(jmodel, tx, 4, masker=None, flip_polarity=False), mesh,
                                      state, (x, y))
    with mesh:
        state, m = fn(state, (x, y), jax.random.PRNGKey(0))
    got = ranks[0]['plain'][0]
    for key in ('loss', 'grad_norm'):
        assert _rel(got[key], float(m[key])) <= STEP_TOL, key
    np.testing.assert_array_equal(got['cmat'], np.asarray(m['cmat']))
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    noisy = _noisy([(to_t(got['mu']), _as_torch_params(_adam_mu(state.opt_state)))])
    rest, inside, _ = _param_diffs(to_t(got['params']), state.params, noisy)
    n, total = sum(int(v.sum()) for v in noisy.values()), sum(v.numel() for v in noisy.values())
    reach = 2 * ADAM_RATIO * scheduler.exp_warmup_schedule(*SCHEDULE)(0)
    print(f'params against JAX: {rest:.3e} outside {n} of {total} noisy elements, {inside:.3e} inside')
    assert rest <= PARAM_ATOL and inside <= reach and n <= NOISY_SHARE * total


def test_loss_is_the_global_masked_mean(cases, ranks):
    """Rank 0 scores 1 epoch and rank 1 scores 12: the group's loss and
    gradients are the one-process step's on the global batch, and the mean
    of the two ranks' own means is far from it."""
    args, _ = cases
    _ranks_agree(ranks, 'unequal')
    case = args['unequal']
    want = _one(case)[0]
    got = ranks[0]['unequal'][0]
    assert _rel(got['loss'], want['loss']) <= STEP_TOL and _rel(got['grad_norm'], want['grad_norm']) <= STEP_TOL
    halves = [_one({**case, 'x': {k: v[r * 2:(r + 1) * 2] for k, v in case['x'].items()},
                    'y': case['y'][r * 2:(r + 1) * 2]})[0]['loss'] for r in (0, 1)]
    mean_of_means = sum(halves) / 2
    print(f'global mean {want["loss"]:.6f}, two ranks {got["loss"]:.6f}, mean of per-rank means {mean_of_means:.6f}')
    assert _rel(mean_of_means, want['loss']) > 100 * STEP_TOL


def test_batch_norm_statistics_are_global(cases, ranks):
    args, _ = cases
    _ranks_agree(ranks, 'batchnorm')
    one = _one(args['batchnorm'])
    assert one[0]['stats'], 'the model has no running statistics'
    for i, (got, want) in enumerate(zip(ranks[0]['batchnorm'], one)):
        for k, v in want['stats'].items():
            np.testing.assert_allclose(got['stats'][k], v, rtol=STATS_TOL, atol=STATS_TOL, err_msg=f'step {i} {k}')
        assert _rel(got['loss'], want['loss']) <= STEP_TOL
    # A rank's own statistics are not the global ones.
    local = _one({**args['batchnorm'], 'x': {k: v[:2] for k, v in args['batchnorm']['x'].items()},
                  'y': args['batchnorm']['y'][:2], 'n_steps': 1})[0]['stats']
    key = next(k for k in local if k.endswith('running_mean'))
    assert np.abs(local[key] - one[0]['stats'][key]).max() > 100 * STATS_TOL


def test_ranks_building_at_once_end_on_one_library(tmp_path):
    """Two ranks build the native host library into one empty folder at once
    (the temporary file is per process, renamed into place): one library,
    no temporary left, and both ranks compute with it."""
    build_dir = tmp_path / 'native'
    build_dir.mkdir()
    r0, r1 = pmesh.spawn(workers.build_native_rank, ['cpu', 'cpu'], args=(str(build_dir),),
                         timeout=LAUNCH_TIMEOUT, deadline=LAUNCH_TIMEOUT, threads=1)
    assert sorted(p.name for p in build_dir.iterdir()) == [os.path.basename(r0['library'])]
    assert r0['library'] == r1['library']
    np.testing.assert_array_equal(r0['z'], r1['z'])
    assert np.isfinite(r0['z']).all()


def test_a_run_longer_than_the_timeout_is_not_cut(monkeypatch):
    """``timeout`` bounds each collective, not the run: ranks that work for
    longer than it between collectives that succeed finish, and the launch
    sets no limit of its own even on a clock that runs an hour a read."""
    clock = itertools.count(step=3600.0)
    monkeypatch.setattr(pmesh, 'time', types.SimpleNamespace(monotonic=lambda: next(clock)))
    t0 = time.monotonic()
    out = pmesh.spawn(workers.slow_rank, ['cpu', 'cpu'], args=(3.0, 3), timeout=5, threads=1)
    assert out == [8.0, 8.0]  # 1 doubled by each of 3 sums over 2 ranks
    assert time.monotonic() - t0 > 9.0


def test_a_launch_deadline_ends_every_rank():
    """``deadline`` bounds the whole launch: past it every rank is ended and
    the launch raises."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r'did not finish within 3 s \(\[0, 1\] still running\)'):
        pmesh.spawn(workers.slow_rank, ['cpu', 'cpu'], args=(60.0, 1), timeout=LAUNCH_TIMEOUT, deadline=3,
                    threads=1)
    assert time.monotonic() - t0 < 30


def test_the_step_refuses_a_model_axis():
    """The model axis is 1 for this family: a step over another raises."""
    mesh = pmesh.make_mesh(['cpu', 'cpu'], data=1, model=2)
    model = workers.build(MODEL_CFG, None)
    opt = tstep.AdamW(1e-3, 0.0, None, 0.9, 0.999, 1e-8, 1)
    with pytest.raises(ValueError, match='model=2: the model axis is 1 for this model family'):
        tstep.make_train_step(model, opt, 4, mesh=mesh)


def test_a_failed_rank_ends_the_launch():
    """A rank that raises ends every rank and raises its traceback at once:
    the other rank, waiting in a collective, is not left to the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='rank 1 failed:(.|\n)*rank 1 fails on purpose'):
        pmesh.spawn(workers.failing_rank, ['cpu', 'cpu'], timeout=LAUNCH_TIMEOUT, deadline=LAUNCH_TIMEOUT, threads=1)
    assert time.monotonic() - t0 < LAUNCH_TIMEOUT / 2
