"""The port's training step on the batch-norm model kinds against the JAX
package's on the CPU: three steps of a narrow batch-norm wav2sleep and two
of the full-length SleepPPG-Net (feature_dim 32) on the same weights and
batch, remat off and dropout 0 (the two stacks' dropout masks cannot
agree), each step's loss and gradient norm, the running statistics after
each step, the parameters and EMA after the last (with the Adam rule of
tests/test_torch_train.py, ROADMAP §C.7), and the eval step on the running
statistics; then the port's remat-on step against its remat-off step,
running statistics included, in f32 and in bf16."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu.convert import convert_state_dict
from wav2sleep_tpu.instantiate import instantiate
from wav2sleep_tpu.train import scheduler as jscheduler
from wav2sleep_tpu.train import step as jstep
from wav2sleep_tpu_torch import instantiate as tinstantiate
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.models.norms import BatchNorm
from wav2sleep_tpu_torch.train import scheduler
from wav2sleep_tpu_torch.train import step as tstep

from .test_torch_families import (PPG_LEN, TOL, check_stats, model_pair, ppgnet_config, wav2sleep_config,
                                  wav2sleep_inputs)
from .test_torch_train import (ADAM_RATIO, NOISY_MOMENT, NOISY_SHARE, PARAM_ATOL, SCHEDULE, STEP_OPT, STEP_TOL,
                               _adam_mu, _Capture)

# name: (config, steps, each step from the port's state, gradient norm bound,
# share of noisy elements)
KINDS = {
    # Batch norm in the encoders and in the sequence mixer (no K1 path).
    'batch_norm_wav2sleep': (wav2sleep_config(enc_norm='batch', seq_norm='batch'), 3, False, STEP_TOL, NOISY_SHARE),
    # At 1,228,800 samples each stack's f32 gradient is ~3% (L2) from the
    # f64 one, the port's the nearer (test_ppgnet_gradient_against_f64): the
    # gradient norm is held to 1e-3, the JAX package's own SleepPPG-Net
    # parity bound (tests/model/test_torch_parity.py), and the Adam moments
    # of up to 20% of the elements part by over 10% (held to Adam's reach).
    'ppgnet': (ppgnet_config(feature_dim=32), 2, True, 1e-3, 0.2),
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _batch(name, seed=1):
    """A seeded batch: B=2 nights of 2 epochs (one without THX), or one
    ten-hour PPG night; labels -1..3."""
    rng = np.random.default_rng(seed)
    if name == 'ppgnet':
        x = {'PPG': rng.normal(size=(1, PPG_LEN)).astype(np.float32)}
        y = rng.integers(-1, 4, size=(1, 1200)).astype(np.float32)
    else:
        x = wav2sleep_inputs(S=2, seed=seed)
        x['THX'][1] = -np.inf
        y = rng.integers(-1, 4, size=(2, 2)).astype(np.float32)
    return x, y


def _x0(name):
    return np.zeros((1, PPG_LEN), np.float32) if name == 'ppgnet' else \
        {k: v[:1] for k, v in wav2sleep_inputs(S=2).items()}


def _as_torch(jax_params, family, batch_stats):
    """A JAX parameter tree (parameters, gradients, a moment) under the
    port's names; the running statistics tell batch norm's [C] affines
    from the [1, C, 1] of the other norms, and are dropped."""
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, {'params': jax_params, 'batch_stats': batch_stats}),
                            family)
    return {k: v for k, v in sd.items() if not k.endswith(('running_mean', 'running_var', 'num_batches_tracked'))}


def _variables_of(state_dict, family):
    """The JAX variables of a port ``state_dict``, on copies: the port's
    step updates its tensors in place while JAX may still read them."""
    return convert_state_dict({k: v.detach().clone() for k, v in state_dict.items()}, family)


def _with_moments(opt_state, mu, nu):
    """An optax chain state with Adam's moments replaced."""
    if hasattr(opt_state, 'mu') and hasattr(opt_state, 'nu'):
        return opt_state._replace(mu=mu, nu=nu)
    if isinstance(opt_state, tuple):
        items = [_with_moments(s, mu, nu) for s in opt_state]
        return type(opt_state)(*items) if hasattr(opt_state, '_fields') else tuple(items)
    return opt_state


def _synced(jstate, tstate, tmodel, family):
    """JAX's state set to the port's: parameters, running statistics, EMA
    and Adam's moments (the step and Adam's count agree already)."""
    to_jax = lambda d: _variables_of(d, family)['params']  # noqa: E731
    variables = _variables_of(tmodel.state_dict(), family)
    names = list(tstate.params)
    mu, nu = (to_jax(dict(zip(names, m))) for m in (tstate.opt_state.mu, tstate.opt_state.nu))
    return jstate.replace(params=variables['params'], batch_stats=variables['batch_stats'],
                          ema_params=to_jax(tstate.ema_params), opt_state=_with_moments(jstate.opt_state, mu, nu))


def _param_gate(ours, theirs, noisy):
    """max |d| outside and inside the noisy elements, and their count and total."""
    d = {k: (ours[k] - theirs[k]).abs() for k in theirs}
    return (max(float(torch.where(noisy[k], 0.0, v).max()) for k, v in d.items()),
            max(float(torch.where(noisy[k], v, 0.0).max()) for k, v in d.items()),
            sum(int(v.sum()) for v in noisy.values()), sum(v.numel() for v in noisy.values()))


@pytest.fixture(scope='module', params=list(KINDS))
def trajectory(request):
    """Both stacks' steps on one batch (flip and masker off, EMA 0.9 from
    optimizer step 1), from one init. The narrow wav2sleep runs free; each
    SleepPPG-Net step starts JAX from the port's state (``_synced``), since
    after step 1 the two runs part chaotically (``test_ppgnet_gradient_
    against_f64``). Per step: loss, gradient norm, the running statistics
    against JAX's update from the port's state before the step (and, free,
    against JAX's run), and the parameters and EMA against JAX's with the
    noisy elements since the last common state. Then both eval steps."""
    name = request.param
    cfg, n_steps, sync, _, _ = KINDS[name]
    family = tinstantiate.model_family(cfg)
    jmodel, variables, tmodel = model_pair(cfg, _x0(name))
    x, y = _batch(name)
    tx = jstep.make_optimizer(jscheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    params = variables['params']
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                              batch_stats=variables['batch_stats'], ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jfn = jax.jit(jstep.make_train_step(jmodel, tx, 4, masker=None, flip_polarity=False, family=family,
                                        ema_decay=0.9, ema_start_step=1))
    opt = tstep.make_optimizer(scheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    tstate = tstep.init_train_state(tmodel, opt, ema=True)
    tfn = tstep.make_train_step(tmodel, opt, 4, masker=None, flip_polarity=False, ema_decay=0.9, ema_start_step=1,
                                family=family)
    xin = x['PPG'] if family == 'ppgnet' else x
    jstats = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=['batch_stats'])[1]['batch_stats'])
    lr = scheduler.exp_warmup_schedule(*SCHEDULE)
    steps, noisy, reach = [], None, 0.0
    for i in range(n_steps):
        if sync and i:
            jstate = _synced(jstate, tstate, tmodel, family)
            noisy, reach = None, 0.0
        want = jstats(_variables_of(tmodel.state_dict(), family), xin)
        jstate, jm = jfn(jstate, ({k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(y)), jax.random.PRNGKey(0))
        tstate, tm = tfn(tstate, ({k: _t(v) for k, v in x.items()}, _t(y)), 0)
        s = {k: (float(jm[k]), float(tm[k])) for k in ('loss', 'grad_norm')}
        s['stats'] = check_stats(tmodel, want, family, f'{name} step {i + 1}, from the port\'s state')
        s['drift'] = check_stats(tmodel, jstate.batch_stats, family, f'{name} step {i + 1}, JAX\'s run',
                                 gate=sync or i == 0)
        as_torch = lambda tree: _as_torch(tree, family, jstate.batch_stats)  # noqa: E731
        ours, theirs = dict(zip(tstate.params, tstate.opt_state.mu)), as_torch(_adam_mu(jstate.opt_state))
        flags = {k: (ours[k] - theirs[k]).abs() > NOISY_MOMENT * theirs[k].abs() for k in ours}
        noisy = flags if noisy is None else {k: noisy[k] | flags[k] for k in noisy}
        reach += 2 * ADAM_RATIO * lr(i)
        s['params'] = _param_gate({k: v.detach() for k, v in tstate.params.items()}, as_torch(jstate.params), noisy)
        s['ema'] = _param_gate(tstate.ema_params, as_torch(jstate.ema_params), noisy)
        s['reach'] = reach
        s['moved'] = max(float((tstate.params[k].detach() - tstate.ema_params[k]).abs().max()) for k in noisy)
        steps.append(s)
    nbt = {int(v) for k, v in tstate.batch_stats.items() if k.endswith('num_batches_tracked')}
    # The eval step on the running statistics, with the parameters and with the EMA.
    jeval = jax.jit(jstep.make_eval_step(jmodel, 4, family))
    teval = tstep.make_eval_step(tmodel, 4, family)
    evals = {}
    if sync:
        jstate = _synced(jstate, tstate, tmodel, family)
    for which, jp, tp in (('params', jstate.params, tstate.params), ('ema', jstate.ema_params, tstate.ema_params)):
        jout = jeval(jp, jstate.batch_stats, ({k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(y)))
        tout = teval(tp, ({k: _t(v) for k, v in x.items()}, _t(y)))
        evals[which] = (float(jout['loss']), float(tout['loss']), np.asarray(jout['preds']), tout['preds'].numpy())
    return dict(name=name, steps=steps, nbt=nbt, evals=evals)


def test_steps_track_jax(trajectory):
    """Per step: loss within STEP_TOL relative, gradient norm within the
    kind's bound, the running statistics (``check_stats``), and the
    parameters and EMA within PARAM_ATOL outside the noisy elements, within
    Adam's reach inside them, which are at most the kind's share; each
    batch norm updated once per step."""
    t = trajectory
    name = t['name']
    _, n_steps, _, gn_tol, share = KINDS[name]
    for i, s in enumerate(t['steps']):
        rel = {k: abs(s[k][1] - s[k][0]) / abs(s[k][0]) for k in ('loss', 'grad_norm')}
        (p_out, p_in, n, total), (e_out, e_in, _, _) = s['params'], s['ema']
        print(f"{name} step {i + 1}: relative |d loss| {rel['loss']:.3e} (bound {STEP_TOL:g}), |d grad norm| "
              f"{rel['grad_norm']:.3e} (bound {gn_tol:g}); running statistics {s['stats']:.3e} from JAX's update, "
              f"{s['drift']:.3e} from JAX's run; params {p_out:.3e}, EMA {e_out:.3e} (atol {PARAM_ATOL:g}) outside "
              f"the {n} of {total} noisy elements, {p_in:.3e} and {e_in:.3e} inside (reach {s['reach']:.3e}); "
              f"params and EMA apart by {s['moved']:.3e}")
        assert rel['loss'] <= STEP_TOL and rel['grad_norm'] <= gn_tol, rel
        assert p_out <= PARAM_ATOL and e_out <= PARAM_ATOL
        assert max(p_in, e_in) <= s['reach'] and n <= share * total
    assert t['nbt'] == {n_steps}
    assert t['steps'][-1]['moved'] > 10 * PARAM_ATOL  # the EMA gate is not vacuous
    assert t['steps'][0]['grad_norm'][0] > STEP_OPT['grad_clip']  # the clip is active


def test_eval_step_reads_the_running_statistics(trajectory):
    """The eval step with the parameters and with the EMA, both on the one
    set of running statistics, against JAX's eval step."""
    for which, (jl, tl, jp, tp) in trajectory['evals'].items():
        print(f"{trajectory['name']} eval ({which}): loss JAX {jl:.6f}, port {tl:.6f}")
        assert abs(tl - jl) <= STEP_TOL * abs(jl)
        assert (tp == jp).mean() >= 0.99


# The remat cases: the remat switch is the encoders' (wav2sleep) or the
# window blocks' (SleepPPG-Net).
REMAT_CASES = {
    'batch_norm_wav2sleep-f32': (KINDS['batch_norm_wav2sleep'][0], None),
    'batch_norm_wav2sleep-bf16': (KINDS['batch_norm_wav2sleep'][0], torch.bfloat16),
    'ppgnet-f32': (KINDS['ppgnet'][0], None),
}


def _one_step(cfg, remat, compute_dtype=None, seed=2):
    """The port's step 1 (gradients captured, nothing applied) with remat on
    or off: loss, gradients and the running statistics after it."""
    family = tinstantiate.model_family(cfg)
    cfg = dict(cfg)
    if family == 'ppgnet':
        cfg['remat'] = remat
    else:
        cfg['signal_encoders'] = {**cfg['signal_encoders'], 'remat': remat}
    model = tinstantiate.build_model(cfg)
    opt = _Capture()
    state = tstep.init_train_state(model, opt)
    step = tstep.make_train_step(model, opt, 4, flip_polarity=False, compute_dtype=compute_dtype, family=family)
    x, y = _batch(family, seed=seed)
    _, m = step(state, ({k: _t(v) for k, v in x.items()}, _t(y)), 0)
    return float(m['loss']), dict(zip(state.params, opt.grads)), {k: v.clone() for k, v in state.batch_stats.items()}


@pytest.mark.parametrize('case', REMAT_CASES)
def test_remat_step_equals_the_plain_step(case):
    """Rematerialised blocks recompute their forward in the backward; batch
    norm there must not take a second momentum step. Remat on and off give
    the same loss, gradients and running statistics, each batch norm
    updated once, its statistics in f32 under the bf16 step too."""
    cfg, compute_dtype = REMAT_CASES[case]
    (l0, g0, s0), (l1, g1, s1) = (_one_step(cfg, remat, compute_dtype) for remat in (False, True))
    assert np.isfinite(l0) and l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6 if compute_dtype is None else 0)
    assert s0.keys() == s1.keys() and any(k.endswith('running_var') for k in s0)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0)
        if k.endswith('num_batches_tracked'):
            assert int(s1[k]) == 1, k
        else:
            assert s1[k].dtype == torch.float32
    n_bn = sum(isinstance(m, BatchNorm) for m in tinstantiate.build_model(cfg).modules())
    print(f'{case}: remat on == off over {len(g0)} gradients and {n_bn} batch norms')


def test_bf16_batch_norm_over_few_values_is_finite_as_in_jaxs_jit():
    """Batch norm's variance is E[x^2] - mean^2; over the sequence mixer's
    B * S = 4 values a channel it goes negative in bf16 arithmetic (JAX's
    eager bf16 forward is NaN here). JAX's jitted program, which training
    runs, keeps the fused statistics in f32 and is finite; the port
    normalizes a bf16 input in f32. The port's bf16 train-mode logits are
    within twice JAX's own bf16-vs-f32 error of the f32 logits (the method
    of ROADMAP §C.2), on the port's seed-0 weights."""
    cfg = KINDS['batch_norm_wav2sleep'][0]
    model = tinstantiate.build_model(cfg)
    jmodel = instantiate(cfg)
    variables = convert_state_dict({k: v.clone() for k, v in model.state_dict().items()})
    x, _ = _batch('wav2sleep', seed=2)
    forward = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=['batch_stats'])[0])
    out = {}
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), variables['params'])
        want = forward({'params': params, 'batch_stats': variables['batch_stats']},
                       {k: jnp.asarray(v, jdtype) for k, v in x.items()})
        m = tinstantiate.build_model(cfg)
        m.load_state_dict(model.state_dict())
        with torch.no_grad():
            got = m.to(dtype).train()({k: _t(v).to(dtype) for k, v in x.items()})
        out[str(dtype)[6:]] = (np.asarray(want, np.float32), got.float().numpy())
    (j32, t32), (j16, t16) = out['float32'], out['bfloat16']
    jax_err, port_err = np.abs(j16 - j32).max(), np.abs(t16 - t32).max()
    print(f'bf16 train-mode logits against f32: port {port_err:.3e}, JAX (jitted) {jax_err:.3e}; f32 port vs JAX '
          f'{np.abs(t32 - j32).max():.3e}')
    assert np.isfinite(t16).all() and np.isfinite(j16).all()
    np.testing.assert_allclose(t32, j32, atol=TOL, rtol=TOL)
    assert port_err <= 2 * max(jax_err, 2.0**-8 * np.abs(j32).max())


def test_ppgnet_gradient_against_f64():
    """Where the two stacks part on SleepPPG-Net: step 1's gradients (batch
    norm over 1,228,800 samples a channel in the first window blocks) of
    the port in f32 and of JAX in f32 against the port's in f64. The port's
    gradient and gradient norm are as close to the f64 ones as JAX's
    (within twice its distance); the loss within 1e-5 relative."""
    from wav2sleep_tpu.train.metrics import cross_entropy_ignore_index as jce
    from wav2sleep_tpu_torch.train.metrics import cross_entropy_ignore_index as tce

    cfg = KINDS['ppgnet'][0]
    jmodel, variables, tmodel = model_pair(cfg, _x0('ppgnet'))
    x, y = _batch('ppgnet')

    def jloss(p):
        logits, _ = jmodel.apply({'params': p, 'batch_stats': variables['batch_stats']}, jnp.asarray(x['PPG']),
                                 train=True, mutable=['batch_stats'])
        return jce(logits.reshape(-1, 4), jnp.asarray(y).reshape(-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables['params'])
    grads = {'JAX f32': (float(jl), _as_torch(jg, 'ppgnet', variables['batch_stats']))}
    for dtype in (torch.float32, torch.float64):
        model = tinstantiate.build_model(cfg)
        model.load_state_dict(tmodel.state_dict())
        model.to(dtype).train()
        loss = tce(model(_t(x['PPG']).to(dtype)).reshape(-1, 4), _t(y).reshape(-1))
        g = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        grads[f'port {str(dtype)[6:]}'] = (float(loss.detach()), {n: v.double() for n, v in zip(names, g)})
    l64, g64 = grads.pop('port float64')
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum() for v in g.values())))  # noqa: E731
    dist = {k: float(torch.sqrt(sum(((g[n].double() - g64[n]) ** 2).sum() for n in g64)))
            for k, (_, g) in grads.items()}
    gn = {k: abs(norm(g) - norm(g64)) for k, (_, g) in grads.items()}
    worst = max(g64, key=lambda n: float((grads['port float32'][1][n] - g64[n]).norm()))
    print(f'SleepPPG-Net step 1 against f64 (|g| {norm(g64):.4f}): gradient distance {dist}, |d grad norm| {gn}; '
          f'the largest part in {worst} (f64 |g| {float(g64[worst].norm()):.3f}); losses '
          f'{ {k: v[0] for k, v in grads.items()} }, f64 {l64:.7f}')
    assert dist['port float32'] <= 2 * dist['JAX f32'] and gn['port float32'] <= 2 * gn['JAX f32']
    assert abs(grads['port float32'][0] - l64) <= 1e-5 * l64
