"""The port's training step (wav2sleep_tpu_torch.train, ops.q8_transport)
against the JAX package's on the CPU, on seeded numpy inputs: the metrics,
the schedule and the plateau controller, the masker and the flip (by
statistics: the RNG streams differ), the q8/q16 codecs, the optimizer
against optax, the whole step over three steps and one q8 step on the same
weights and batch, the bf16 step, remat, and K1/K2's gradients against the
Pallas kernels' ``custom_vjp`` (interpreted)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_model
from wav2sleep_tpu.instantiate import instantiate
from wav2sleep_tpu.ops import block_domain as jbd
from wav2sleep_tpu.ops import pallas_conv
from wav2sleep_tpu.ops import q8_transport as jq8
from wav2sleep_tpu.settings import COLS_TO_SAMPLES_PER_EPOCH as SPE
from wav2sleep_tpu.train import metrics as jmetrics
from wav2sleep_tpu.train import scheduler as jscheduler
from wav2sleep_tpu.train import step as jstep
from wav2sleep_tpu_torch import train_bench
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config
from wav2sleep_tpu_torch.ops import conv_k3 as k1
from wav2sleep_tpu_torch.ops import q8_transport as q8
from wav2sleep_tpu_torch.train import metrics, scheduler
from wav2sleep_tpu_torch.train import step as tstep
from wav2sleep_tpu_torch.train.masker import SignalMasker, invert_signals, validate_batch

from .test_torch_model import jax_random_variables

SIGNALS = ('ABD', 'THX', 'ECG', 'PPG')
STEP_TOL = 5e-4  # loss and gradient norm per step, relative: the forward's gate
PARAM_ATOL = 1e-4  # parameters and EMA after the steps
STEP_OPT = dict(weight_decay=1e-4, grad_clip=1.0)  # optax's b1, b2 and eps (1e-8)
SCHEDULE = (1e-3, 2, 10.0)  # warm-up over 2 updates, then decay
# The parameter gate's one exception. An element whose Adam first moment
# the two stacks put more than 10% apart after some step has a gradient
# within their f32 noise; with eps 1e-8 Adam moves such an element by up to
# lr whatever its gradient's size (g / (|g| + eps) is about +-1 down to
# |g| ~ 1e-8), so the noise decides its move. These elements are held to
# what Adam can do: two runs part by at most 2 * ADAM_RATIO * (sum of lr),
# ADAM_RATIO bounding |m_hat| / sqrt(v_hat) over four steps (1.0068 by
# Cauchy-Schwarz on the moments' weights; weight decay adds 1e-4 of |p|).
NOISY_MOMENT = 0.1
ADAM_RATIO = 1.01
NOISY_SHARE = 0.01  # the exception covers at most 1% of the elements
# q8 decode against JAX's, in f32 ulps: both compute sign(c) * expm1(|c|
# log(256) / 127) / 255 * peak in f32; the port's equals that formula with a
# correctly rounded expm1 bit for bit, and is within Q8_ULPS of JAX's at
# every code where XLA's expm1 is within 1 ulp of correctly rounded (it is
# up to 2.4 ulps off at a few small codes on the CPU: ROADMAP §C.6).
Q8_ULPS = 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize('smoothing', [0.0, 0.1])
def test_cross_entropy_and_confusion_matrix_match_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(300, 4)) * 3).astype(np.float32)
    labels = rng.integers(-1, 4, size=300).astype(np.float32)
    want = float(jmetrics.cross_entropy_ignore_index(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(metrics.cross_entropy_ignore_index(_t(logits), _t(labels), smoothing))
    assert got == pytest.approx(want, rel=1e-6)
    # bf16 logits: the loss is still computed in f32.
    assert metrics.cross_entropy_ignore_index(_t(logits).bfloat16(), _t(labels), smoothing).dtype == torch.float32
    cm = metrics.confusion_matrix(_t(logits).reshape(3, 100, 4), _t(labels).reshape(3, 100), 4)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jmetrics.confusion_matrix(
        jnp.asarray(logits).reshape(3, 100, 4), jnp.asarray(labels).reshape(3, 100), 4)))
    assert int(cm.sum()) == int((labels >= 0).sum())
    all_ignored = metrics.cross_entropy_ignore_index(_t(logits), torch.full((300,), -1.0))
    assert float(all_ignored) == 0.0


# ---------------------------------------------------------------- scheduler


def test_schedule_matches_jax_at_every_count():
    lr_max, warmup, tau = 1e-3, 2000, 10000.0
    counts = np.arange(5001)
    want = np.asarray(jax.vmap(jscheduler.exp_warmup_schedule(lr_max, warmup, tau))(jnp.asarray(counts)))
    ours = scheduler.exp_warmup_schedule(lr_max, warmup, tau)
    got = np.array([ours(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert ours(warmup - 1) == lr_max and ours(0) == lr_max / warmup


def test_plateau_trace_matches_jax():
    trace = [1.0, 0.9, 0.91, 0.92, 0.93, 0.94, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.49, 0.7]
    kw = dict(factor=0.1, patience=1, min_lr=1e-5, base_lr=1e-3)
    ours, theirs = scheduler.PlateauController(**kw), jscheduler.PlateauController(**kw)
    assert [ours.update(v) for v in trace] == [theirs.update(v) for v in trace]
    assert ours.state_dict() == theirs.state_dict()
    fresh = scheduler.PlateauController(**kw)
    fresh.load_state_dict(json.loads(json.dumps(ours.state_dict())))
    assert fresh.update(0.1) == ours.update(0.1)


# ---------------------------------------------------------------- masker


def make_signals(B, missing=None):
    rng = np.random.default_rng(0)
    sig = {'ECG': rng.normal(size=(B, 32)), 'PPG': rng.normal(size=(B, 32)), 'THX': rng.normal(size=(B, 16))}
    for name, rows in (missing or {}).items():
        sig[name][rows] = -np.inf
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sig.items()}


def _missing(out):
    return torch.stack([torch.isinf(v[:, 0]) for v in out.values()], dim=-1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _within_4_sigma(frac, p, n):
    return abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / n)


def test_masker_keeps_a_survivor_and_existing_gaps():
    masker = SignalMasker({'ECG': 0.9, 'PPG': 0.9, 'THX': 0.9}, backups=['ECG', 'PPG'])
    x = make_signals(4000, missing={'PPG': slice(0, 1000)})
    out = masker(_gen(0), x)
    assert not bool(_missing(out).all(dim=-1).any())
    assert bool(torch.isinf(out['PPG'][:1000]).all())  # missing rows stay missing
    kept = ~torch.isinf(out['ECG'][:, 0])
    torch.testing.assert_close(out['ECG'][kept], x['ECG'][kept], rtol=0, atol=0)  # survivors untouched
    # Rows 0..999 have no PPG, so when all drop their survivor is ECG.
    assert bool((~torch.isinf(out['ECG'][:1000, 0]) | ~torch.isinf(out['THX'][:1000, 0])).all())


def test_masker_drop_rates_and_survivor_weights():
    n = 4000
    masker = SignalMasker({'ECG': 0.5, 'PPG': 0.0, 'THX': 0.3}, backups=['PPG'])
    out = masker(_gen(1), make_signals(n))
    for name, p in (('ECG', 0.5), ('THX', 0.3), ('PPG', 0.0)):
        frac = float(torch.isinf(out[name][:, 0]).float().mean())
        assert _within_4_sigma(frac, p, n), (name, frac)
    # Without backups an all-dropped night's survivor is drawn in
    # proportion to the keep probabilities (THX's is 0, so it never
    # survives). With ECG kept w.p. 0.1 and PPG w.p. 0.5, a night keeps ECG
    # alone w.p. 0.1 * 0.5 + 0.9 * 0.5 * 0.1 / 0.6 and one channel w.p.
    # 1 - 0.1 * 0.5; a uniform survivor would give ECG 0.29 of those nights.
    out = SignalMasker({'ECG': 0.9, 'PPG': 0.5, 'THX': 1.0})(_gen(2), make_signals(n))
    keep = ~_missing(out)
    assert bool(keep.any(dim=-1).all()) and not bool(keep[:, 2].any())
    single = keep.sum(dim=-1) == 1
    want = (0.1 * 0.5 + 0.9 * 0.5 * 0.1 / 0.6) / (1 - 0.1 * 0.5)
    assert _within_4_sigma(float(keep[single, 0].float().mean()), want, int(single.sum()))


def test_masker_leaves_nights_without_a_survivor_as_they_were():
    masker = SignalMasker({'ECG': 1.0, 'THX': 1.0}, backups=['PPG'])
    x = make_signals(64, missing={'PPG': slice(0, 32)})
    out = masker(_gen(3), x)
    # Rows 0..31: every channel drops and no backup is present -> unchanged.
    for name in x:
        torch.testing.assert_close(out[name][:32], x[name][:32], rtol=0, atol=0)
    # Rows 32..: PPG (p = 0) survives, the others drop.
    assert bool(torch.isinf(out['ECG'][32:]).all()) and bool(torch.isfinite(out['PPG'][32:]).all())


def test_masker_and_flip_refusals_and_reproducibility():
    with pytest.raises(ValueError):
        SignalMasker({'ECG': 1.5})
    with pytest.raises(ValueError, match='all signals unavailable'):
        validate_batch(make_signals(4, missing={'ECG': slice(0, 1), 'PPG': slice(0, 1), 'THX': slice(0, 1)}))
    validate_batch(make_signals(4, missing={'ECG': slice(0, 1)}))
    masker = SignalMasker({'ECG': 0.5, 'PPG': 0.5, 'THX': 0.5}, backups=['ECG'])
    x = make_signals(256)
    a, b, c = (masker(_gen(s), x) for s in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in x) and not all(torch.equal(a[k], c[k]) for k in x)
    f1, f2 = invert_signals(_gen(5), x), invert_signals(_gen(5), x)
    assert all(torch.equal(f1[k], f2[k]) for k in x)


def test_flip_signs_whole_rows_at_half_rate():
    n = 4000
    x = make_signals(n)
    out = invert_signals(_gen(0), x)
    for name in x:
        ratio = out[name] / x[name]
        sign = ratio[:, :1]
        assert set(sign.unique().tolist()) == {-1.0, 1.0}
        assert bool((ratio == sign).all())  # whole rows flip together
        assert _within_4_sigma(float((sign < 0).float().mean()), 0.5, n)
    # Rows flip independently across signals.
    assert not torch.equal(out['ECG'][:, 0] / x['ECG'][:, 0], out['PPG'][:, 0] / x['PPG'][:, 0])
    inf = invert_signals(_gen(0), {'ECG': torch.full((8, 4), -torch.inf)})['ECG']
    assert bool(torch.isinf(inf).all())  # a missing row stays missing


# ---------------------------------------------------------------- q8 / q16


def _rows():
    rng = np.random.default_rng(5)
    rows = []
    for scale in (1e-3, 1.0, 480.0):
        w = (rng.normal(size=5000) * scale).astype(np.float32)
        w[::11] = 0.0
        w[7] = -np.abs(w).max() * 1.5  # a negative peak
        rows.append(w)
    rows.append(np.zeros(5000, np.float32))
    return np.stack(rows)


def test_encoders_match_jax_code_for_code():
    rows = _rows()
    for r in rows:
        got, want = q8.encode_row_numpy(r), jq8.encode_row_numpy(r)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[2] == want[2]
    batch = {'ECG': rows.copy(), 'THX': rows[:, :1000].copy()}
    batch['THX'][1] = -np.inf  # a missing row
    for ours, theirs in ((q8.encode_batch, jq8.encode_batch), (q8.encode_batch_q16, jq8.encode_batch_q16)):
        slot = {}
        got, want = ours(batch, slot=slot), theirs(batch)
        assert ours(batch, slot=slot)['ECG'][0] is got['ECG'][0]  # pooled buffers are reused
        for k in batch:
            for a, b in zip(got[k], want[k]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    mixed = rows[:1].copy()
    mixed[0, 3] = np.inf
    for encode in (q8.encode_batch, q8.encode_batch_q16):
        with pytest.raises(ValueError, match='mixes finite'):
            encode({'ECG': mixed})


def _q8_correctly_rounded(codes, peaks):
    """The q8 decode's f32 formula with a correctly rounded expm1 (f64,
    rounded to f32) of the same f32 argument."""
    a = np.abs(codes.astype(np.float32)) * np.float32(np.log(256.0) / 127)
    mag = np.expm1(a.astype(np.float64)).astype(np.float32) * np.float32(1.0 / 255.0)
    return np.sign(codes).astype(np.float32) * mag * peaks.astype(np.float32)[:, None]


def _xla_expm1_off_codes():
    """The codes |c| at which XLA's f32 expm1 of the decode's argument is
    more than 1 ulp from the correctly rounded value."""
    a = np.arange(128, dtype=np.float32) * np.float32(np.log(256.0) / 127)
    cr = np.expm1(a.astype(np.float64)).astype(np.float32)
    return np.abs(np.asarray(jnp.expm1(jnp.asarray(a))).astype(np.float64) - cr) > np.spacing(cr)


def _check_q8(codes, peaks, got, want, what):
    """The port's q8 decode ``got`` of ``codes`` [N, T] at ``peaks`` [N]:
    bit for bit the correctly rounded formula, and within Q8_ULPS of JAX's
    ``want`` wherever XLA's expm1 is within 1 ulp. Returns the ulps from
    JAX's at the codes where it is not."""
    np.testing.assert_array_equal(got, _q8_correctly_rounded(codes, peaks))
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    off = _xla_expm1_off_codes()[np.abs(codes.astype(np.int64))]
    print(f'q8 decode {what}: max {ulps[~off].max():g} f32 ulps from JAX\'s where XLA\'s expm1 is within 1 ulp, '
          f'{ulps[off].max(initial=0):g} at codes {sorted(set(np.abs(codes[off]).tolist()))}')
    assert ulps[~off].max() <= Q8_ULPS
    return ulps[off]


def test_decoders_match_jax():
    rows = _rows()
    batch = {'ECG': rows, 'THX': rows[:, :1000].copy()}
    batch['THX'][2] = -np.inf
    for encode, exact in ((jq8.encode_batch, False), (jq8.encode_batch_q16, True)):
        enc = encode(batch)
        want = jq8.dequant_batch({k: tuple(jnp.asarray(a) for a in v) for k, v in enc.items()})
        tenc = {k: tuple(_t(a) for a in v) for k, v in enc.items()}
        assert q8.is_encoded_batch(tenc) and not q8.is_encoded_batch({k: _t(v) for k, v in batch.items()})
        got = q8.dequant_batch(tenc)
        for k in batch:
            w, g = np.asarray(want[k]), got[k].numpy()
            assert g.dtype == np.float32 and np.array_equal(np.isinf(w), np.isinf(g))
            if exact:
                np.testing.assert_array_equal(g, w)  # q16 bit for bit
            else:
                codes, peaks, present = enc[k]
                _check_q8(codes[present], peaks[present], g[present], w[present], k)
        assert bool(torch.isinf(got['THX'][2]).all()) and float(got['THX'][2, 0]) < 0
    # Every q8 code at 64 peaks.
    codes = np.tile(np.arange(-127, 128, dtype=np.int8), (64, 1))
    peaks = np.random.default_rng(6).uniform(1e-3, 1e3, 64).astype(np.float32)
    present = np.ones(64, bool)
    want = np.asarray(jq8.dequant_q8(jnp.asarray(codes), jnp.asarray(peaks), jnp.asarray(present)))
    got = q8.dequant_q8(_t(codes), _t(peaks), _t(present)).numpy()
    off = _check_q8(codes, peaks, got, want, 'of every code at 64 peaks')
    assert int(_xla_expm1_off_codes().sum()) <= 8  # the exception is a few codes
    print(f'  {(off > Q8_ULPS).sum()} of {codes.size} values over {Q8_ULPS} ulps from JAX\'s')


# ---------------------------------------------------------------- optimizer


def _jax_lr_scale(opt_state, value):
    """Set ``inject_hyperparams``' lr_scale in a (MultiSteps-wrapped) chain state."""
    inner = opt_state.inner_opt_state if hasattr(opt_state, 'inner_opt_state') else opt_state
    inner[-1].hyperparams['lr_scale'] = jnp.asarray(value)
    return opt_state


@pytest.mark.parametrize('case', ['clip_active', 'clip_inactive', 'accumulate_2', 'lr_scale_0.1'])
def test_optimizer_matches_optax(case):
    rng = np.random.default_rng(0)
    shapes = {'w': (4, 3), 'b': (3,), 's': (5,)}
    p0 = {k: (rng.normal(size=s) * 0.5).astype(np.float32) for k, s in shapes.items()}
    grad_scale = {'clip_active': 5.0, 'clip_inactive': 0.05}.get(case, 1.0)
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]
    accumulate = 2 if case == 'accumulate_2' else 1
    kw = dict(weight_decay=1e-2, grad_clip=1.0, accumulate_steps=accumulate)
    tx = jstep.make_optimizer(jscheduler.exp_warmup_schedule(1e-2, 3, 10.0), inject_lr_scale=True, **kw)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = tx.init(jparams)
    opt = tstep.make_optimizer(scheduler.exp_warmup_schedule(1e-2, 3, 10.0), **kw)
    tparams = [_t(p0[k]).clone() for k in shapes]
    state = opt.init(tparams)
    if case == 'lr_scale_0.1':
        jopt = _jax_lr_scale(jopt, 0.1)
        state.lr_scale = 0.1
    applied = []
    for g in grads:  # six updates (three under accumulation), across the warm-up edge
        upd, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        applied.append(opt.update([_t(g[k]) for k in shapes], state, tparams))
        for name, t in zip(shapes, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[name]), rtol=0, atol=1e-7)
    assert applied == [True] * 6 if accumulate == 1 else applied == [False, True] * 3
    assert state.count == 6 // accumulate
    norms = [float(tstep.global_norm([_t(g[k]) for k in shapes])) for g in grads]
    if case == 'clip_active':
        assert min(norms) > kw['grad_clip']
    if case == 'clip_inactive':
        assert max(norms) < kw['grad_clip']


def _tiny_model():
    return build_wav2sleep(
        4, {'ECG': 'ECG'},
        encoders=dict(feature_dim=8, activation='gelu', norm='instance', chunk_causal=False, initial_channels=2,
                      max_channels=4),
        epoch_mixer=dict(feature_dim=8, layers=1, dim_ff=16, nhead=2, dropout=0.0),
        sequence_mixer=dict(feature_dim=8, num_layers=1, kernel_size=3, num_dilations=1, norm='layer', dropout=0.0),
    )


def _leaf(tree):
    return next(iter(tree.values())).detach().clone()


@pytest.mark.parametrize('accumulate', [1, 2])
def test_weight_ema_folds_once_per_optimizer_step(accumulate):
    """As tests/train/test_train.py's two EMA tests: frozen before
    ema_start_step (counted in optimizer steps), then ema = d ema + (1 - d)
    params after each applied update, and never on a micro-step that did
    not apply."""
    rng = np.random.default_rng(1)
    x = {'ECG': _t(rng.normal(size=(2, 1024 * 2)).astype(np.float32))}
    y = _t(rng.integers(0, 4, size=(2, 2)).astype(np.float32))
    model = _tiny_model()
    opt = tstep.make_optimizer(1e-2, weight_decay=0.0, grad_clip=1.0, accumulate_steps=accumulate)
    state = tstep.init_train_state(model, opt, ema=True)
    start = 1 if accumulate == 1 else 0
    step = tstep.make_train_step(model, opt, 4, flip_polarity=False, ema_decay=0.5, ema_start_step=start)
    ema0 = _leaf(state.ema_params)
    state, _ = step(state, (x, y), 1)
    # Step 0: before ema_start_step, or a micro-step that did not apply.
    torch.testing.assert_close(_leaf(state.ema_params), ema0, rtol=0, atol=0)
    if accumulate > 1:
        torch.testing.assert_close(_leaf(state.params), ema0, rtol=0, atol=0)  # params unchanged too
    prev = _leaf(state.ema_params)
    state, _ = step(state, (x, y), 2)
    torch.testing.assert_close(_leaf(state.ema_params), 0.5 * prev + 0.5 * _leaf(state.params), rtol=1e-5, atol=1e-7)
    assert not torch.allclose(_leaf(state.ema_params), _leaf(state.params))
    assert state.step == 2 and state.opt_state.count == 2 // accumulate


# ---------------------------------------------------------------- the step


def _narrow_pair(signals=SIGNALS):
    """The JAX and port flagships at feature_dim 32, channels 16-32
    (``test_torch_model.narrow_flagship``'s weights), mixer dropout 0 in
    both, with the encoders of ``signals``."""
    _, cfg = _flagship_model(feature_dim=32)
    cfg['signal_encoders']['max_channels'] = 32
    cfg['signal_encoders']['signal_map'] = {k: k for k in signals}
    cfg['epoch_mixer']['dropout'] = cfg['sequence_mixer']['dropout'] = 0.0
    jmodel = instantiate(cfg)
    x0 = {k: np.zeros((1, 2 * SPE[k]), np.float32) for k in signals}
    variables = jax_random_variables(jmodel, x0, seed=0)
    tcfg = flagship_config(32, 32)
    tcfg['signal_map'] = {k: k for k in signals}
    tcfg['epoch_mixer']['dropout'] = tcfg['sequence_mixer']['dropout'] = 0.0
    tmodel = build_wav2sleep(**tcfg)
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, tmodel


def _batch(B=2, S=2, seed=1, signals=SIGNALS):
    rng = np.random.default_rng(seed)
    x = {k: (rng.normal(size=(B, S * SPE[k])) * 2.0 + 0.5).astype(np.float32) for k in signals}
    x[signals[-1]][1] = -np.inf  # a night without the last signal (PPG)
    y = rng.integers(-1, 4, size=(B, S)).astype(np.float32)
    return x, y


def _as_torch_params(jax_params):
    return from_jax_variables({'params': jax.tree_util.tree_map(np.asarray, jax_params)})


def _adam_mu(opt_state):
    """Adam's first moment in an optax chain state."""
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, 'nu'))
                if hasattr(s, 'nu')).mu


def _noisy(moments):
    """Per parameter, the elements whose first moment the two stacks put
    more than NOISY_MOMENT apart after some step (``moments``: per step,
    the port's and JAX's, by name)."""
    out = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in moments[0][0].items()}
    for ours, theirs in moments:
        for k in out:
            out[k] |= (ours[k] - theirs[k]).abs() > NOISY_MOMENT * theirs[k].abs()
    return out


def _param_diffs(tparams, jax_params, noisy):
    """max |d| over the elements outside ``noisy``, over those in it, and
    the parameters whose elements in it go past PARAM_ATOL."""
    want = _as_torch_params(jax_params)
    assert set(want) == set(tparams)
    d = {k: (tparams[k].detach() - want[k]).abs() for k in want}
    rest = max(float(torch.where(noisy[k], 0.0, v).max()) for k, v in d.items())
    inside = {k: float(torch.where(noisy[k], v, 0.0).max()) for k, v in d.items()}
    return rest, max(inside.values()), sorted(k for k, v in inside.items() if v > PARAM_ATOL)


@pytest.fixture(scope='module')
def trajectory():
    """Three f32 steps of both stacks from one init on one batch (masker
    off, flip off, EMA 0.9 from optimizer step 1), then one step on the q8
    encoding of the batch: each step's loss, gradient norm and confusion
    matrix, the noisy elements after steps 3 and 4, and the parameters and
    EMA against JAX's after them."""
    jmodel, variables, tmodel = _narrow_pair()
    x, y = _batch()
    tx = jstep.make_optimizer(jscheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    params = variables['params']
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                              ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jfn = jax.jit(jstep.make_train_step(jmodel, tx, 4, masker=None, flip_polarity=False, ema_decay=0.9,
                                        ema_start_step=1))
    opt = tstep.make_optimizer(scheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    tstate = tstep.init_train_state(tmodel, opt, ema=True)
    tfn = tstep.make_train_step(tmodel, opt, 4, masker=None, flip_polarity=False, ema_decay=0.9, ema_start_step=1)
    steps, moments = [], []

    def both(jx, tx_):
        nonlocal jstate, tstate
        jstate, jm = jfn(jstate, (jx, y), jax.random.PRNGKey(0))
        tstate, tm = tfn(tstate, (tx_, _t(y)), 0)
        steps.append({k: (np.asarray(jm[k]), tm[k].numpy()) for k in ('loss', 'grad_norm', 'cmat')})
        moments.append((dict(zip(tstate.params, (m.clone() for m in tstate.opt_state.mu))),
                        _as_torch_params(_adam_mu(jstate.opt_state))))

    def diffs():
        noisy = _noisy(moments)
        return (noisy, _param_diffs(tstate.params, jstate.params, noisy),
                _param_diffs(tstate.ema_params, jstate.ema_params, noisy))

    for _ in range(3):
        both(x, {k: _t(v) for k, v in x.items()})
    moved = float(max((tstate.params[k].detach() - v).abs().max() for k, v in from_jax_variables(variables).items()))
    after3 = diffs()
    # The q8 step: the port's step decodes the codes itself; the JAX step
    # decodes first (as its step does for an encoded batch) and runs the
    # same compiled program.
    enc = jq8.encode_batch(x)
    decoded = {k: np.asarray(v) for k, v in jq8.dequant_batch({k: tuple(jnp.asarray(a) for a in v)
                                                               for k, v in enc.items()}).items()}
    both(decoded, {k: tuple(_t(a) for a in v) for k, v in enc.items()})
    return steps, moved, after3, diffs()


def _check_params(what, n_steps, after):
    """The parameters and EMA after ``n_steps``: within PARAM_ATOL outside
    the noisy elements, within Adam's reach inside them, which are few."""
    noisy, (d_params, d_noisy, past), (d_ema, d_ema_noisy, ema_past) = after
    n, total = sum(int(v.sum()) for v in noisy.values()), sum(v.numel() for v in noisy.values())
    reach = 2 * ADAM_RATIO * sum(scheduler.exp_warmup_schedule(*SCHEDULE)(c) for c in range(n_steps))
    print(f'{what}: max |d params| {d_params:.3e}, |d EMA| {d_ema:.3e} (atol {PARAM_ATOL:g}) outside the {n} of '
          f'{total} elements whose Adam moment the stacks put over {NOISY_MOMENT:g} apart; inside them '
          f'{d_noisy:.3e} and {d_ema_noisy:.3e} (Adam\'s reach {reach:.3e}); past {PARAM_ATOL:g} there: '
          f'{past}, EMA {ema_past}')
    assert d_params <= PARAM_ATOL and d_ema <= PARAM_ATOL
    assert d_noisy <= reach and d_ema_noisy <= reach
    assert n <= NOISY_SHARE * total


def test_train_step_tracks_jax_over_three_steps(trajectory):
    steps, moved, after3, _ = trajectory
    rel = {key: [abs(float(s[key][1]) - float(s[key][0])) / abs(float(s[key][0])) for s in steps[:3]]
           for key in ('loss', 'grad_norm')}
    print(f'3 steps: relative |d loss| {max(rel["loss"]):.3e}, |d grad norm| {max(rel["grad_norm"]):.3e} '
          f'(bound {STEP_TOL:g}); the parameters moved up to {moved:.3e}')
    assert max(rel['loss'] + rel['grad_norm']) <= STEP_TOL, rel
    for s in steps[:3]:
        np.testing.assert_array_equal(s['cmat'][1], s['cmat'][0])
    assert steps[0]['grad_norm'][0] > STEP_OPT['grad_clip']  # the clip is active
    _check_params('after 3 steps', 3, after3)
    assert moved > 10 * PARAM_ATOL  # the gate is not vacuous


def test_q8_step_tracks_jax(trajectory):
    steps, _, _, after4 = trajectory
    s = steps[3]
    rel = {key: abs(s[key][1] - s[key][0]) / abs(s[key][0]) for key in ('loss', 'grad_norm')}
    print(f'q8 step: relative |d loss| {rel["loss"]:.3e}, |d grad norm| {rel["grad_norm"]:.3e}')
    assert max(rel.values()) <= STEP_TOL
    np.testing.assert_array_equal(s['cmat'][1], s['cmat'][0])
    _check_params('after the q8 step', 4, after4)


class _Capture:
    """An optimizer that keeps the step's gradients and applies nothing."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in grads]
        return False


def _port_loss_and_grads(tmodel, x, y, compute_dtype):
    cap = _Capture()
    state = tstep.init_train_state(tmodel, cap)
    step = tstep.make_train_step(tmodel, cap, 4, flip_polarity=False, compute_dtype=compute_dtype)
    _, m = step(state, ({k: _t(v) for k, v in x.items()}, _t(y)), 0)
    return float(m['loss']), dict(zip(state.params, cap.grads))


def test_bf16_step_is_within_twice_jaxs_bf16_error():
    """The port's bf16 loss and gradients against its f32 ones (which equal
    JAX's f32 ones, above), within twice the distance of JAX's bf16 step
    from the same f32 values (the method of ROADMAP fault C.2). The model
    has the respiratory encoders only, which keeps XLA's bf16 compile
    short."""
    signals = ('ABD', 'THX')
    jmodel, variables, tmodel = _narrow_pair(signals)
    x, y = _batch(signals=signals)

    def jloss(params):
        p16 = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
        xin = {k: jnp.asarray(v, jnp.bfloat16) for k, v in x.items()}
        logits = jmodel.apply({'params': p16}, xin, train=True, rngs={'dropout': jax.random.PRNGKey(0)})
        return jmetrics.cross_entropy_ignore_index(logits.reshape(-1, 4), jnp.asarray(y).reshape(-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables['params'])
    jg = _as_torch_params(jg)
    l32, g32 = _port_loss_and_grads(tmodel, x, y, None)
    l16, g16 = _port_loss_and_grads(tmodel, x, y, torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in g16.values())  # f32 gradients of the f32 masters

    def dist(g):
        return float(torch.sqrt(sum(((g[k] - g32[k]) ** 2).sum() for k in g32)))

    jax_err = (abs(float(jl) - l32), dist(jg))
    port_err = (abs(l16 - l32), dist(g16))
    print(f'bf16 vs f32: loss {port_err[0]:.3e} (JAX {jax_err[0]:.3e}), gradients {port_err[1]:.3e} '
          f'(JAX {jax_err[1]:.3e}), |g| {dist({k: 0 * v for k, v in g32.items()}):.3e}')
    assert 0 < jax_err[1] and port_err[1] <= 2 * jax_err[1]
    assert port_err[0] <= 2 * max(jax_err[0], 2.0**-8 * abs(l32))


@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16])
def test_remat_gives_the_same_gradients(compute_dtype):
    x, y = _batch(seed=3)
    out = []
    for remat in (False, True):
        cfg = flagship_config(32, 32)
        cfg['encoders']['remat'] = remat
        model = build_wav2sleep(**cfg)
        out.append(_port_loss_and_grads(model, x, y, compute_dtype))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6 if compute_dtype is None else 0)


def test_step_randomness_is_seeded_and_leaves_the_global_stream():
    """Dropout, flip and masker draw from (seed, step): one seed gives one
    step twice, another seed another step; the global RNG is untouched."""
    x, y = _batch(B=3, seed=4)
    losses = {}
    for seed in (0, 0, 1):
        model = build_wav2sleep(**flagship_config(32, 32))  # dropout 0.1 in the mixers
        opt = tstep.make_optimizer(1e-3)
        state = tstep.init_train_state(model, opt)
        masker = SignalMasker(train_bench.DROPOUTS, train_bench.BACKUPS)
        step = tstep.make_train_step(model, opt, 4, masker=masker, flip_polarity=True)
        before = torch.random.get_rng_state()
        _, m = step(state, ({k: _t(v) for k, v in x.items()}, _t(y)), seed)
        assert torch.equal(torch.random.get_rng_state(), before)
        losses.setdefault(seed, []).append(float(m['loss']))
    assert losses[0][0] == losses[0][1] and losses[1][0] != losses[0][0]


def test_eval_step_decodes_and_masks():
    tmodel = build_wav2sleep(**flagship_config(32, 32))
    x, y = _batch(seed=5)
    enc = {k: tuple(_t(a) for a in v) for k, v in q8.encode_batch_q16(x).items()}
    present = {'ECG': torch.tensor([False, True])}
    ev = tstep.make_eval_step(tmodel, 4)
    params = dict(tmodel.named_parameters())
    got = ev(params, (enc, _t(y)), present)
    with torch.no_grad():
        logits = tmodel.eval()(q8.dequant_batch(enc), present=present)
    torch.testing.assert_close(got['preds'], logits.argmax(-1))
    torch.testing.assert_close(got['loss'], metrics.cross_entropy_ignore_index(logits.reshape(-1, 4), _t(y).reshape(-1)))
    assert int(got['cmat'].sum()) == int((y >= 0).sum())
    # Other parameters (an EMA) go in by name; the model's own are kept.
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    assert float(ev(zeros, (enc, _t(y)))['preds'].abs().sum()) == 0
    assert torch.equal(ev(params, (enc, _t(y)), present)['preds'], got['preds'])


def test_train_bench_needs_a_card_unless_told_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            train_bench.run(batch=1, epochs_per_night=1, k=2, reps=1)
    train_bench.main(['--device', 'cpu', '--batch', '1', '--epochs-per-night', '1', '--feature-dim', '16',
                      '--precision', 'float32', '--k', '2', '--reps', '1', '--transport', 'q8'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['device'] == 'cpu' and line['card'] is None and line['peak_gib'] is None
    assert np.isfinite(line['loss']) and line['compute_ms_per_step'] > 0 and line['nights_per_hour_e2e'] > 0
    assert line['k1_launches_per_step'] == 0  # the plain versions run on the CPU


# ---------------------------------------------------------------- K1/K2 grads


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('phi', ['identity', 'norm+gelu'])
@pytest.mark.parametrize('stats', [False, True], ids=['K1', 'K2'])
def test_kernel_gradients_match_the_pallas_custom_vjp(monkeypatch, stats, phi, stride):
    """Gradients through the JAX package's Pallas convs (interpreted; their
    ``custom_vjp`` backward is the plain reference's) against ``conv_k3`` /
    ``conv_k3_stats`` (whose backward is autograd of their plain versions),
    for random cotangents of every output."""
    monkeypatch.setattr(pallas_conv, '_INTERPRET', True)
    ci, co, eps = 16, 32, 1e-2
    rng = np.random.default_rng(10 * stride + 2 * stats + (phi != 'identity'))
    B, T = 2, 256 * stride
    x = (rng.normal(size=(B, T, ci)) * 1.5 + 0.3).astype(np.float32)
    w = (rng.normal(size=(3, ci, co)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.5).astype(np.float32)
    mu = (rng.normal(size=(B, ci)) * 0.3).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=(B, ci)).astype(np.float32)
    gy = rng.normal(size=(B, T // stride, co)).astype(np.float32)
    gmu, ginv = (rng.normal(size=(B, co)).astype(np.float32) for _ in range(2))
    fused = phi != 'identity'
    args = (x, w, b, mu, inv) if fused else (x, w, b)

    def jax_loss(*a):
        data = a[0].reshape(B, T * ci // 128, 128)
        if stats:
            fn = pallas_conv.sd_conv_blocks_fused_stats if fused else pallas_conv.sd_conv_blocks_stats
            y, m, i = fn(data, *a[1:], ci, co, stride, *(('gelu',) if fused else ()), eps)
            extra = jnp.sum(m * gmu) + jnp.sum(i * ginv)
        else:
            fn = pallas_conv.sd_conv_blocks_fused if fused else pallas_conv.sd_conv_blocks
            y, extra = fn(data, *a[1:], ci, co, stride, *(('gelu',) if fused else ())), 0.0
        y = jbd.from_blocks(jbd.BlockedArray(data=y, channels=co))
        return jnp.sum(y * gy) + extra

    want = jax.grad(jax_loss, argnums=tuple(range(len(args))))(*(jnp.asarray(a) for a in args))
    targs = [_t(a).requires_grad_() for a in args]
    conv_args = (*targs, *((None, None) if not fused else ()), stride, 'gelu' if fused else None)
    if stats:
        y, m, i = k1.conv_k3_stats(*conv_args, eps)
        loss = (y * _t(gy)).sum() + (m * _t(gmu)).sum() + (i * _t(ginv)).sum()
    else:
        loss = (k1.conv_k3(*conv_args) * _t(gy)).sum()
    got = torch.autograd.grad(loss, targs)
    for name, g, e in zip(('x', 'w', 'bias', 'mu', 'inv'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e).reshape(g.shape), atol=1e-4, rtol=1e-4, err_msg=name)
