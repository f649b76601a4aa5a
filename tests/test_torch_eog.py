"""wav2sleep-eog, the second released variant, in the port against the JAX
package on the CPU: the architecture of ``flagship_config(variant='eog')``,
the q8 and f32 serving paths of a narrow EOG model on the same EOG EDFs
(the extractors' codes bit for bit, the logits at 5e-4), one EOG training
step with the masker, the flip and 5 classes, ``train_bench``'s EOG batch,
and the EOG training config (``inputs=neural/eog``) and its masker."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_batch, _flagship_model
from wav2sleep_tpu import pipeline as jpipe
from wav2sleep_tpu.instantiate import instantiate
from wav2sleep_tpu.settings import COLS_TO_SAMPLES_PER_EPOCH as SPE
from wav2sleep_tpu.train import scheduler as jscheduler
from wav2sleep_tpu.train import step as jstep
from wav2sleep_tpu_torch import pipeline as tpipe
from wav2sleep_tpu_torch import train_bench
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.data.synth import write_nights
from wav2sleep_tpu_torch.instantiate import target_config
from wav2sleep_tpu_torch.models import layers
from wav2sleep_tpu_torch.models.wav2sleep import VARIANTS, build_wav2sleep, flagship_config, flagship_model
from wav2sleep_tpu_torch.train import scheduler
from wav2sleep_tpu_torch.train import step as tstep
from wav2sleep_tpu_torch.train.masker import SignalMasker, invert_signals

from .test_torch_model import jax_random_variables
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_train import SCHEDULE, STEP_OPT, STEP_TOL, _adam_mu, _as_torch_params, _check_params, _noisy, \
    _param_diffs

SIGNALS = ['EOG-L', 'EOG-R']
S = 6  # epochs a night
HOURS = S / 120
TOL = dict(atol=5e-4, rtol=5e-4)


def _strip(cfg):
    """A config without its ``_target_`` class names, which name different
    packages in the two."""
    if isinstance(cfg, dict):
        return {k: _strip(v) for k, v in cfg.items() if k != '_target_'}
    return cfg


def test_flagship_config_is_the_released_eog_architecture():
    _, want = _flagship_model(variant='eog')
    got = target_config(**flagship_config(variant='eog'))
    assert _strip(got) == _strip(want)
    assert VARIANTS['eog'] == (5, ('EOG-L', 'EOG-R'))
    # The default stays the cardio model.
    assert _strip(target_config(**flagship_config())) == _strip(_flagship_model()[1])
    with pytest.raises(ValueError, match='variant'):
        flagship_config(variant='ppg')
    model = flagship_model(16, max_channels=16, variant='eog', device='cpu')
    assert model.num_classes == 5 and sorted(model.valid_signals) == SIGNALS
    # Ten blocks an encoder (4,096 samples an epoch), three k3 convs each;
    # the C_in = 1 entry conv of each encoder is not K1's.
    blocks = [m for m in model.modules() if isinstance(m, layers.ConvBlock1D)]
    convs = [c.conv for b in blocks for c in (b.conv1, b.conv2, b.conv3)]
    assert len(blocks) == 20 and len(convs) == 60 and sum(m.kernel_eligible for m in convs) == 58
    assert sum(m.kernel_eligible for m in model.modules() if isinstance(m, layers.Conv1D)) == 58


@pytest.fixture(scope='module')
def eog_pair():
    """The narrow EOG model (feature_dim 16, channels 16) in both stacks on
    the same weights, with mixer dropout 0."""
    _, cfg = _flagship_model(feature_dim=16, variant='eog')
    cfg['signal_encoders']['max_channels'] = 16
    cfg['epoch_mixer']['dropout'] = cfg['sequence_mixer']['dropout'] = 0.0
    jmodel = instantiate(cfg)
    x0 = {k: np.zeros((1, 2 * SPE[k]), np.float32) for k in SIGNALS}
    variables = jax_random_variables(jmodel, x0, seed=4)
    tcfg = flagship_config(16, 16, variant='eog')
    tcfg['epoch_mixer']['dropout'] = tcfg['sequence_mixer']['dropout'] = 0.0
    tmodel = build_wav2sleep(**tcfg).eval()
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope='module')
def eog_nights(tmp_path_factory):
    """Three EOG EDF nights at MESA's EOG rate (256 Hz, off the 136.53 Hz
    model grid) with 5-class stages."""
    folder = tmp_path_factory.mktemp('eog')
    fps, _ = write_nights(str(folder), 3, HOURS, seed=2, kind='eog')
    return fps


def test_eog_extractors_are_the_jax_packages(eog_nights):
    """q8 codes and metadata, and the f32 decode, bit for bit."""
    for fp in eog_nights:
        outs = []
        for mod in (jpipe, tpipe):
            q = {c: np.full((1, tpipe.grid_length(c, HOURS)), 99, np.int8) for c in SIGNALS}
            meta = {c: np.zeros(1, dtype=tpipe.Q8_META_DTYPE) for c in SIGNALS}
            n = mod.Q8NightExtractor(SIGNALS, HOURS).extract_into(fp, q, meta, 0)
            rows = {c: np.zeros(tpipe.grid_length(c, HOURS), np.float32) for c in SIGNALS}
            mod.NightDecoder(SIGNALS, HOURS).decode_into(fp, rows)
            outs.append((n, q, meta, rows))
        (jn, jq, jmeta, jrows), (tn, tq, tmeta, trows) = outs
        assert tn == jn == S
        for c in SIGNALS:
            assert tq[c].shape == (1, S * 4096) and np.abs(tq[c]).max() > 0
            np.testing.assert_array_equal(tq[c], jq[c])
            assert tmeta[c].tobytes() == jmeta[c].tobytes()
            np.testing.assert_array_equal(trows[c], jrows[c])


def _logits_per_night(pipe, forward, fps):
    pipe.forward = forward
    return dict(pipe.run(fps))


@pytest.mark.parametrize('transport', ['q8', 'f32'])
def test_eog_serving_logits_match_jax(eog_pair, eog_nights, transport):
    """The q8 and f32 pipelines of the narrow EOG model serve the JAX
    package's f32 logits (atol/rtol 5e-4), and hypnograms in 0..4 that are
    their argmax off near-ties."""
    jmodel, variables, tmodel = eog_pair
    kw = dict(batch_size=2, max_length_hours=HOURS, precision='float32')
    if transport == 'q8':
        jp = jpipe.StreamingPipelineQ8(jmodel, variables, SIGNALS, **kw)
        want = _logits_per_night(jp, jpipe.make_streaming_forward_q8(jmodel, 'float32', output='logits'), eog_nights)
        tp = tpipe.StreamingPipelineQ8(tmodel, SIGNALS, device='cpu', **kw)
        forward = tpipe.make_streaming_forward_q8(tp.model, 'float32', output='logits')
    else:
        jp = jpipe.StreamingPipeline(jmodel, variables, SIGNALS, **kw)
        want = _logits_per_night(jp, jpipe.make_streaming_forward(jmodel, 'float32', output='logits'), eog_nights)
        tp = tpipe.StreamingPipeline(tmodel, SIGNALS, device='cpu', **kw)
        forward = tpipe.make_streaming_forward(tp.model, 'float32', output='logits')
    hyps = dict(tp.run(eog_nights))
    got = _logits_per_night(tp, forward, eog_nights)
    assert list(got) == list(want) == list(hyps) == eog_nights
    for fp in eog_nights:
        logits = np.asarray(want[fp])
        assert got[fp].shape == logits.shape == (S, 5) and np.isfinite(got[fp]).all()
        print(f'{transport} {fp[-12:]}: max |d logits| {np.abs(got[fp] - logits).max():.3e}')
        np.testing.assert_allclose(got[fp], logits, **TOL)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3
        assert clear.any()
        np.testing.assert_array_equal(hyps[fp][clear], logits.argmax(-1)[clear])
        assert hyps[fp].min() >= 0 and hyps[fp].max() <= 4


def test_eog_train_step_matches_jax(eog_pair):
    """One EOG step (masker and flip on, 5 classes, EMA): the port's step
    against JAX's on the batch the port's augmentations make (the two
    stacks draw from different RNG streams, so JAX's step takes the port's
    flipped and masked batch with its own augmentations off): loss and
    gradient norm within 5e-4 relative, the parameters and EMA as the
    step test holds them (ROADMAP §C.7)."""
    jmodel, variables, _ = eog_pair
    tcfg = flagship_config(16, 16, variant='eog')
    tcfg['epoch_mixer']['dropout'] = tcfg['sequence_mixer']['dropout'] = 0.0
    tmodel = build_wav2sleep(**tcfg)
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    rng = np.random.default_rng(3)
    x = {k: (rng.normal(size=(4, 2 * SPE[k])) * 2.0 + 0.5).astype(np.float32) for k in SIGNALS}
    x['EOG-R'][3] = -np.inf  # a night without EOG-R
    y = rng.integers(-1, 5, size=(4, 2)).astype(np.float32)
    masker = SignalMasker(*train_bench.MASKERS['eog'])
    seed = 5

    opt = tstep.make_optimizer(scheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    tstate = tstep.init_train_state(tmodel, opt, ema=True)
    tfn = tstep.make_train_step(tmodel, opt, 5, masker=masker, flip_polarity=True, ema_decay=0.9, ema_start_step=0)
    tx_ = {k: torch.from_numpy(v) for k, v in x.items()}
    # The port's augmentations at step 0, as its step draws them.
    seed_flip, seed_mask, _ = tstep.step_seeds(seed, 0)
    aug = masker(torch.Generator().manual_seed(seed_mask),
                 invert_signals(torch.Generator().manual_seed(seed_flip), tx_))
    assert any(bool(torch.isinf(aug[k][i, 0])) != bool(np.isinf(x[k][i, 0])) for k in SIGNALS for i in range(4))
    tstate, tm = tfn(tstate, (tx_, torch.from_numpy(y)), seed)

    tx = jstep.make_optimizer(jscheduler.exp_warmup_schedule(*SCHEDULE), **STEP_OPT)
    params = variables['params']
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                              ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jfn = jax.jit(jstep.make_train_step(jmodel, tx, 5, masker=None, flip_polarity=False, ema_decay=0.9,
                                        ema_start_step=0))
    jstate, jm = jfn(jstate, ({k: v.numpy() for k, v in aug.items()}, y), jax.random.PRNGKey(0))

    rel = {k: abs(float(tm[k]) - float(jm[k])) / abs(float(jm[k])) for k in ('loss', 'grad_norm')}
    print(f'EOG step: relative |d loss| {rel["loss"]:.3e}, |d grad norm| {rel["grad_norm"]:.3e} (bound {STEP_TOL:g})')
    assert max(rel.values()) <= STEP_TOL
    np.testing.assert_array_equal(tm['cmat'].numpy(), np.asarray(jm['cmat']))
    assert tm['cmat'].shape == (5, 5)
    moments = [(dict(zip(tstate.params, tstate.opt_state.mu)), _as_torch_params(_adam_mu(jstate.opt_state)))]
    noisy = _noisy(moments)
    _check_params('after the EOG step', 1, (noisy, _param_diffs(tstate.params, jstate.params, noisy),
                                            _param_diffs(tstate.ema_params, jstate.ema_params, noisy)))


def test_train_bench_eog_batch_is_the_graft_entrys():
    for B, S_ in ((2, 3), (4, 1)):
        got, got_y = train_bench.example_batch(B, S_, signals='eog')
        want, want_y = _example_batch(B, S_, variant='eog')
        assert list(got) == list(want) == SIGNALS
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == (B, 4096 * S_)
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got_y, want_y)
        assert got_y.max() <= 4
    # The cardio batch is unchanged by the variant argument's default.
    np.testing.assert_array_equal(train_bench.example_batch(2, 2)[0]['ECG'], _example_batch(2, 2)[0]['ECG'])


def test_eog_training_config_builds_the_jax_packages_masker():
    """``inputs=neural/eog num_classes=5`` composed by each package's config
    reader: the same signals, classes and model, and the port's masker has
    the JAX package's dropouts and backups."""
    from wav2sleep_tpu import config as jconfig
    from wav2sleep_tpu import instantiate as jinst
    from wav2sleep_tpu_torch import config as tconfig
    from wav2sleep_tpu_torch import instantiate as tinst

    config_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'scripts', 'config')
    overrides = ['inputs=neural/eog', 'num_classes=5', 'datasets=mesa']
    jcfg = jconfig.resolve(jconfig.compose(config_dir, 'main', overrides))
    tcfg = tconfig.compose(config_dir, 'main', overrides)
    assert tcfg['inputs'] == jcfg['inputs'] and tcfg['num_classes'] == jcfg['num_classes'] == 5
    assert _strip(tcfg['model']) == _strip(jcfg['model'])
    ours, theirs = tinst.instantiate(tcfg['inputs']['masker']), jinst.instantiate(jcfg['inputs']['masker'])
    assert isinstance(ours, SignalMasker)
    assert ours.channel_dropouts == theirs.channel_dropouts == {'EOG-L': 0.7, 'EOG-R': 0.7}
    assert ours.backup_channels == theirs.backup_channels
    model = tinst.build_model(tcfg['model'])
    assert model.num_classes == 5 and sorted(model.valid_signals) == SIGNALS
