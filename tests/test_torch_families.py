"""The port's other model kinds against the JAX package's on the CPU: every
norm kind through ``ConvLayer1D`` and ``ConvBlock1D`` (batch norm in train
mode with its running statistics, and in eval mode), causal and not; the
post-norm mixer; causal, chunk-causal, batch-norm and the other narrow
wav2sleep kinds; the full-length SleepPPG-Net; prefix invariance of the
causal kinds; weight conversion and checkpoint folders both ways for both
families. Inputs and weights come from a numpy seed; weights cross with
``convert.from_jax_variables``. Logits within atol/rtol 5e-4, running
statistics within rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu import api as japi
from wav2sleep_tpu.checkpoint import _flatten, export_torch_state_dict
from wav2sleep_tpu.checkpoint import save_checkpoint_folder as jax_save_folder
from wav2sleep_tpu.convert import convert_state_dict
from wav2sleep_tpu.instantiate import instantiate
from wav2sleep_tpu.models import layers as jlayers
from wav2sleep_tpu_torch import api, checkpoint, instantiate as tinstantiate
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.models import layers
from wav2sleep_tpu_torch.models.ppgnet import SleepPPGNet

TOL = 5e-4  # f32 logits, atol and rtol (PERF.md §2)
STATS_RTOL = 1e-4  # running statistics
PPG_LEN = SleepPPGNet.INPUT_LENGTH
_W2S = 'wav2sleep_tpu.models.wav2sleep.'


def jax_variables(jmodel, x0, seed: int, **init_kw) -> dict:
    """Seeded numpy values on the variable tree of ``jmodel.init``: fan-in
    scaled kernels and weight-norm directions, scales and weight-norm
    magnitudes near 1, biases near 0, N(0, 1) tokens, and running means near
    0 with variances in 0.5..1.5, so that eval mode reads every statistic."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x0, **init_kw))
    rng = np.random.default_rng(seed)

    def draw(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ('scale', 'kernel_g'):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ('bias', 'register_tokens', 'embedding', 'mean'):
            v = rng.normal(size=shape) * (1.0 if name in ('register_tokens', 'embedding') else 0.1)
        elif name == 'var':
            v = rng.uniform(0.5, 1.5, size=shape)
        else:  # conv / dense kernels: fan-in scaled
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(draw, dict(shapes)))


def wav2sleep_config(enc_norm='instance', causal=False, chunk_causal=False, seq_norm='layer', norm_first=True,
                     feature_dim=16, signals=('ECG', 'THX')) -> dict:
    """A narrow wav2sleep ``_target_`` config (JAX spelling); ``seq_norm``
    None leaves the sequence mixer's norm out (the default, batch norm)."""
    seq = {'_target_': _W2S + 'SequenceCNN', 'feature_dim': feature_dim, 'num_layers': 1, 'kernel_size': 3,
           'num_dilations': 2, 'dropout': 0.0, 'causal': causal}
    if seq_norm is not None:
        seq['norm'] = seq_norm
    return {
        '_target_': _W2S + 'Wav2Sleep', 'num_classes': 4,
        'signal_encoders': {'_target_': _W2S + 'SignalEncoders', 'signal_map': {s: s for s in signals},
                            'feature_dim': feature_dim, 'activation': 'gelu', 'norm': enc_norm, 'causal': causal,
                            'chunk_causal': chunk_causal, 'initial_channels': 8, 'max_channels': 16},
        'epoch_mixer': {'_target_': _W2S + 'MultiModalAttentionEmbedder', 'feature_dim': feature_dim, 'layers': 1,
                        'dim_ff': 32, 'nhead': 4, 'dropout': 0.0, 'norm_first': norm_first},
        'sequence_mixer': seq,
    }


def ppgnet_config(feature_dim=32, **kw) -> dict:
    return {'_target_': 'wav2sleep_tpu.models.ppgnet.SleepPPGNet', 'n_classes': 4, 'norm': 'batch',
            'feature_dim': feature_dim, 'activation': 'leaky', 'dropout': 0.0, 'remat': False, **kw}


def wav2sleep_inputs(S=4, B=2, seed=0, signals=('ECG', 'THX')) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    spe = {'ECG': 1024, 'PPG': 1024, 'THX': 256, 'ABD': 256}
    return {s: (rng.normal(size=(B, spe[s] * S)) * 1.5 + 0.2).astype(np.float32) for s in signals}


def model_pair(cfg: dict, x0, seed=0):
    """The JAX model, its seeded variables and the port's model on them."""
    jmodel = instantiate(cfg)
    variables = jax_variables(jmodel, x0, seed)
    tmodel = tinstantiate.build_model(cfg)
    tmodel.load_state_dict(from_jax_variables(variables, tinstantiate.model_family(cfg)), strict=True)
    return jmodel, variables, tmodel


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    print(f'{what}: max|d| {np.abs(got - want).max():.3e} (|want| up to {np.abs(want).max():.3e})')
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def check_stats(tmodel, jax_stats, family='wav2sleep', what='', gate=True):
    """The port's running statistics against JAX's ``batch_stats``: each
    element within STATS_RTOL of its value or, where a mean cancels to near
    zero (both stacks' f32 sums round there), of its buffer's largest
    |value|. Returns the largest |d| / (|value| + max |value|); ``gate``
    False only reports it."""
    want = from_jax_variables({'params': {}, 'batch_stats': jax.tree_util.tree_map(np.asarray, jax_stats)}, family)
    sd = tmodel.state_dict()
    worst = 0.0
    for k, v in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        got = sd[k].float()
        if gate:
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=STATS_RTOL,
                                       atol=STATS_RTOL * float(v.abs().max()), err_msg=k)
        worst = max(worst, float(((got - v).abs() / (v.abs() + v.abs().max())).max()))
    print(f'{what}: running statistics of {len(want) // 3} batch norms, max |d| / (|value| + max |value|) {worst:.3e}')
    return worst


# ---------------------------------------------------------------- layers

NORM_CASES = ['instance', 'layer', 'batch-train', 'batch-eval', 'rms', 'group', 'group-instance', 'weight', 'none']


@pytest.mark.parametrize('causal', [False, True], ids=['acausal', 'causal'])
@pytest.mark.parametrize('module', ['layer', 'block'])
@pytest.mark.parametrize('case', NORM_CASES)
def test_norms_through_layers_match_jax(case, module, causal):
    """One ConvLayer1D (k 5, dilation 2) or one ConvBlock1D (three k-3
    convs, the third at stride 2, and the residual) with each norm kind,
    causal and not, against JAX's; batch norm in train mode also updates
    its running statistics as JAX's ``mutable=['batch_stats']`` does.
    'group-instance' has 4 channels, fewer than the 8 groups: instance
    norm with an affine."""
    norm = {'batch-train': 'batch', 'batch-eval': 'batch', 'group-instance': 'group', 'none': None}.get(case, case)
    train = case == 'batch-train'
    ci, co = 8, 4 if case == 'group-instance' else 16
    if module == 'layer':
        jm = jlayers.ConvLayer1D(features=co, kernel_size=5, dilation=2, padding=4, causal=causal,
                                 activation='gelu', norm=norm)
        tm = layers.ConvLayer1D(ci, co, 5, 1, 4, 2, causal=causal, activation='gelu', norm=norm)
    else:
        jm = jlayers.ConvBlock1D(features=co, activation='leaky', norm=norm, causal=causal)
        tm = layers.ConvBlock1D(ci, co, activation='leaky', norm=norm, causal=causal)
    rng = np.random.default_rng(NORM_CASES.index(case))
    x = (rng.normal(size=(2, 64, ci)) * 1.5 + 0.3).astype(np.float32)
    variables = jax_variables(jm, x, seed=1)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    if train:
        want, mutated = jm.apply(variables, x, train=True, mutable=['batch_stats'])
    else:
        want = jm.apply(variables, x)
    tm.train(train)
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == want.shape
    _close(got.numpy(), want, what=f'{module} {case} causal={causal}')
    if train:
        check_stats(tm, mutated['batch_stats'], what=f'{module} {case}')
        assert {int(v) for k, v in tm.state_dict().items() if k.endswith('num_batches_tracked')} == {1}


# ---------------------------------------------------------------- forwards

FORWARD_CASES = {
    'causal': dict(causal=True),
    'chunk_causal': dict(causal=True, chunk_causal=True),
    'batch_sequence_cnn': dict(seq_norm=None),  # the JAX package's default: batch norm
    'post_norm_mixer': dict(norm_first=False),
    'auto_encoders': dict(enc_norm='auto'),
    'batch_encoders': dict(enc_norm='batch', seq_norm='batch'),
    'rms': dict(enc_norm='rms', seq_norm='rms'),
    'group': dict(enc_norm='group', seq_norm='group'),
    'weight': dict(enc_norm='weight', seq_norm='weight'),
    'layer_causal_batch': dict(enc_norm='layer', causal=True, seq_norm='batch'),
}


@pytest.mark.parametrize('kind', FORWARD_CASES)
def test_wav2sleep_kinds_match_jax(kind):
    """Narrow wav2sleep forwards (ECG + THX, feature_dim 16, channels 8-16,
    4 epochs, one night without THX) in eval mode on the same weights and
    running statistics."""
    cfg = wav2sleep_config(**FORWARD_CASES[kind])
    x = wav2sleep_inputs()
    x['THX'][1] = -np.inf
    jmodel, variables, tmodel = model_pair(cfg, {k: v[:1, : v.shape[1] // 2] for k, v in x.items()})
    want = np.asarray(jmodel.apply(variables, {k: jnp.asarray(v) for k, v in x.items()}))
    with torch.no_grad():
        got = tmodel.eval()({k: _t(v) for k, v in x.items()}).numpy()
    assert got.shape == want.shape == (2, 4, 4)
    _close(got, want, what=kind)
    assert tmodel.causal == FORWARD_CASES[kind].get('causal', False)


@pytest.fixture(scope='module')
def ppgnet_pair():
    cfg = ppgnet_config()
    return (cfg, *model_pair(cfg, np.zeros((1, PPG_LEN), np.float32)))


def test_ppgnet_matches_jax(ppgnet_pair):
    """The full-length SleepPPG-Net (feature_dim 32, B=2): eval mode on the
    running statistics, then train mode (dropout 0) with the batch's
    statistics and the updated running statistics."""
    _, jmodel, variables, tmodel = ppgnet_pair
    x = np.random.default_rng(3).normal(size=(2, PPG_LEN)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.eval()(_t(x)).numpy()
    assert got.shape == (2, 1200, 4)
    _close(got, want, what='SleepPPG-Net eval')
    want, mutated = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=['batch_stats']))(
        variables, jnp.asarray(x))
    model = tinstantiate.build_model(ppgnet_pair[0])
    model.load_state_dict(tmodel.state_dict(), strict=True)
    with torch.no_grad():
        got = model.train()(_t(x)).numpy()
    _close(got, want, what='SleepPPG-Net train')
    check_stats(model, mutated['batch_stats'], 'ppgnet', 'SleepPPG-Net train')
    with pytest.raises(ValueError, match='unexpected shape'):
        tmodel(torch.zeros(1, PPG_LEN // 2))
    assert (tmodel.valid_signals, tmodel.num_classes, tmodel.causal) == (['PPG'], 4, False)


@pytest.mark.parametrize('chunk_causal', [True, False], ids=['chunk_causal', 'causal'])
def test_causal_kinds_are_prefix_invariant(chunk_causal):
    """As tests/model/test_causality.py: the first half of a night gives the
    first half of the whole night's logits. Layer norms throughout, as
    there: instance norm in a conv-causal encoder takes its statistics over
    the whole night, in both packages (checked below)."""
    cfg = wav2sleep_config(enc_norm='layer', causal=True, chunk_causal=chunk_causal)
    S = 16
    x = {k: _t(v) for k, v in wav2sleep_inputs(S=S, B=1, seed=4).items()}
    half = {k: v[:, : v.shape[1] // 2] for k, v in x.items()}
    model = tinstantiate.build_model(cfg).eval()
    with torch.no_grad():
        full, first = model(x), model(half)
    assert first.shape[1] == S // 2
    torch.testing.assert_close(full[:, : S // 2], first, atol=1e-5, rtol=1e-5)
    # Instance norm: per epoch (chunk-causal) it stays causal; over the
    # conv-causal night it reads the future, here and in JAX alike.
    cfg = wav2sleep_config(enc_norm='instance', causal=True, chunk_causal=chunk_causal)
    jmodel, variables, model = model_pair(cfg, {k: v[:1, : v.shape[1] // 8].numpy() for k, v in x.items()})
    with torch.no_grad():
        d = float((model.eval()(x)[:, : S // 2] - model(half)).abs().max())
    j = {k: {c: jnp.asarray(v.numpy()) for c, v in a.items()} for k, a in (('full', x), ('half', half))}
    d_jax = float(jnp.abs(jmodel.apply(variables, j['full'])[:, : S // 2] - jmodel.apply(variables, j['half'])).max())
    print(f'instance-norm encoders, chunk_causal={chunk_causal}: first half vs whole night max|d| {d:.3e} '
          f'(JAX {d_jax:.3e})')
    assert (d <= 1e-5) == (d_jax <= 1e-5) == chunk_causal


# ---------------------------------------------------------------- conversion


def _jax_export_mapping(variables, family):
    """The JAX package's own export of ``variables`` (its
    ``export_torch_state_dict``), as numpy."""
    import io

    buf = io.BytesIO()
    export_torch_state_dict(buf, variables, {'_target_': 'x.ppgnet.X'} if family == 'ppgnet' else None)
    buf.seek(0)
    return {k: v.numpy() for k, v in torch.load(buf, weights_only=True).items()}


@pytest.mark.parametrize('family', ['wav2sleep', 'ppgnet'])
def test_from_jax_variables_is_the_export_mapping(family, ppgnet_pair):
    """Batch-norm models of both families: the port's conversion gives the
    JAX package's export exactly (keys, [C] batch-norm affines, [1, C, 1]
    layer-norm affines, running statistics, ``num_batches_tracked`` 0),
    and the port's model holds those keys; the JAX package's reader takes
    the result back to the same variables."""
    if family == 'ppgnet':
        _, _, variables, tmodel = ppgnet_pair
    else:
        cfg = wav2sleep_config(enc_norm='batch', seq_norm='batch')
        _, variables, tmodel = model_pair(cfg, {k: v[:1] for k, v in wav2sleep_inputs(S=2).items()})
    want, got = _jax_export_mapping(variables, family), from_jax_variables(variables, family)
    assert sorted(got) == sorted(want) == sorted(tmodel.state_dict())
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k].numpy(), v), k
    back = convert_state_dict(got, family=family)
    flat_want, flat_back = _flatten(variables), _flatten(back)
    assert flat_back.keys() == flat_want.keys()
    assert all(np.array_equal(flat_back[k], flat_want[k]) for k in flat_want)


def test_weight_norm_crosses_through_params_npz(tmp_path):
    """The JAX package's torch export writes weight norm's ``kernel_v``
    untransposed under its flax name, which its own reader refuses
    (ROADMAP §C); its ``params.npz`` folder loads in the port, with
    ``weight_v`` / ``weight_g`` in torch's layout and equal logits."""
    cfg = wav2sleep_config(enc_norm='weight', seq_norm='weight')
    x = wav2sleep_inputs()
    jmodel, variables, _ = model_pair(cfg, {k: v[:1] for k, v in x.items()})
    exported = _jax_export_mapping(variables, 'wav2sleep')
    assert any(k.endswith('conv.kernel_v') for k in exported)
    with pytest.raises(ValueError, match='Unrecognised'):
        convert_state_dict(exported)
    jax_save_folder(str(tmp_path), cfg, variables, torch_compat=False)
    model = api.load_model(str(tmp_path), device='cpu')
    conv = model.signal_encoders.encoders['ECG'].cnn[0].conv1.conv
    assert conv.weight_v.shape == (8, 1, 3) and conv.weight_g.shape == (8, 1, 1)
    want = japi.load_model(str(tmp_path)).logits(x)
    with torch.no_grad():
        got = model({k: _t(v) for k, v in x.items()}).numpy()
    _close(got, want, what='weight norm through params.npz')


def _checkpoint_case(name, ppgnet_pair):
    """(config, variables, port model, inputs as numpy dict) of a batch-norm
    wav2sleep or of SleepPPG-Net."""
    if name == 'ppgnet':
        cfg, _, variables, tmodel = ppgnet_pair
        return cfg, variables, tmodel, {'PPG': np.random.default_rng(5).normal(size=(1, PPG_LEN)).astype(np.float32)}
    cfg = wav2sleep_config(enc_norm='instance', seq_norm=None, causal=True, chunk_causal=True)
    x = wav2sleep_inputs(seed=5)
    _, variables, tmodel = model_pair(cfg, {k: v[:1] for k, v in x.items()})
    return cfg, variables, tmodel, x


def _port_logits(model, x, family, dtype=torch.float32):
    with torch.no_grad():
        inp = {k: _t(v).to(dtype) for k, v in x.items()}
        return model(inp['PPG'] if family == 'ppgnet' else inp).float().numpy()


@pytest.mark.parametrize('name', ['batch_norm_wav2sleep', 'ppgnet'])
def test_port_folder_loads_in_jax(name, ppgnet_pair, tmp_path):
    """A folder the port writes (config.yaml, state_dict.pth with the
    running statistics) loads in the JAX package's ``load_model`` and gives
    the port's logits."""
    cfg, _, tmodel, x = _checkpoint_case(name, ppgnet_pair)
    family = tinstantiate.model_family(cfg)
    checkpoint.save_checkpoint_folder(str(tmp_path), cfg, tmodel.state_dict())
    want = _port_logits(tmodel.eval(), x, family)
    got = japi.load_model(str(tmp_path)).logits(x)
    _close(got, want, what=f'{name}: port folder in JAX')


@pytest.mark.parametrize('name', ['batch_norm_wav2sleep', 'ppgnet'])
def test_jax_folder_loads_in_the_port(name, ppgnet_pair, tmp_path):
    """A folder the JAX package writes with its torch export loads
    ``strict=True`` in the port's ``load_model`` with equal logits; bf16
    casts the running statistics as well as the parameters, as the JAX
    package casts all its variables; the module answers the family's
    questions."""
    cfg, variables, _, x = _checkpoint_case(name, ppgnet_pair)
    family = tinstantiate.model_family(cfg)
    jax_save_folder(str(tmp_path), cfg, variables, torch_compat=True)
    assert (tmp_path / 'state_dict.pth').exists()
    want = japi.load_model(str(tmp_path))
    model = api.load_model(str(tmp_path), device='cpu')
    _close(_port_logits(model, x, family), want.logits(x), what=f'{name}: JAX folder in the port')
    assert (model.valid_signals, model.num_classes, model.causal) == (want.valid_signals, want.num_classes,
                                                                       want.causal)
    bf16 = api.load_model(str(tmp_path), precision='bfloat16', device='cpu')
    floats = {v.dtype for v in bf16.state_dict().values() if v.is_floating_point()}
    assert floats == {torch.bfloat16} and any(k.endswith('running_var') for k in bf16.state_dict())
    assert np.isfinite(_port_logits(bf16, x, family, torch.bfloat16)).all()


def test_instantiate_refuses_unknown_ppgnet_targets():
    for cfg in ({'_target_': 'x.ppgnet.SleepPPGNet'}, {**ppgnet_config(), 'feature_dim': '${feature_dim}'}):
        with pytest.raises(ValueError):
            tinstantiate.build_model(cfg)
    cfg = tinstantiate.target_config(**{k: v for k, v in ppgnet_config().items() if k != '_target_'})
    assert cfg['_target_'] == 'wav2sleep.models.ppgnet.SleepPPGNet'
    assert isinstance(tinstantiate.build_model(cfg), SleepPPGNet)
