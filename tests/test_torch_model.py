"""The torch port's Wav2Sleep against the recorded goldens and against the
JAX package on the same weights and inputs (f32 on the CPU, where every k3
conv goes through the plain versions of ``conv_k3`` and ``conv_k3_stats``)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_model
from wav2sleep_tpu.convert import convert_state_dict
from wav2sleep_tpu.instantiate import instantiate
from wav2sleep_tpu.settings import COLS_TO_SAMPLES_PER_EPOCH
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.models import layers
from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config, flagship_model

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'goldens')
TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize('name', ['wav2sleep_cardio', 'wav2sleep_eog'])
def test_golden_logits(name):
    data = np.load(os.path.join(GOLDEN_DIR, f'{name}.npz'))
    cfg = json.loads(bytes(data['config_json']).decode())
    sd = {k[len('sd/') :]: torch.from_numpy(data[k]) for k in data.files if k.startswith('sd/')}
    x = {k[len('in/') :]: torch.from_numpy(data[k]) for k in data.files if k.startswith('in/')}
    assert any(torch.isinf(v).any() for v in x.values())  # missing-modality row

    model = build_wav2sleep(
        cfg['num_classes'], cfg['signal_map'], cfg['encoders'], cfg['epoch_mixer'], cfg['sequence_mixer']
    ).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        logits = model(x).numpy()
    assert logits.shape == data['logits'].shape
    np.testing.assert_allclose(logits, data['logits'], **TOL)


def jax_random_variables(jmodel, x0: dict, seed: int) -> dict:
    """Random numpy values on the parameter tree of ``jmodel.init`` (the tree
    comes from the JAX model; seeded values exercise every leaf, biases and
    norm scales included)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x0)['params']
    rng = np.random.default_rng(seed)

    def draw(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == 'scale':
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ('bias', 'register_tokens', 'embedding'):
            v = rng.normal(size=shape) * (1.0 if name != 'bias' else 0.1)
        else:  # conv / dense kernels: fan-in scaled
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, size=shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return {'params': jax.tree_util.tree_map(np.asarray, params)}


@pytest.fixture(scope='module')
def narrow_flagship():
    """JAX and torch flagship models at feature_dim 32, channels 16-32, on
    the same weights."""
    _, cfg = _flagship_model(feature_dim=32)
    cfg['signal_encoders']['max_channels'] = 32
    jmodel = instantiate(cfg)
    x0 = {k: np.zeros((1, 2 * COLS_TO_SAMPLES_PER_EPOCH[k]), np.float32) for k in ('ABD', 'THX', 'ECG', 'PPG')}
    variables = jax_random_variables(jmodel, x0, seed=0)
    tmodel = flagship_model(32, max_channels=32, device='cpu')
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, tmodel


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_flagship_matches_jax_with_missing_modality_and_present_mask(narrow_flagship):
    jmodel, variables, tmodel = narrow_flagship
    S, B = 4, 3
    rng = np.random.default_rng(1)
    x = {
        k: (rng.normal(size=(B, S * COLS_TO_SAMPLES_PER_EPOCH[k])) * 2.0 + 0.5).astype(np.float32)
        for k in ('ABD', 'THX', 'ECG', 'PPG')
    }
    x['PPG'][1] = -np.inf  # the -inf missing-modality sentinel
    present = {'THX': np.array([True, True, False]), 'ECG': np.array([True, False, True])}

    want = np.asarray(
        jax.jit(jmodel.apply)(variables, {k: jnp.asarray(v) for k, v in x.items()},
                              present={k: jnp.asarray(v) for k, v in present.items()})
    )
    with torch.no_grad():
        got = tmodel(
            {k: torch.from_numpy(v) for k, v in x.items()},
            present={k: torch.from_numpy(v) for k, v in present.items()},
        ).numpy()
    assert got.shape == (B, S, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_kernel_dispatch_covers_every_encoder_k3_conv(monkeypatch):
    """The convs routed to the kernels are exactly the encoders' k3 convs
    with C_in >= 8: at full width 2 + 3 per later block, 23 for ECG/PPG and
    17 for ABD/THX. A forward that no backward follows calls
    ``conv_k3_stats`` (K2) once for each of them, and ``conv_k3`` never."""
    model = flagship_model(device='cpu')
    per_encoder = {
        name: sum(m.kernel_eligible for m in enc.modules() if isinstance(m, layers.Conv1D))
        for name, enc in model.signal_encoders.encoders.items()
    }
    assert per_encoder == {'ABD': 17, 'THX': 17, 'ECG': 23, 'PPG': 23}
    calls = {'conv_k3': [], 'conv_k3_stats': []}
    for name, seen in calls.items():
        fn = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *args, fn=fn, seen=seen: seen.append(args[0].shape[-1]) or fn(*args))
    x = {k: torch.randn(1, COLS_TO_SAMPLES_PER_EPOCH[k]) for k in ('ABD', 'THX', 'ECG', 'PPG')}
    with torch.no_grad():
        assert model(x).shape == (1, 1, 4)
    assert len(calls['conv_k3_stats']) == 80 and min(calls['conv_k3_stats']) >= 8 and not calls['conv_k3']


def test_state_dict_round_trip_is_exact(narrow_flagship):
    _, variables, tmodel = narrow_flagship
    back = convert_state_dict(from_jax_variables(variables))
    assert set(back) == {'params'}
    want, got = _flat(variables['params']), _flat(back['params'])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # The loaded port model carries exactly those values under those keys.
    sd, carried = tmodel.state_dict(), from_jax_variables(variables)
    assert sd.keys() == carried.keys()
    assert all(torch.equal(sd[k], carried[k]) for k in sd)


def test_from_jax_variables_is_the_checkpoint_mapping(narrow_flagship):
    """The port's own key and value mapping gives exactly what the JAX
    package's checkpoint export mapping gives (flatten, key rename, kernel
    transposes, [1, C, 1] layer-norm affines)."""
    from wav2sleep_tpu.checkpoint import _SEP, _flatten as jflatten, _to_torch_key, _to_torch_value

    _, variables, _ = narrow_flagship
    want = {}
    for key, w in jflatten(variables['params']).items():
        value = _to_torch_value(key, np.asarray(w, dtype=np.float32))
        parts = key.split(_SEP)
        if parts[-1] in ('scale', 'bias') and parts[-2] == 'norm':
            value = value.reshape(1, -1, 1)
        want[_to_torch_key(key, 'wav2sleep')] = value
    got = from_jax_variables(variables)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        assert np.array_equal(got[k].numpy(), v), k


@pytest.mark.parametrize('variant', ['cardio', 'eog'])
def test_seeded_init_draws_from_the_jax_packages_distributions(variant):
    """Every parameter of the port's seeded init comes from the distribution
    that the JAX package's ``init`` draws it from (other draws): the same
    standard deviation within 10% and the same largest magnitude within 15%
    where a tensor has the elements to show it, and the same constants (zero
    biases, unit scales). The transformer's kernels are flax's truncated
    normal, whose spread is sqrt(3) times the uniform's of the other kernels;
    the port once drew them uniform."""
    _, cfg = _flagship_model(feature_dim=128, variant=variant)
    cfg['signal_encoders']['max_channels'] = 16
    cfg['signal_encoders']['embed_signals'] = True
    signals = list(cfg['signal_encoders']['signal_map'])
    x0 = {k: np.zeros((1, 2 * COLS_TO_SAMPLES_PER_EPOCH[k]), np.float32) for k in signals}
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, instantiate(cfg).init(jax.random.PRNGKey(0), x0)))
    tcfg = flagship_config(128, 16, variant)
    tcfg['encoders']['embed_signals'] = True
    got = build_wav2sleep(**tcfg, generator=torch.Generator().manual_seed(1)).state_dict()
    assert set(got) == set(want)
    n_spread = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if float(w.std()) == 0.0:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=k)
        elif w.numel() >= 1024:  # the smaller tensors have too few draws to hold to 10%
            assert abs(float(g.std() / w.std()) - 1) < 0.10, (k, float(g.std()), float(w.std()))
            if w.numel() >= 4096:
                assert abs(float(g.abs().max() / w.abs().max()) - 1) < 0.15, k
            n_spread += 1
    assert n_spread >= 20


@torch.no_grad()
def uniform_kernel_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """``model`` with its parameters redrawn from a seed-``seed`` generator in
    the port's init order, but with every dense kernel (the transformer's
    too) uniform +-1/sqrt(fan_in) like the conv kernels: the weights that
    tests whose gates were set on one seeded draw keep, whatever the init's
    scheme for the transformer becomes."""
    from wav2sleep_tpu_torch.models.norms import ConvLayerNorm
    from wav2sleep_tpu_torch.models.transformer import MultiHeadSelfAttention
    from wav2sleep_tpu_torch.models.wav2sleep import MultiModalAttentionEmbedder

    generator = torch.Generator().manual_seed(seed)

    def uniform(w):
        bound = 1.0 / np.sqrt(w[0].numel())
        w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)

    for m in model.modules():
        if isinstance(m, layers.Conv1D) and hasattr(m, 'weight_v'):
            uniform(m.weight_v)
            m.weight_g.fill_(1.0)
        elif isinstance(m, (layers.Conv1D, torch.nn.Linear)):
            uniform(m.weight)
        elif isinstance(m, MultiHeadSelfAttention):
            uniform(m.in_proj_weight)
        elif isinstance(m, (torch.nn.LayerNorm, ConvLayerNorm)):
            m.weight.fill_(1.0)
        elif isinstance(m, torch.nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, MultiModalAttentionEmbedder):
            m.register_tokens.copy_(torch.randn(m.register_tokens.shape, generator=generator))
    return model
