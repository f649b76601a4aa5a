"""The torch port's Wav2Sleep against the recorded goldens and against the
JAX package on the same weights and inputs (f32 on the CPU, where every k3
conv goes through ``conv_k3``'s plain version)."""

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
from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_model

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
    tmodel = flagship_model(32, max_channels=32)
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
    """The convs routed to K1 are exactly the encoders' k3 convs with C_in >= 8:
    at full width 2 + 3 per later block, 23 for ECG/PPG and 17 for ABD/THX.
    A forward calls ``conv_k3`` once for each of them."""
    model = flagship_model()
    per_encoder = {
        name: sum(m.kernel_eligible for m in enc.modules() if isinstance(m, layers.Conv1D))
        for name, enc in model.signal_encoders.encoders.items()
    }
    assert per_encoder == {'ABD': 17, 'THX': 17, 'ECG': 23, 'PPG': 23}
    calls, conv_k3 = [], layers.conv_k3

    def counting(*args):
        calls.append(args[0].shape[-1])
        return conv_k3(*args)

    monkeypatch.setattr(layers, 'conv_k3', counting)
    x = {k: torch.randn(1, COLS_TO_SAMPLES_PER_EPOCH[k]) for k in ('ABD', 'THX', 'ECG', 'PPG')}
    with torch.no_grad():
        assert model(x).shape == (1, 1, 4)
    assert len(calls) == 80 and min(calls) >= 8


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
