"""Every norm kind of the port through ``ConvLayer1D`` and ``ConvBlock1D``
(batch norm in train mode with its running statistics, and in eval mode),
causal and not, against the JAX package's on the CPU. Split from
``tests/test_torch_families.py`` (whose helpers it uses) so that the test
run spreads files over its workers. Logits within atol/rtol 5e-4, running
statistics within rtol 1e-4."""

import numpy as np
import pytest
import torch

from wav2sleep_tpu.models import layers as jlayers
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.models import layers

from .test_torch_families import _close, _t, check_stats, jax_variables
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse


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
