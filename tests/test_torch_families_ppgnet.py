"""The full-length SleepPPG-Net of the port against the JAX package's on
the CPU: eval and train mode (running statistics), its weight conversion
and checkpoint folders both ways. Split from
``tests/test_torch_families.py`` (whose helpers it uses) so that the test
run spreads files over its workers. Logits within atol/rtol 5e-4, running
statistics within rtol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu_torch import instantiate as tinstantiate

from .test_torch_families import (PPG_LEN, _close, _t, check_export_mapping, check_jax_folder_in_the_port,
                                  check_port_folder_in_jax, check_stats, model_pair, ppgnet_config)
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse


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


@pytest.mark.parametrize('family', ['ppgnet'])
def test_from_jax_variables_is_the_export_mapping(family, ppgnet_pair):
    """SleepPPG-Net: see ``test_torch_families.check_export_mapping``."""
    check_export_mapping(family, ppgnet_pair)


@pytest.mark.parametrize('name', ['ppgnet'])
def test_port_folder_loads_in_jax(name, ppgnet_pair, tmp_path):
    """SleepPPG-Net: see ``test_torch_families.check_port_folder_in_jax``."""
    check_port_folder_in_jax(name, ppgnet_pair, tmp_path)


@pytest.mark.parametrize('name', ['ppgnet'])
def test_jax_folder_loads_in_the_port(name, ppgnet_pair, tmp_path):
    """SleepPPG-Net: see ``test_torch_families.check_jax_folder_in_the_port``."""
    check_jax_folder_in_the_port(name, ppgnet_pair, tmp_path)
