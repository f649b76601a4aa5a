"""K2 (wav2sleep_tpu_torch.ops.conv_k3.conv_k3_stats) against the JAX
package's Pallas stats kernels in interpret mode: the conv output and its
instance-norm statistics with phi as the identity (``sd_conv_blocks_stats``)
and as fused instance norm + gelu (``sd_conv_blocks_fused_stats``), at
atol/rtol 2e-4; the port's ``ConvBlock1D`` in the kernel-statistics
configuration against the JAX ``ConvBlock1D`` on its block path with
in-kernel statistics, on the same weights; and the switch itself. On the
CPU ``conv_k3_stats`` runs its plain version; the kernel is checked on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu.models.layers import ConvBlock1D as JaxConvBlock1D
from wav2sleep_tpu.ops import block_domain as bd
from wav2sleep_tpu.ops import pallas_conv
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.models import layers
from wav2sleep_tpu_torch.ops import block_domain as tbd
from wav2sleep_tpu_torch.ops import conv_k3 as k1

from .test_torch_conv_k3 import SHAPES, TOL, _inputs
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

EPS = 1e-2  # the encoders' instance-norm eps


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pallas_conv, '_INTERPRET', True)  # CPU: run the Pallas kernels interpreted


def _from_blocks(data, channels):
    return np.asarray(bd.from_blocks(bd.BlockedArray(data=data, channels=channels)))


@pytest.mark.parametrize('ci,co,stride', SHAPES)
def test_identity_phi_matches_pallas(interpret, ci, co, stride):
    x, w, b, _, _ = _inputs(ci, co, stride, seed=3 * ci + co + stride)
    data = bd.to_blocks(jnp.asarray(x)).data
    y, mu, inv = pallas_conv.sd_conv_blocks_stats(data, jnp.asarray(w), jnp.asarray(b), ci, co, stride, EPS)
    got = k1.conv_k3_stats(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride, eps=EPS)
    for g, want in zip(got, (_from_blocks(y, co), np.asarray(mu), np.asarray(inv))):
        assert g.shape == want.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.mark.parametrize('ci,co,stride', SHAPES)
def test_fused_norm_gelu_matches_pallas(interpret, ci, co, stride):
    x, w, b, mu_in, inv_in = _inputs(ci, co, stride, seed=5 * ci + co + stride)
    data = bd.to_blocks(jnp.asarray(x)).data
    y, mu, inv = pallas_conv.sd_conv_blocks_fused_stats(
        data, jnp.asarray(w), jnp.asarray(b), jnp.asarray(mu_in), jnp.asarray(inv_in), ci, co, stride, 'gelu', EPS
    )
    got = k1.conv_k3_stats(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(mu_in), torch.from_numpy(inv_in), stride, 'gelu', EPS,
    )
    for g, want in zip(got, (_from_blocks(y, co), np.asarray(mu), np.asarray(inv))):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, **TOL)


@pytest.fixture
def jax_kernel_stats_path(monkeypatch, interpret):
    """The JAX block path with in-kernel statistics, forced on for the CPU
    as tests/ops/test_block_domain.py forces it."""
    monkeypatch.setattr(bd, 'FORCE_BLOCK_PATH', True)
    monkeypatch.setattr(bd, 'MIN_PROMOTE_LENGTH', 256)
    monkeypatch.setattr(bd, 'KERNEL_STATS', True)


@pytest.mark.parametrize('cin,features,T,k2_convs', [(1, 16, 2048, 2), (16, 32, 1024, 3)])
def test_convblock_kernel_stats_matches_jax(jax_kernel_stats_path, monkeypatch, cin, features, T, k2_convs):
    """The entry block (C_in = 1: conv1 has no kernel, so its statistics
    come from block_stats) and a later block, on the same weights. atol
    2e-4 / rtol 2e-3, the bound tests/ops/test_block_domain.py holds the JAX
    block path to against its own plain path."""
    x = np.random.default_rng(cin + features).normal(size=(2, T, cin)).astype(np.float32)
    jblock = JaxConvBlock1D(features=features, activation='gelu', norm='instance', norm_eps=EPS, block_domain=True)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jblock.apply(variables, jnp.asarray(x))
    want = _from_blocks(want.data, want.channels) if isinstance(want, bd.BlockedArray) else np.asarray(want)

    monkeypatch.setattr(tbd, 'KERNEL_STATS', True)
    calls = []
    monkeypatch.setattr(layers, 'conv_k3_stats', lambda *a: calls.append(a[0].shape) or k1.conv_k3_stats(*a))
    block = layers.ConvBlock1D(cin, features, norm_eps=EPS, use_kernel=True).eval()
    block.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert len(calls) == k2_convs
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_stats_configuration_is_the_same_function(monkeypatch):
    """On the CPU the kernel-statistics chain computes what the default
    chain computes, and the switch reads WAV2SLEEP_KERNEL_STATS only when the
    module flag is None."""
    block = layers.ConvBlock1D(16, 32, norm_eps=EPS, use_kernel=True).eval()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 512, 16)).astype(np.float32))
    with torch.no_grad():
        monkeypatch.setattr(tbd, 'KERNEL_STATS', False)
        off = block(x)
        monkeypatch.setattr(tbd, 'KERNEL_STATS', True)
        on = block(x)
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    monkeypatch.setattr(tbd, 'KERNEL_STATS', None)
    monkeypatch.delenv('WAV2SLEEP_KERNEL_STATS', raising=False)
    assert not tbd.kernel_stats_enabled()
    monkeypatch.setenv('WAV2SLEEP_KERNEL_STATS', '1')
    assert tbd.kernel_stats_enabled()


@pytest.mark.parametrize('stride', [1, 2])
def test_autograd_matches_plain(stride):
    rng = np.random.default_rng(stride)
    small = [
        torch.from_numpy(rng.normal(size=s)).requires_grad_()
        for s in ((1, 8, 3), (3, 3, 16), (16,), (1, 3), (1, 3))
    ]
    fn = lambda *a: k1.conv_k3_stats(*a, stride, 'gelu', EPS)  # noqa: E731
    assert torch.autograd.gradcheck(fn, small)
    outs = fn(*small)
    ref = k1.conv_k3_stats_reference(*small, stride, 'gelu', EPS)
    gs = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, small, gs)
    want = torch.autograd.grad(ref, small, gs)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=1e-12, rtol=1e-12)
