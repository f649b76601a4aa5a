"""K2 (wav2sleep_tpu_torch.ops.conv_k3.conv_k3_stats) against the JAX
package's Pallas stats kernels in interpret mode: the conv output and its
instance-norm statistics with phi as the identity (``sd_conv_blocks_stats``)
and as fused instance norm + gelu (``sd_conv_blocks_fused_stats``), at
atol/rtol 2e-4; the port's ``ConvBlock1D`` in the kernel-statistics
configuration against the JAX ``ConvBlock1D`` on its block path with
in-kernel statistics, on the same weights; and the rule that picks where the
fused chain takes its statistics from. On the
CPU ``conv_k3_stats`` runs its plain version; the kernel is checked on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import contextlib

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
    """On the CPU the kernel-statistics chain computes what the K1 +
    ``block_stats`` chain computes. With the module flag None the rule
    decides per call: kernel statistics where autograd records nothing for
    the call's tensors, and WAV2SLEEP_KERNEL_STATS forces them; the module
    flag, when set, overrides both."""
    block = layers.ConvBlock1D(16, 32, norm_eps=EPS, use_kernel=True).eval()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 512, 16)).astype(np.float32))
    with torch.no_grad():
        monkeypatch.setattr(tbd, 'KERNEL_STATS', False)
        off = block(x)
        monkeypatch.setattr(tbd, 'KERNEL_STATS', True)
        on = block(x)
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    recorded = torch.ones(1, requires_grad=True)
    monkeypatch.setattr(tbd, 'KERNEL_STATS', None)
    monkeypatch.delenv('WAV2SLEEP_KERNEL_STATS', raising=False)
    assert tbd.kernel_stats_enabled()
    assert tbd.kernel_stats_enabled(torch.ones(1), None)
    assert not tbd.kernel_stats_enabled(torch.ones(1), recorded)
    with torch.no_grad():
        assert tbd.kernel_stats_enabled(recorded)
    with torch.inference_mode():
        assert tbd.kernel_stats_enabled(recorded)
    monkeypatch.setenv('WAV2SLEEP_KERNEL_STATS', '1')
    assert tbd.kernel_stats_enabled()
    assert tbd.kernel_stats_enabled(recorded)
    monkeypatch.setattr(tbd, 'KERNEL_STATS', False)
    with torch.no_grad():
        assert not tbd.kernel_stats_enabled(recorded)
    monkeypatch.setattr(tbd, 'KERNEL_STATS', True)
    assert tbd.kernel_stats_enabled(recorded)


@pytest.mark.parametrize('cin', [1, 16])
@pytest.mark.parametrize('recording', ['no_grad', 'frozen', 'grad'])
@pytest.mark.parametrize('flag', [None, True, False])
def test_fused_chain_takes_statistics_by_the_rule(monkeypatch, flag, recording, cin):
    """Which path a fused block's kernel convs take: K2 (``conv_k3_stats``)
    where the flag is True, or None and autograd records nothing (under
    ``no_grad``, or with grad on over frozen parameters and an input that
    needs none); K1 (``conv_k3``) and ``block_stats`` where the flag is
    False, or None and a backward follows. The entry conv (C_in 1, no
    kernel) takes ``block_stats`` on every path. The block's output is the
    same on every path, to the bit."""
    monkeypatch.delenv('WAV2SLEEP_KERNEL_STATS', raising=False)
    block = layers.ConvBlock1D(cin, 32, norm_eps=EPS, use_kernel=True)
    x = torch.from_numpy(np.random.default_rng(cin).normal(size=(2, 256, cin)).astype(np.float32))
    monkeypatch.setattr(tbd, 'KERNEL_STATS', False)
    with torch.no_grad():
        want = block(x)
    if recording == 'frozen':
        block.requires_grad_(False)
    calls = {'conv_k3': 0, 'conv_k3_stats': 0, 'block_stats': 0}

    def spy(name):
        fn = getattr(layers, name)

        def counted(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(layers, name, counted)

    for name in calls:
        spy(name)
    monkeypatch.setattr(tbd, 'KERNEL_STATS', flag)
    with torch.no_grad() if recording == 'no_grad' else contextlib.nullcontext():
        got = block(x)
    k2 = flag is True or (flag is None and recording != 'grad')
    n_kernel = 3 if cin >= 8 else 2
    assert calls == {
        'conv_k3': 0 if k2 else n_kernel,
        'conv_k3_stats': n_kernel if k2 else 0,
        'block_stats': 3 - n_kernel + (0 if k2 else n_kernel),
    }
    assert got.requires_grad == (recording == 'grad')
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)


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
