"""K1's and K2's gradients (``ops.conv_k3``) against the JAX package's
Pallas convs' ``custom_vjp`` (interpreted), on the CPU. Split from
``tests/test_torch_train.py`` so that the test run spreads them over its
workers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu.ops import block_domain as jbd
from wav2sleep_tpu.ops import pallas_conv
from wav2sleep_tpu_torch.ops import conv_k3 as k1

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_train import _t


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
