"""K1 (wav2sleep_tpu_torch.ops.conv_k3) against the JAX package's Pallas k3
conv run in interpret mode: forward on the Pallas kernel's test shapes with
phi as the identity and as fused instance norm + gelu, in f32 and in bf16,
the autograd Function's gradients, and the wrapper's refusals. On the CPU
``conv_k3`` runs its plain version; the kernel itself is checked on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wav2sleep_tpu.ops import block_domain as bd
from wav2sleep_tpu.ops import pallas_conv
from wav2sleep_tpu_torch.ops import conv_k3 as k1

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

pallas_conv._INTERPRET = True  # CPU: run the Pallas kernel interpreted

SHAPES = [
    # (Ci, Co, stride): tests/ops/test_pallas_conv.py's encoder shapes.
    (16, 16, 1),
    (16, 16, 2),
    (16, 32, 1),
    (32, 32, 2),
    (32, 64, 1),
    (64, 64, 2),
    (64, 128, 1),
    (128, 128, 2),
]
TOL = dict(atol=2e-4, rtol=2e-4)
# bf16: |plain - Pallas| <= tol * (|y| + rms(y)). With phi the identity both
# sum the exact bf16 products in f32, in their own orders, and round y once:
# 1 bf16 ulp (2**-8 to 2**-7 of |y|). With norm + gelu both round phi(x) to
# bf16 before the products, but the Pallas kernel also rounds the shift and
# the scale to bf16 and computes x - shift and its product with the scale in
# bf16: up to 4 roundings of 2**-9 per term, partly shared by a channel's
# terms, which in the worst alignment sum to 2**-7 of sum |w phi(x)|, about
# 2**-5 of rms(y) at these widths.
BF16_TOL = {'identity': 2.0**-7, 'norm+gelu': 2.0**-5}


def _inputs(ci, co, stride, seed):
    rng = np.random.default_rng(seed)
    B, L = 2, 1024 * stride
    x = rng.normal(size=(B, L, ci)).astype(np.float32) * 1.5 + 0.3
    w = (rng.normal(size=(3, ci, co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    mu = rng.normal(size=(B, ci)).astype(np.float32) * 0.3
    inv = rng.uniform(0.5, 2.0, size=(B, ci)).astype(np.float32)
    return x, w, b, mu, inv


@pytest.mark.parametrize('ci,co,stride', SHAPES)
def test_identity_phi_matches_pallas(ci, co, stride):
    x, w, b, _, _ = _inputs(ci, co, stride, seed=ci + co + stride)
    want = np.asarray(pallas_conv.sd_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride))
    got = k1.conv_k3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('ci,co,stride', SHAPES)
def test_fused_norm_gelu_matches_pallas(ci, co, stride):
    x, w, b, mu, inv = _inputs(ci, co, stride, seed=7 * ci + co + stride)
    data = bd.to_blocks(jnp.asarray(x)).data
    out = pallas_conv.sd_conv_blocks_fused(
        data, jnp.asarray(w), jnp.asarray(b), jnp.asarray(mu), jnp.asarray(inv), ci, co, stride, 'gelu'
    )
    want = np.asarray(bd.from_blocks(bd.BlockedArray(data=out, channels=co)))
    got = k1.conv_k3(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(mu), torch.from_numpy(inv), stride, 'gelu',
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('phi', ['identity', 'norm+gelu'])
@pytest.mark.parametrize('ci,co,stride', [(16, 16, 1), (32, 64, 1), (16, 32, 2), (64, 128, 2)])
def test_bf16_matches_pallas(ci, co, stride, phi):
    """bf16 x, w, b (f32 mu, inv) through the Pallas kernel and through K1's
    plain version, which rounds phi(x) as the CUDA kernel does."""
    x, w, b, mu, inv = _inputs(ci, co, stride, seed=11 * ci + co + stride)
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    xt, wt, bt = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (xj, wj, bj))
    if phi == 'identity':
        want = pallas_conv.sd_conv(xj, wj, bj, stride)
        got = k1.conv_k3(xt, wt, bt, stride=stride)
    else:
        data = bd.to_blocks(xj).data
        out = pallas_conv.sd_conv_blocks_fused(data, wj, bj, jnp.asarray(mu), jnp.asarray(inv), ci, co, stride, 'gelu')
        want = bd.from_blocks(bd.BlockedArray(data=out, channels=co))
        got = k1.conv_k3(xt, wt, bt, torch.from_numpy(mu), torch.from_numpy(inv), stride, 'gelu')
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16 and got.shape == want.shape
    want = np.asarray(want.astype(jnp.float32))
    bound = BF16_TOL[phi] * (np.abs(want) + np.sqrt(np.mean(want**2)))
    assert (np.abs(got.float().numpy() - want) <= bound).all()


@pytest.mark.parametrize('stride', [1, 2])
def test_autograd_matches_plain(stride):
    x, w, b, mu, inv = _inputs(16, 32, stride, seed=3)
    args = [torch.from_numpy(a).double().requires_grad_() for a in (x[:, :256], w, b, mu, inv)]
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 256 // stride, 32)))
    got = torch.autograd.grad(k1.conv_k3(*args, stride, 'gelu'), args, g)
    want = torch.autograd.grad(k1.conv_k3_reference(*args, stride, 'gelu'), args, g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=1e-12, rtol=1e-12)
    # Finite differences through the Function, on a small problem.
    rng = np.random.default_rng(5)
    small = [
        torch.from_numpy(rng.normal(size=s)).requires_grad_()
        for s in ((1, 8, 3), (3, 3, 16), (16,), (1, 3), (1, 3))
    ]
    assert torch.autograd.gradcheck(lambda *a: k1.conv_k3(*a, stride, 'gelu'), small)


def test_identity_grads_without_stats():
    x, w, b, _, _ = _inputs(16, 16, 1, seed=5)
    xt, wt = torch.from_numpy(x[:, :64]).requires_grad_(), torch.from_numpy(w).requires_grad_()
    gx, gw = torch.autograd.grad(k1.conv_k3(xt, wt).square().sum(), (xt, wt))
    rx, rw = torch.autograd.grad(k1.conv_k3_reference(xt, wt).square().sum(), (xt, wt))
    torch.testing.assert_close(gx, rx)
    torch.testing.assert_close(gw, rw)


def test_wrapper_refusals():
    x = torch.zeros(1, 16, 16)
    w = torch.zeros(3, 16, 16)
    with pytest.raises(ValueError, match='together'):
        k1.conv_k3(x, w, mu=torch.zeros(1, 16))
    with pytest.raises(ValueError, match='activation'):
        k1.conv_k3(x, w, act='tanh')
    # The kernel path itself takes CUDA tensors only, and only what the
    # kernel supports; the CPU plain path never reaches it.
    with pytest.raises(ValueError, match='CUDA'):
        k1._launch(x, w, None, None, None, 1, None)
    assert k1.output_length(1024, 2) == 512 and k1.output_length(1023, 2) == 512
