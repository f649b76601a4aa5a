"""K1's CUDA kernel against its plain PyTorch version, on an NVIDIA card.

Every case is marked ``cuda`` and skips without a card. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from wav2sleep_tpu_torch.ops import conv_k3 as k1

pytestmark = pytest.mark.cuda

CASES = [
    # (B, T, C_in, C_out, stride): the encoder shapes, plus ragged lengths,
    # channel counts that are not a multiple of the 16-channel staging chunk,
    # and one batch row.
    (2, 2048, 16, 16, 1),
    (2, 2048, 16, 16, 2),
    (2, 1024, 16, 32, 1),
    (2, 1024, 32, 32, 2),
    (2, 512, 32, 64, 1),
    (2, 512, 64, 64, 2),
    (2, 256, 64, 128, 1),
    (2, 256, 128, 128, 2),
    (3, 1001, 8, 16, 1),
    (1, 999, 24, 32, 2),
    (1, 5, 128, 128, 2),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(B, T, ci, co, device, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return (
        t(rng.normal(size=(B, T, ci)) * 1.5 + 0.3),
        t(rng.normal(size=(3, ci, co)) / np.sqrt(3 * ci)),
        t(rng.normal(size=(co,)) * 0.1),
        t(rng.normal(size=(B, ci)) * 0.3),
        t(rng.uniform(0.5, 2.0, size=(B, ci))),
    )


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,ci,co,stride', CASES)
def test_kernel_matches_plain(card, B, T, ci, co, stride, dtype):
    x, w, b, mu, inv = _inputs(B, T, ci, co, card, seed=B * T + ci + co + stride)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    for args in ((b, None, None, stride, None), (None, mu, inv, stride, 'gelu'), (b, mu, inv, stride, 'gelu')):
        before = k1.LAUNCHES
        got = k1.conv_k3(x, w, *args)
        assert k1.LAUNCHES == before + 1
        want = k1.conv_k3_reference(x, w, *args)
        assert got.shape == want.shape == (B, k1.output_length(T, stride), co)
        assert got.dtype == dtype and got.is_contiguous()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            # Both round y to bf16 once; the plain version also rounds phi.
            ref = want.float()
            assert bool(((got.float() - ref).abs() <= 2**-6 * (ref.abs() + ref.square().mean().sqrt())).all())


@pytest.mark.parametrize('act', ['linear', 'relu', 'leaky', 'silu', 'gelu'])
def test_every_fused_activation(card, act):
    x, w, b, mu, inv = _inputs(2, 777, 32, 64, card, seed=1)
    got = k1.conv_k3(x, w, b, mu, inv, 1, act)
    torch.testing.assert_close(got, k1.conv_k3_reference(x, w, b, mu, inv, 1, act), atol=1e-4, rtol=1e-4)


def test_kernel_backward_is_the_plain_one(card):
    x, w, b, mu, inv = (a.requires_grad_() for a in _inputs(2, 300, 16, 32, card, seed=2))
    g = torch.randn(2, 150, 32, device=card)
    got = torch.autograd.grad(k1.conv_k3(x, w, b, mu, inv, 2, 'gelu'), (x, w, b, mu, inv), g)
    want = torch.autograd.grad(k1.conv_k3_reference(x, w, b, mu, inv, 2, 'gelu'), (x, w, b, mu, inv), g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e)


def test_kernel_refuses_what_it_does_not_take(card):
    x, w, b, mu, inv = _inputs(2, 64, 16, 16, card, seed=3)
    with pytest.raises(ValueError, match='C_out'):
        k1.conv_k3(x, torch.zeros(3, 16, 24, device=card))
    with pytest.raises(ValueError, match='stride'):
        k1.conv_k3(x, w, stride=3)
    with pytest.raises(TypeError, match='dtype'):
        k1.conv_k3(x.half(), w.half())
    with pytest.raises(TypeError, match='mu'):
        k1.conv_k3(x, w, None, mu.double(), inv.double())
    with pytest.raises(ValueError, match='contiguous'):
        k1.conv_k3(x.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match='on cpu'):
        k1.conv_k3(x, w.cpu())
