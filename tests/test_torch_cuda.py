"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card: K1 and K2 (``ops/conv_k3.py``) and K3 (``ops/ema_norm.py``).

Every case is marked ``cuda`` and skips without a card. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from wav2sleep_tpu_torch.models import layers
from wav2sleep_tpu_torch.ops import block_domain as bd
from wav2sleep_tpu_torch.ops import conv_k3 as k1
from wav2sleep_tpu_torch.ops import ema_norm

pytestmark = pytest.mark.cuda

# Output times per tile of the bf16 kernel with C_in = C_out, by (C_out,
# stride): ``w2s_conv_k3_tile``, checked by ``test_bf16_tiles``.
BF16_TILE = {(16, 1): 512, (16, 2): 256, (32, 1): 256, (32, 2): 128,
             (64, 1): 128, (64, 2): 128, (128, 1): 64, (128, 2): 64}

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
    # Rows of 24 bytes (C_in % 8 != 0): the kernel's narrow staging.
    (2, 1000, 12, 32, 1),
    (2, 999, 12, 16, 2),
    # One batch row, t_out shorter than one tile.
    (1, 100, 16, 16, 1),
    (1, 37, 32, 64, 2),
] + [
    # t_out one under, at and one over a bf16 tile: the halo across tile edges.
    (2, stride * (tile + d), co, co, stride)
    for (co, stride), tile in BF16_TILE.items()
    for d in (-1, 0, 1)
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('act', ['linear', 'relu', 'leaky', 'silu', 'gelu'])
def test_every_fused_activation(card, act, dtype):
    x, w, b, mu, inv = _inputs(2, 777, 32, 64, card, seed=1)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    got = k1.conv_k3(x, w, b, mu, inv, 1, act)
    want = k1.conv_k3_reference(x, w, b, mu, inv, 1, act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        ref = want.float()
        assert bool(((got.float() - ref).abs() <= 2**-6 * (ref.abs() + ref.square().mean().sqrt())).all())


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
    for ci in (4, 144):
        xc, wc = torch.zeros(2, 64, ci, device=card), torch.zeros(3, ci, 128, device=card)
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match='C_in'):
                k1.conv_k3(xc.to(dtype), wc.to(dtype))
            with pytest.raises(ValueError, match='C_in'):
                k1.conv_k3_stats(xc.to(dtype), wc.to(dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,ci,co,stride', CASES)
def test_k2_matches_plain(card, B, T, ci, co, stride, dtype):
    """K2's y as K1's; its statistics equal block_stats over its own stored
    y (rtol/atol 1e-5: the same values, reduced in another order)."""
    x, w, b, mu, inv = _inputs(B, T, ci, co, card, seed=B * T + ci + co + stride + 1)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    for args in ((b, None, None, stride, None), (b, mu, inv, stride, 'gelu')):
        before = k1.STATS_LAUNCHES, k1.LAUNCHES
        y, mu_k, inv_k = k1.conv_k3_stats(x, w, *args, 1e-2)
        assert (k1.STATS_LAUNCHES, k1.LAUNCHES) == (before[0] + 1, before[1])
        torch.testing.assert_close(y, k1.conv_k3(x, w, *args), rtol=0, atol=0)
        assert mu_k.shape == inv_k.shape == (B, co) and mu_k.dtype == torch.float32
        mu_r, inv_r = bd.block_stats(y, 1e-2)
        torch.testing.assert_close(mu_k, mu_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(inv_k, inv_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k2_is_deterministic(card, dtype):
    # 8 x 200,001 times: thousands of tiles, more than the resident blocks.
    x, w, b, mu, inv = _inputs(8, 200_001, 16, 16, card, seed=7)
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    first = k1.conv_k3_stats(x, w, b, mu, inv, 1, 'gelu', 1e-2)
    for _ in range(3):
        for a, e in zip(k1.conv_k3_stats(x, w, b, mu, inv, 1, 'gelu', 1e-2), first):
            assert torch.equal(a, e)


def test_bf16_tiles(card):
    lib = k1.build()
    assert {key: lib.w2s_conv_k3_tile(key[0], key[0], key[1], 1) for key in BF16_TILE} == BF16_TILE


def test_misaligned_input_takes_the_narrow_path(card):
    """An x that is not 16-byte aligned is staged by 2-byte loads in the
    same kernel, and agrees as an aligned one does."""
    B, T, ci, co = 2, 700, 16, 32
    x, w, b, mu, inv = _inputs(B, T, ci, co, card, seed=11)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    flat = torch.empty(B * T * ci + 1, dtype=torch.bfloat16, device=card)
    shifted = flat[1:].view(B, T, ci)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for args in ((b, None, None, 2, None), (b, mu, inv, 1, 'gelu')):
        torch.testing.assert_close(k1.conv_k3(shifted, w, *args), k1.conv_k3(x, w, *args), rtol=0, atol=0)
        for a, e in zip(k1.conv_k3_stats(shifted, w, *args, 1e-2), k1.conv_k3_stats(x, w, *args, 1e-2)):
            torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_convblock_kernel_stats_on_the_card(card, monkeypatch):
    block = layers.ConvBlock1D(16, 32, norm_eps=1e-2, use_kernel=True).to(card).eval()
    x = torch.randn(2, 4096, 16, device=card, generator=torch.Generator(device=card).manual_seed(0))
    with torch.no_grad():
        monkeypatch.setattr(bd, 'KERNEL_STATS', False)
        off = block(x)
        monkeypatch.setattr(bd, 'KERNEL_STATS', True)
        before = k1.STATS_LAUNCHES
        on = block(x)
    assert k1.STATS_LAUNCHES == before + 3
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)


def test_k3_matches_plain(card):
    """Ragged groups in one launch: rows shorter than the kernel's 8-sample
    load-ahead, a single row, different rates, an outlier; atol 1e-4 against
    the plain version on the same card (both f32, rounded op by op in the
    same order)."""
    g = torch.Generator(device=card).manual_seed(1)
    xs = [
        torch.randn(3, 5_001, device=card, generator=g) * 2 + 1,
        torch.randn(2, 7, device=card, generator=g),
        torch.randn(1, 4_096, device=card, generator=g) * 0.01,
    ]
    xs[0][1, 2_000] = 50.0  # an outlier
    fss = [1024 / 30, 256 / 30, 34.0]
    before = ema_norm.LAUNCHES
    got = ema_norm.ema_normalize(xs, fss, baseline_tau_seconds=120.0)
    assert ema_norm.LAUNCHES == before + 1
    want = ema_norm.ema_normalize_reference(xs, fss, baseline_tau_seconds=120.0)
    for a, e in zip(got, want):
        assert a.shape == e.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, e, rtol=0, atol=1e-4)


def test_k3_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match='one device'):
        ema_norm.ema_normalize([torch.zeros(2, 10, device=card), torch.zeros(2, 10)], [34.0, 34.0])
    with pytest.raises(ValueError, match='float32'):
        ema_norm.ema_normalize([torch.zeros(2, 10, device=card, dtype=torch.bfloat16)], [34.0])
