"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card: K1 and K2 (``ops/conv_k3.py``), K3 (``ops/ema_norm.py``) and
the five profiling variants (``ops/conv_variants.py``).

Every case is marked ``cuda`` and skips without a card. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from wav2sleep_tpu_torch.models import layers
from wav2sleep_tpu_torch.ops import block_domain as bd
from wav2sleep_tpu_torch.ops import conv_k3 as k1
from wav2sleep_tpu_torch.ops import conv_variants as cv
from wav2sleep_tpu_torch.ops import ema_norm

pytestmark = pytest.mark.cuda

# Output times per tile of the bf16 kernel with C_in = C_out, by (C_out,
# stride): ``w2s_conv_k3_tile``, checked by ``test_bf16_tiles``.
BF16_TILE = {(16, 1): 512, (16, 2): 256, (32, 1): 256, (32, 2): 128,
             (64, 1): 128, (64, 2): 128, (128, 1): 64, (128, 2): 64}
# The same for the f32 kernel (any C_in), checked by ``test_f32_tiles``.
F32_TILE = {(16, 1): 512, (16, 2): 512, (32, 1): 512, (32, 2): 512,
            (64, 1): 256, (64, 2): 256, (128, 1): 128, (128, 2): 128}

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
] + [
    # The same at the f32 tiles, and with C_in = 12 (a ragged second
    # 8-channel chunk) and one batch row.
    (2, stride * (tile + d), co, co, stride)
    for (co, stride), tile in F32_TILE.items()
    for d in (-1, 0, 1)
] + [(1, stride * (tile + 1), 12, co, stride) for (co, stride), tile in F32_TILE.items()]


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


def test_f32_tiles(card):
    lib = k1.build()
    for ci in (8, 12, 128):
        assert {key: lib.w2s_conv_k3_tile(key[0], ci, key[1], 0) for key in F32_TILE} == F32_TILE


def test_f32_misaligned_input(card):
    """An f32 x that is not 16-byte aligned agrees as an aligned one does
    (the f32 kernel stages x by 4-byte copies)."""
    B, T, ci, co = 2, 1_000, 24, 64
    x, w, b, mu, inv = _inputs(B, T, ci, co, card, seed=12)
    flat = torch.empty(B * T * ci + 1, device=card)
    shifted = flat[1:].view(B, T, ci)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for args in ((b, None, None, 2, None), (b, mu, inv, 1, 'gelu')):
        torch.testing.assert_close(k1.conv_k3(shifted, w, *args), k1.conv_k3(x, w, *args), rtol=0, atol=0)
        torch.testing.assert_close(k1.conv_k3(shifted, w, *args), k1.conv_k3_reference(x, w, *args),
                                   rtol=1e-4, atol=1e-4)
        for a, e in zip(k1.conv_k3_stats(shifted, w, *args, 1e-2), k1.conv_k3_stats(x, w, *args, 1e-2)):
            torch.testing.assert_close(a, e, rtol=0, atol=0)


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


@pytest.mark.parametrize('thr', [2.5, 3.0, 5.0])
def test_k3_matches_plain_at_other_outlier_thresholds(card, thr):
    """K3 away from the default threshold 4: its sqrt-free chain compares
    d**2 with thr**2 m, bit for bit the clipped form only where thr**2 is a
    power of two. The clip, floor and length rows in one launch, atol 1e-4
    against the plain version on the card, as at thr 4."""
    xs, fss = _k3_rows(card)
    before = ema_norm.LAUNCHES
    got = ema_norm.ema_normalize(xs, fss, baseline_tau_seconds=120.0, outlier_threshold_sigma=thr)
    assert ema_norm.LAUNCHES == before + 1
    want = ema_norm.ema_normalize_reference(xs, fss, baseline_tau_seconds=120.0, outlier_threshold_sigma=thr)
    for a, e in zip(got, want):
        assert a.shape == e.shape and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, e, rtol=0, atol=1e-4)


def _k3_rows(device):
    """The rows of tests/test_torch_ema.py's clip, floor and length cases, one group each, made
    the same way: a spike of 25 every 250-400 samples (the clip binds),
    variance under min_sigma**2 (the floor binds), and lengths around the
    kernel's 32-sample chunks and its ring of 4 chunks ahead."""
    rng = np.random.default_rng(6)
    clip = rng.normal(size=(2, 12_000)).astype(np.float32)
    for row in clip:
        row[np.cumsum(rng.integers(250, 400, size=30))] = 25.0
    rng = np.random.default_rng(7)
    floor = np.stack([rng.normal(size=3_000) * 0.01 + 3.0, np.full(3_000, -2.0)]).astype(np.float32)
    groups = [(clip, 1024 / 30), (floor, 256 / 30)]
    for T in (1, 31, 32, 33, 2_049, 159, 160, 161, 32 * 9 + 5):
        groups.append((np.random.default_rng(T).normal(size=(3, T)).astype(np.float32) * 2 + 1, 34.13))
    return [torch.from_numpy(x).to(device) for x, _ in groups], [fs for _, fs in groups]


def test_k3_matches_plain_where_the_clip_and_the_floor_bind(card):
    """All the groups in one launch, against the plain version on the card
    (atol 1e-4; both round op by op in one order)."""
    xs, fss = _k3_rows(card)
    before = ema_norm.LAUNCHES
    got = ema_norm.ema_normalize(xs, fss, baseline_tau_seconds=120.0)
    assert ema_norm.LAUNCHES == before + 1
    want = ema_norm.ema_normalize_reference(xs, fss, baseline_tau_seconds=120.0)
    for a, e in zip(got, want):
        assert a.shape == e.shape and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, e, rtol=0, atol=1e-4)


def test_k3_causal_prefix(card):
    """A row's first samples through the kernel alone equal the kernel's
    output for them inside the whole row (same warm-up window), as
    chip_smoke.py's prefix check assumes; several modalities in one launch."""
    g = torch.Generator(device=card).manual_seed(5)
    fss = [1024 / 30, 256 / 30]
    xs = [torch.randn(2, 200_000, device=card, generator=g), torch.randn(3, 120_000, device=card, generator=g) * 3]
    args = dict(tau_seconds=900.0, baseline_tau_seconds=120.0)
    heads = [x[:, :45_000].contiguous() for x in xs]
    for x, h, fs in zip(xs, heads, fss):
        assert ema_norm.warmup_length(x.shape[1], fs, **args) == ema_norm.warmup_length(h.shape[1], fs, **args)
    full = ema_norm.ema_normalize(xs, fss, **args)
    head = ema_norm.ema_normalize(heads, fss, **args)
    for a, z in zip(head, full):
        torch.testing.assert_close(a, z[:, :45_000], rtol=0, atol=0)
    for a, e in zip(head, ema_norm.ema_normalize_reference(heads, fss, **args)):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-4)


def test_k3_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match='one device'):
        ema_norm.ema_normalize([torch.zeros(2, 10, device=card), torch.zeros(2, 10)], [34.0, 34.0])
    with pytest.raises(ValueError, match='float32'):
        ema_norm.ema_normalize([torch.zeros(2, 10, device=card, dtype=torch.bfloat16)], [34.0])


@pytest.fixture
def card_default_flags():
    """The card with torch's default TF32 flags (cuDNN convs in TF32,
    matmuls in f32), whatever earlier cases set; restored after."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield torch.device('cuda')
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _q16_logits(folder, device, hours, rows, meta):
    """f32 logits of the q16 entry point (load_model + the pipeline's launch
    of one batch) for the given codes."""
    from wav2sleep_tpu_torch import api, pipeline

    model = api.load_model(folder, precision='float32', device=device)
    pipe = pipeline.StreamingPipelineQ16(model, list(rows), batch_size=2, max_length_hours=hours,
                                         precision='float32', device=device)
    pipe.forward = pipeline.make_streaming_forward_q16(pipe.model, 'float32', output='logits')
    slot = pipe._slots[0]
    for c in rows:
        slot.rows_np[c][:] = rows[c]
        slot.meta[c][:] = meta[c]
    return pipe._launch(slot).cpu()


def test_f32_serving_is_f32_under_torchs_default_flags(card_default_flags, tmp_path, monkeypatch):
    """The flagship's f32 q16 logits on the card, through load_model and the
    pipeline under torch's default flags, are within 5e-4 (atol and rtol)
    of the plain CPU forward on the same codes. Also prints the max |d|
    with the forward's TF32 switch taken out, the fault it repairs."""
    from wav2sleep_tpu_torch import checkpoint, pipeline
    from wav2sleep_tpu_torch.instantiate import target_config
    from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config

    cfg = flagship_config()
    folder = str(tmp_path / 'ckpt')
    checkpoint.save_checkpoint_folder(folder, target_config(**cfg), build_wav2sleep(**cfg).state_dict())
    hours = 1.0
    rng = np.random.default_rng(12)
    rows, meta = {}, {}
    for c in cfg['signal_map']:
        n = pipeline.grid_length(c, hours)
        rows[c] = (np.sin(np.arange(n) / rng.uniform(3, 40)) * 3000 + rng.normal(size=(2, n)) * 300).astype(np.int16)
        m = np.zeros(2, pipeline.Q16_META_DTYPE)
        m['a'], m['b'], m['n_valid'], m['n_pad'], m['present'] = 1e-3, 0.1, n, n, True
        meta[c] = m
    meta['PPG']['present'][1] = False  # an absent modality
    want = _q16_logits(folder, 'cpu', hours, rows, meta)
    got = _q16_logits(folder, card_default_flags, hours, rows, meta)
    with monkeypatch.context() as m:
        m.setattr(pipeline, 'full_f32', contextlib.nullcontext)
        unrepaired = _q16_logits(folder, card_default_flags, hours, rows, meta)
    assert torch.backends.cudnn.allow_tf32  # the forward restored torch's default
    print(f'f32 q16 logits, card vs CPU under torch\'s default flags: max|d| {float((got - want).abs().max()):.3e} '
          f'(without the forward\'s TF32 switch: {float((unrepaired - want).abs().max()):.3e}) on '
          f'{torch.cuda.get_device_name(0)}')
    assert got.shape == (2, 120, 4) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)


def test_f32_api_predict_is_f32_under_torchs_default_flags(card_default_flags, tmp_path):
    """The inference API in f32 on the card under torch's default flags:
    ``W2SModel.logits`` of the flagship (through K1) on the padded batch
    ``predict`` forms from two one-hour parquet nights (one without PPG) is
    within 5e-4 (atol and rtol) of the CPU's, and ``predict``'s classes are
    the CPU's off near-ties."""
    from wav2sleep_tpu_torch import api, checkpoint
    from wav2sleep_tpu_torch.data import parquet
    from wav2sleep_tpu_torch.data.dataset import collate, pad_or_truncate_item
    from wav2sleep_tpu_torch.instantiate import target_config
    from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config
    from wav2sleep_tpu_torch.settings import COLS_TO_SAMPLES_PER_EPOCH

    cfg = flagship_config()
    folder = str(tmp_path / 'ckpt')
    checkpoint.save_checkpoint_folder(folder, target_config(**cfg), build_wav2sleep(**cfg).state_dict())
    rng = np.random.default_rng(21)
    nights = tmp_path / 'nights'
    nights.mkdir()
    for i in range(2):
        cols = {c: (rng.normal(size=120 * spe) + np.sin(np.arange(120 * spe) / (7 + i))).astype(np.float32)
                for c, spe in COLS_TO_SAMPLES_PER_EPOCH.items() if c in cfg['signal_map'] and (i, c) != (1, 'PPG')}
        parquet.write_night(str(nights / f'n{i}.parquet'), cols)
    signals = list(cfg['signal_map'])
    ds = api.load_dataset(str(nights), signals, max_length_hours=1)
    x, _ = collate([pad_or_truncate_item(ds[i], 120) for i in range(2)])
    cpu = api.W2SModel.load(folder, device='cpu')
    gpu = api.W2SModel.load(folder, device=card_default_flags)
    before = k1.LAUNCHES
    got = gpu.logits(x)
    assert k1.LAUNCHES > before and torch.backends.cudnn.allow_tf32  # K1 ran; the flags are restored
    want = cpu.logits(x)
    print(f'f32 API logits, card vs CPU under torch\'s default flags: max|d| {np.abs(got - want).max():.3e} on '
          f'{torch.cuda.get_device_name(0)}')
    assert got.shape == (2, 120, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    preds, labels = api.predict(gpu, ds, device=card_default_flags, batch_size=2)
    assert labels is None and [len(p) for p in preds] == [120, 120]
    for i in range(2):
        np.testing.assert_array_equal(preds[i][clear[i]], want[i].argmax(-1)[clear[i]])
    # predict moves a handle loaded elsewhere in place: the caller's handle
    # then follows its weights to the card, and back.
    moved = api.W2SModel.load(folder, device='cpu')
    api.predict(moved, ds, device=card_default_flags, batch_size=2)
    assert moved.device.type == 'cuda' and next(moved.module.parameters()).is_cuda
    np.testing.assert_allclose(moved.logits(x), want, atol=5e-4, rtol=5e-4)
    api.predict(moved, ds, device='cpu', batch_size=2)
    assert moved.device.type == 'cpu'
    np.testing.assert_array_equal(moved.logits(x), want)


@pytest.mark.parametrize('kind', ['q16', 'q4', 'raw'])
def test_transport_forwards_match_the_cpu(card, kind):
    """Each new transport's device half (affine, q4's nibble unpack and
    cumsum, raw's gather at the anchors) on the card against the same
    forward on the CPU, f32 logits within 5e-4, with a narrow model."""
    from wav2sleep_tpu_torch import pipeline
    from wav2sleep_tpu_torch.models.wav2sleep import flagship_model
    from wav2sleep_tpu_torch.settings import COLS_TO_SAMPLES_PER_EPOCH

    hours, B = 0.25, 2
    rng = np.random.default_rng(13)
    signals = ('ECG', 'THX')
    n_grid = {c: pipeline.grid_length(c, hours) for c in signals}
    if kind == 'q4':
        rows = {c: rng.integers(0, 256, size=(B, pipeline.q4_row_len(n)), dtype=np.uint8) for c, n in n_grid.items()}
        for c, n in n_grid.items():  # scale exponents: steps of 2**(e/16), e < 96
            rows[c][:, (n + 1) // 2:] %= 96
        names = pipeline.Q8_META_DTYPE.names
    elif kind == 'raw':
        fs = {'ECG': 125.0, 'THX': 10.0}
        rows = {c: (rng.normal(size=(B, 131072)) * 2000).astype(np.int16) for c in signals}
    else:
        rows = {c: (rng.normal(size=(B, n)) * 2000).astype(np.int16) for c, n in n_grid.items()}
        names = pipeline.Q16_META_DTYPE.names

    def logits(device):
        model = flagship_model(max_channels=32, feature_dim=32, device=device, generator=torch.Generator().manual_seed(4))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        vec = lambda v, dtype=np.float32: {c: t(np.full(B, v, dtype)) for c in signals}  # noqa: E731
        n_pad = {c: t(np.array([n_grid[c], n_grid[c] // 2], np.int32)) for c in signals}
        present = {c: t(np.array([True, c != 'THX'])) for c in signals}
        q = {c: t(r) for c, r in rows.items()}
        if kind == 'raw':
            anchors = [pipeline.compute_resample_anchors(fs[c], 30.0 / COLS_TO_SAMPLES_PER_EPOCH[c], n_grid[c])
                       for c in signals]
            base_int = {c: t(np.stack([a[0]] * B)) for c, a in zip(signals, anchors)}
            base_frac = {c: t(np.stack([a[1]] * B)) for c, a in zip(signals, anchors)}
            ratio = {c: t(np.full(B, a[2], np.float32)) for c, a in zip(signals, anchors)}
            n = {c: t(np.array([int(fs[c] * hours * 3600), 50_000], np.int32)) for c in signals}
            fwd = pipeline.make_streaming_forward_raw(model, n_grid, 'float32', output='logits')
            return fwd(q, vec(1e-3), vec(0.2), base_int, base_frac, ratio, n, n_pad, present).cpu()
        fields = {'a': vec(1e-3), 'b': vec(0.2), 'vmax': vec(2000.0), 'n_valid': vec(n_grid['THX'], np.int32),
                  'n_pad': n_pad, 'present': present}
        make = (pipeline.make_streaming_forward_q16 if kind == 'q16' else
                lambda m, p, output: pipeline.make_streaming_forward_q4(m, n_grid, p, output))
        return make(model, 'float32', output='logits')(q, *(fields[f] for f in names)).cpu()

    want, got = logits('cpu'), logits(card)
    assert got.shape == (B, 30, 4) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)


# (B, tb, nT) for the profiling variants: the function's tiles of 8, 16, 24
# and 2048 rows, nb = tb nT not a multiple of the kernels' 64-row items and
# tiles wherever tb allows it (V2 and V3 then zero-fill the last tile's
# missing rows on the way in and clip them on the way out), one batch row,
# and one case of thousands of items (several per persistent block, through
# the ring). Then for V2 and V3, which tile the flat [B nb, 128] rows: fewer
# rows than one tile; tiles that span two batch rows; and 10,240 tiles,
# ~78 per block, each block's two consumers going round their ring 10 (V2)
# to 13 (V3) times. Then for V4, whose tiles write 62 rows and read one more
# on each side: tile edges inside the function's tiles of 128 rows; nb a
# multiple of neither 64 nor 62 (also a copy of 6.6 of V0's 32 KB chunks);
# and tb 8, an edge on every eighth row, over 1,033 tiles, more than two per
# warpgroup of every block. Then for V7, whose tiles are cut from each
# function tile (64 rows, and a partial last tile of tb % 64 rows): function
# tiles of one full tile and a partial one of 8 (tb 72) and of 3 full tiles
# and a partial one of 8 (tb 200).
VARIANT_CASES = [(1, 8, 13), (2, 8, 13), (1, 16, 7), (2, 16, 5), (1, 24, 5), (2, 24, 11), (1, 2048, 3),
                 (2, 2048, 2), (4, 24, 2000), (1, 8, 1), (3, 8, 5), (8, 2048, 40), (1, 128, 4), (3, 40, 7),
                 (4, 8, 2000), (2, 72, 9), (1, 200, 5)]


def _variant_inputs(B, tb, n_t, device, seed, w_scale=0.1):
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device, torch.bfloat16)  # noqa: E731
    return (bf(rng.normal(size=(B, tb * n_t, 128))), bf(rng.normal(size=(3, 128, 128)) * w_scale),
            bf(rng.normal(size=(B, n_t * 8, 128))), bf(rng.normal(size=(B, n_t * 8, 128))))


def _variant_args(name, x, w, xp, xn):
    return {'copy': (x,), 'mm1f': (x, w[0]), 'mm3': (x, w), 'mm3s': (x, w), 'v7': (x, xp, xn, w)}[name]


@pytest.mark.parametrize('name', cv.NAMES)
@pytest.mark.parametrize('B,tb,n_t', VARIANT_CASES)
def test_variant_matches_plain(card, name, B, tb, n_t):
    """V0 bit for bit; the others within 2**-6 of |plain| + rms(plain), as
    bf16 K1 (both round exact-product f32 sums to bf16 once). V7's halos are
    random."""
    _check_variant(card, name, B, tb, n_t)


@pytest.mark.parametrize('name', cv.NAMES)
def test_variant_matches_plain_at_large_values(card, name):
    """W of unit scale, not 0.1: |y| ~ 11 (V2) to ~20 (V3), so that a wrong
    swizzle, descriptor or fragment position cannot hide under small values."""
    _check_variant(card, name, 2, 24, 11, w_scale=1.0)


def _check_variant(card, name, B, tb, n_t, w_scale=0.1):
    args = _variant_args(name, *_variant_inputs(B, tb, n_t, card, seed=B * tb + n_t, w_scale=w_scale))
    before = cv.LAUNCHES[name]
    got = getattr(cv, name)(*args, tb)
    assert cv.LAUNCHES[name] == before + 1
    want = getattr(cv, f'{name}_reference')(*args, tb)
    assert got.shape == want.shape == (B, tb * n_t, 128) and got.dtype == torch.bfloat16 and got.is_contiguous()
    if name == 'copy':
        assert torch.equal(got, want)
    else:
        ok, err = cv.agree(got, want, 2**-6)
        assert ok, err


@pytest.mark.parametrize('B,tb,n_t', [(1, 8, 13), (2, 24, 11), (2, 2048, 2), (4, 24, 2000), (2, 72, 9),
                                     (8, 2048, 40)])
def test_v7_with_true_halos_is_k1(card, B, tb, n_t):
    x, w, _, _ = _variant_inputs(B, tb, n_t, card, seed=tb + n_t)
    xp, xn = cv.true_halos(x, tb)
    ok, err = cv.agree(cv.v7(x, xp, xn, w, tb), k1.conv_k3(x, w), 2**-6)
    assert ok, err


def test_v7_stays_right_through_back_to_back_calls(card):
    """8,000 V7 calls in a row at the ladder's shape (x [8, 153,600, 128],
    tb 2048), as ``card_clock`` runs it: no fault, and the last output still
    matches the plain version. Under load a tile's load can land late, so a
    ring whose stages both consumer warpgroups take in turn lets a parity
    wait pass early."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((8, 153_600, 128), device=card, generator=gen).bfloat16()
    w = (torch.randn((3, 128, 128), device=card, generator=gen) * 0.1).bfloat16()
    xp, xn = cv.true_halos(x, 2048)
    want = cv.v7_reference(x, xp, xn, w, 2048)
    for _ in range(8000):
        got = cv.v7(x, xp, xn, w, 2048)
    torch.cuda.synchronize()
    ok, err = cv.agree(got, want, 2**-6)
    assert ok, err


def test_variants_refuse_what_they_do_not_take(card):
    x, w, xp, xn = _variant_inputs(1, 16, 4, card, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=card)
    shifted = flat[1:].view(x.shape)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for name in cv.NAMES:
        fn = getattr(cv, name)
        with pytest.raises(ValueError, match=r'\[B, nb, 128\]'):
            fn(*_variant_args(name, x[..., :64].contiguous(), w, xp, xn), 16)
        with pytest.raises(ValueError, match='multiple of tb'):
            fn(*_variant_args(name, x, w, xp, xn), 24)
        with pytest.raises(ValueError, match='multiple of 8'):
            fn(*_variant_args(name, x, w, xp, xn), 4)
        with pytest.raises(TypeError, match='dtype'):
            fn(*_variant_args(name, x.float(), w, xp, xn), 16)
        with pytest.raises(ValueError, match='16-byte aligned'):
            fn(*_variant_args(name, shifted, w, xp, xn), 16)
        if name != 'copy':
            with pytest.raises(ValueError, match='w is on cpu'):
                fn(*_variant_args(name, x, w.cpu(), xp, xn), 16)
            with pytest.raises(TypeError, match='w has dtype'):
                fn(*_variant_args(name, x, w.half(), xp, xn), 16)
    with pytest.raises(ValueError, match='xp has shape'):
        cv.v7(x, xp[:, :8].contiguous(), xn, w, 16)


# ---------------------------------------------------------------- training


TRAIN_LR = 1e-3
# As in tests/test_torch_train.py: an element whose Adam first moment the two
# devices put more than 10% apart has a gradient within their f32 noise, and
# Adam (eps 1e-8) moves it by up to lr whatever its size; such elements are
# held to Adam's reach after one step, 2 lr (plus rounding), and are at most
# 1% of all.
NOISY_MOMENT, NOISY_SHARE = 0.1, 0.01


def _train_setup(device, remat=True, dropout=0.0, masker=None, flip=False, compute_dtype=None):
    """A narrow flagship (feature_dim 32, channels 16-32: all 80 k3 convs
    on K1) with seeded weights, its state and its step (AdamW at lr 1e-3,
    optax's b1, b2 and eps)."""
    from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config
    from wav2sleep_tpu_torch.train import step as tstep

    cfg = flagship_config(32, 32)
    cfg['encoders']['remat'] = remat
    cfg['epoch_mixer']['dropout'] = cfg['sequence_mixer']['dropout'] = dropout
    model = build_wav2sleep(**cfg, generator=torch.Generator().manual_seed(0)).to(device)
    opt = tstep.make_optimizer(TRAIN_LR)
    state = tstep.init_train_state(model, opt, ema=True)
    step = tstep.make_train_step(model, opt, 4, masker=masker, flip_polarity=flip, ema_decay=0.99,
                                 compute_dtype=compute_dtype)
    return state, step


def _train_batch(device, B=2, S=2, seed=0):
    from wav2sleep_tpu_torch import train_bench

    x, y = train_bench.example_batch(B, S, seed)
    x['PPG'][1] = -np.inf
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}, torch.from_numpy(y).to(device)


def test_f32_train_step_is_f32_under_torchs_default_flags(card_default_flags, monkeypatch):
    """ROADMAP §C.5: one f32 step on the card, kernels and remat on, under
    torch's default flags, against the same step on the CPU (plain
    versions): loss, gradient norm and the updated parameters."""
    from wav2sleep_tpu_torch.train import step as tstep

    out = {}
    for name, device in (('cpu', 'cpu'), ('card', card_default_flags), ('card without the switch', card_default_flags)):
        with monkeypatch.context() as m:
            if name == 'card without the switch':
                m.setattr(tstep, 'full_f32', contextlib.nullcontext)
            state, step = _train_setup(device)
            _, metrics = step(state, _train_batch(device), 0)
            out[name] = (float(metrics['loss']), float(metrics['grad_norm']),
                         {k: p.detach().cpu() for k, p in state.params.items()},
                         {k: m.cpu() for k, m in zip(state.params, state.opt_state.mu)})
    assert torch.backends.cudnn.allow_tf32  # the step restored torch's default
    (l0, g0, p0, m0), (l1, g1, p1, m1), (l2, g2, _, _) = out.values()
    noisy = {k: (m1[k] - m0[k]).abs() > NOISY_MOMENT * m0[k].abs() for k in m0}
    n, total = sum(int(v.sum()) for v in noisy.values()), sum(v.numel() for v in noisy.values())
    d_params = max(float(torch.where(noisy[k], 0.0, p1[k] - p0[k]).abs().max()) for k in p0)
    d_noisy = max(float(torch.where(noisy[k], p1[k] - p0[k], 0.0).abs().max()) for k in p0)
    print(f'f32 train step, card vs CPU under torch\'s default flags: loss {abs(l1 - l0):.3e}, grad norm '
          f'{abs(g1 - g0):.3e}, params {d_params:.3e} outside the {n} of {total} elements whose Adam moment the '
          f'devices put over {NOISY_MOMENT:g} apart, {d_noisy:.3e} inside them (without the step\'s TF32 switch: '
          f'loss {abs(l2 - l0):.3e}, grad norm {abs(g2 - g0):.3e}) on {torch.cuda.get_device_name(0)}')
    assert abs(l1 - l0) <= 5e-4 * (1 + abs(l0)) and abs(g1 - g0) <= 5e-4 * (1 + abs(g0))
    for k in p0:
        torch.testing.assert_close(torch.where(noisy[k], p0[k], p1[k]), p0[k], atol=5e-4, rtol=5e-4)
    assert d_noisy <= 2.01 * TRAIN_LR and n <= NOISY_SHARE * total


@contextlib.contextmanager
def _kernel_stats(on):
    bd.KERNEL_STATS = on
    try:
        yield
    finally:
        bd.KERNEL_STATS = None


@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16])
def test_train_step_launches_k1_twice_per_conv_with_remat(card, compute_dtype):
    """A forward launches K1 80 times; a step with remat 160 (the forward
    and the recompute), without remat 80; with kernel statistics K2 160."""
    batch = _train_batch(card)
    seen = {}
    for remat, stats in ((True, False), (False, False), (True, True)):
        with _kernel_stats(stats):
            state, step = _train_setup(card, remat=remat, compute_dtype=compute_dtype)
            k1.LAUNCHES = k1.STATS_LAUNCHES = 0
            _, m = step(state, batch, 0)
            torch.cuda.synchronize()
        seen[remat, stats] = (k1.LAUNCHES, k1.STATS_LAUNCHES)
        assert bool(torch.isfinite(m['loss'])) and bool(torch.isfinite(m['grad_norm']))
    assert seen == {(True, False): (160, 0), (False, False): (80, 0), (True, True): (0, 160)}


def test_train_step_is_seeded_on_the_card(card):
    """Dropout, flip and masker on: one seed gives one loss twice, another
    seed another; the card's global RNG stream is left as it was."""
    from wav2sleep_tpu_torch import train_bench
    from wav2sleep_tpu_torch.train.masker import SignalMasker

    batch = _train_batch(card, B=4)
    losses = []
    for seed in (3, 3, 4):
        masker = SignalMasker(train_bench.DROPOUTS, train_bench.BACKUPS)
        state, step = _train_setup(card, dropout=0.1, masker=masker, flip=True)
        before = torch.cuda.get_rng_state()
        losses.append(float(step(state, batch, seed)[1]['loss']))
        assert torch.equal(torch.cuda.get_rng_state(), before)
    assert losses[0] == losses[1] != losses[2]


def test_train_bench_runs_on_the_card_by_default(card, capsys):
    from wav2sleep_tpu_torch import train_bench

    train_bench.main(['--batch', '1', '--epochs-per-night', '2', '--feature-dim', '16', '--k', '2', '--reps', '1'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['device'] == torch.cuda.get_device_name(0) and line['card']
    assert line['k1_launches_per_step'] == 160 and line['peak_gib'] > 0 and np.isfinite(line['loss'])


# ---------------------------------------------------------------- model families


def _family_model(kind):
    """A narrow wav2sleep of the families slice (ECG + THX, feature_dim 16,
    channels 8-16) with seeded weights and seeded running statistics:
    batch norm in the encoders and the sequence mixer, or causal encoders
    and mixer."""
    from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep

    causal = kind == 'causal'
    norm = 'batch' if kind == 'batch_norm' else 'instance'
    model = build_wav2sleep(
        4, {'ECG': 'ECG', 'THX': 'THX'},
        encoders=dict(feature_dim=16, activation='gelu', norm=norm, causal=causal, chunk_causal=False,
                      initial_channels=8, max_channels=16),
        epoch_mixer=dict(feature_dim=16, layers=1, dim_ff=32, nhead=4, dropout=0.0),
        sequence_mixer=dict(feature_dim=16, num_layers=1, kernel_size=3, num_dilations=2, dropout=0.0,
                            norm='batch' if kind == 'batch_norm' else 'layer', causal=causal),
        generator=torch.Generator().manual_seed(0),
    )
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith('running_var'):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model.eval()


@pytest.mark.parametrize('kind', ['batch_norm', 'causal'])
def test_family_forwards_match_the_cpu(card, kind):
    """A batch-norm and a causal narrow wav2sleep, f32 on the card (TF32
    off) against the CPU within 5e-4 (atol and rtol); neither launches K1,
    as the JAX package keeps its Pallas conv off both."""
    rng = np.random.default_rng(7)
    x = {c: rng.normal(size=(2, n * 8)).astype(np.float32) for c, n in (('ECG', 1024), ('THX', 256))}
    x['THX'][1] = -np.inf
    model = _family_model(kind)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in x.items()})
        model.to(card)
        k1.LAUNCHES = k1.STATS_LAUNCHES = 0
        got = model({k: torch.from_numpy(v).to(card) for k, v in x.items()}).cpu()
    print(f'{kind} f32 forward, card vs CPU: max|d| {float((got - want).abs().max()):.3e} on '
          f'{torch.cuda.get_device_name(0)}')
    assert (k1.LAUNCHES, k1.STATS_LAUNCHES) == (0, 0)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)


def test_f32_ppgnet_step_matches_the_cpu_under_torchs_default_flags(card_default_flags):
    """One f32 SleepPPG-Net step (feature_dim 32, B=1, a ten-hour night,
    dropout 0, flip off) on the card under torch's default flags against
    the CPU, with the gates of the CPU's SleepPPG-Net step test
    (tests/test_torch_train_families.py): loss within 5e-4 (1 + |loss|),
    gradient norm within 1e-3 relative, running statistics within 1e-4 of
    their value or of their buffer's largest |value|, parameters within
    5e-4 outside the elements whose Adam moments the devices put over 10%
    apart, those (at most 20%) within Adam's reach 2 lr."""
    from wav2sleep_tpu_torch.models.ppgnet import SleepPPGNet, build_ppgnet
    from wav2sleep_tpu_torch.train import step as tstep

    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, SleepPPGNet.INPUT_LENGTH)).astype(np.float32)
    y = rng.integers(-1, 4, size=(1, 1200)).astype(np.float32)
    out = {}
    for name, device in (('cpu', torch.device('cpu')), ('card', card_default_flags)):
        model = build_ppgnet(torch.Generator().manual_seed(0), feature_dim=32, dropout=0.0).to(device)
        opt = tstep.make_optimizer(TRAIN_LR)
        state = tstep.init_train_state(model, opt)
        step = tstep.make_train_step(model, opt, 4, flip_polarity=False, family='ppgnet')
        _, metrics = step(state, ({'PPG': torch.from_numpy(x).to(device)}, torch.from_numpy(y).to(device)), 0)
        out[name] = (float(metrics['loss']), float(metrics['grad_norm']),
                     {k: p.detach().cpu() for k, p in state.params.items()},
                     {k: m.cpu() for k, m in zip(state.params, state.opt_state.mu)},
                     {k: v.cpu() for k, v in state.batch_stats.items()})
    assert torch.backends.cudnn.allow_tf32  # the step restored torch's default
    (l0, g0, p0, m0, s0), (l1, g1, p1, m1, s1) = out.values()
    noisy = {k: (m1[k] - m0[k]).abs() > NOISY_MOMENT * m0[k].abs() for k in m0}
    n, total = sum(int(v.sum()) for v in noisy.values()), sum(v.numel() for v in noisy.values())
    d_params = max(float(torch.where(noisy[k], 0.0, p1[k] - p0[k]).abs().max()) for k in p0)
    d_noisy = max(float(torch.where(noisy[k], p1[k] - p0[k], 0.0).abs().max()) for k in p0)
    print(f'f32 SleepPPG-Net step, card vs CPU under torch\'s default flags: loss {abs(l1 - l0):.3e}, grad norm '
          f'{abs(g1 - g0) / g0:.3e} relative, params {d_params:.3e} outside the {n} of {total} noisy elements, '
          f'{d_noisy:.3e} inside, on {torch.cuda.get_device_name(0)}')
    assert abs(l1 - l0) <= 5e-4 * (1 + abs(l0)) and abs(g1 - g0) <= 1e-3 * abs(g0)
    for k, v in s0.items():
        if k.endswith('num_batches_tracked'):
            assert int(s1[k]) == int(v) == 1
        else:
            torch.testing.assert_close(s1[k], v, rtol=1e-4, atol=1e-4 * float(v.abs().max()))
    assert d_params <= 5e-4 and d_noisy <= 2.01 * TRAIN_LR and n <= 0.2 * total


# ---------------------------------------------------------------- the trainer


FIT_EPOCHS_PER_NIGHT = 6


def _write_fit_corpus(root):
    """mesa and shhs, 4 nights a split, 6 epochs a night, the four signals
    with a stage-dependent amplitude (data.parquet.write_night)."""
    from wav2sleep_tpu_torch.data.parquet import write_night

    rng = np.random.default_rng(0)
    spe = {'ECG': 1024, 'PPG': 1024, 'ABD': 256, 'THX': 256}
    for ds in ('mesa', 'shhs'):
        for split in ('train', 'val', 'test'):
            os.makedirs(os.path.join(root, ds, split))
            for n in range(4):
                labels = rng.integers(0, 4, size=FIT_EPOCHS_PER_NIGHT).astype(np.float32)
                cols = {k: (np.repeat(labels + 1.0, n_) * np.tile(np.sin(np.arange(n_) / 3.0), FIT_EPOCHS_PER_NIGHT)
                            + 0.05 * rng.normal(size=n_ * FIT_EPOCHS_PER_NIGHT)).astype(np.float32)
                        for k, n_ in spe.items()}
                write_night(os.path.join(root, ds, split, f'{ds}-{n}.parquet'), {**cols, 'Stage': labels})


def _fit_trainer(root, log_dir, model, device, **kw):
    from wav2sleep_tpu_torch.train.datamodule import SleepDataModule
    from wav2sleep_tpu_torch.train.loop import Trainer

    dm = SleepDataModule(columns=['ABD', 'THX', 'ECG', 'PPG'], data_location=str(root), train_datasets=['mesa', 'shhs'],
                         val_datasets=['mesa', 'shhs'], batch_size=4, val_batch_size=4, num_workers=1,
                         pad_to_epochs=FIT_EPOCHS_PER_NIGHT, max_length_hours=1, device=device)
    return Trainer(model=model, datamodule=dm, epochs=2, lr=3e-3, warmup_steps=5, tau=1000.0, flip_polarity=False,
                   log_dir=str(log_dir), seed=0, progress_bar=False, **kw)


def _narrow_fit_model():
    from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config

    cfg = flagship_config(16, 16)  # every k3 conv on K1
    cfg['epoch_mixer']['dropout'] = cfg['sequence_mixer']['dropout'] = 0.0
    return build_wav2sleep(**cfg, generator=torch.Generator().manual_seed(0))


def test_trainer_fit_on_the_card_matches_the_cpu(card_default_flags, tmp_path):
    """A narrow 2-epoch fit (2 steps an epoch, EMA on) on the card, K1 on
    the path, under torch's default flags, with the same trainer on the CPU
    following it: before each step and each evaluation the CPU trainer takes
    the card's state (checkpointing's state tree), then both take the step
    on the batch of their own loaders, which must be equal, or evaluate. Each step is held to the card step
    test's gates (loss and gradient norm within 5e-4 relative to 1 +
    |value|; parameters within 5e-4 outside the elements whose Adam first
    moments the devices put over 10% apart, those within 2.01 lr and at most
    1%), each evaluation's losses within 5e-4 relative. Free-running, the
    two fits part by more: Adam at eps 1e-8 moves an element whose
    gradient is within f32 noise by lr in that noise's sign, and the 4 steps
    compound it (ROADMAP §C.7)."""
    import copy

    from wav2sleep_tpu_torch.train.checkpointing import load_state_tree, state_tree

    root = tmp_path / 'corpus'
    _write_fit_corpus(str(root))
    model = _narrow_fit_model()
    card = _fit_trainer(root, tmp_path / 'card', copy.deepcopy(model), card_default_flags, ema_decay=0.9,
                        ema_start_step=0)
    cpu = _fit_trainer(root, tmp_path / 'cpu', copy.deepcopy(model), 'cpu', ema_decay=0.9, ema_start_step=0)
    card.ensure_state()
    cpu.ensure_state()
    steps, evals = [], []
    card_step, card_evaluate = card._train_step, card.evaluate
    # The CPU trainer's batches come from its own loader (the same seed and
    # epochs), so a fault in staging the card's batch shows as a mismatch.
    cpu_items = (item for epoch in range(2) for item in cpu.datamodule.train_loader(epoch))

    def both_step(state, batch, seed):
        load_state_tree(cpu.state, state_tree(state))
        lr = card.opt.lr(state.opt_state)
        cx, cy = cpu._stage_train(*next(cpu_items))
        x, y = batch
        assert set(x) == set(cx)
        for k, v in cx.items():
            torch.testing.assert_close(x[k].cpu(), v, rtol=0, atol=0)
        torch.testing.assert_close(y.cpu(), cy, rtol=0, atol=0)
        _, cm = cpu._train_step(cpu.state, (cx, cy), seed)
        state, m = card_step(state, batch, seed)
        mu0 = [t.clone() for t in cpu.state.opt_state.mu]
        mu1 = [t.to('cpu', copy=True) for t in state.opt_state.mu]
        noisy = [(b - a).abs() > NOISY_MOMENT * a.abs() for a, b in zip(mu0, mu1)]
        p0 = [p.detach().clone() for p in cpu.state.params.values()]
        p1 = [p.detach().to('cpu', copy=True) for p in state.params.values()]
        steps.append(dict(loss=(float(cm['loss']), float(m['loss'])), gn=(float(cm['grad_norm']), float(m['grad_norm'])),
                          lr=lr, p0=p0, p1=p1, noisy=noisy))
        return state, m

    def both_evaluate(mode='val', epoch=None):
        out = card_evaluate(mode, epoch)
        load_state_tree(cpu.state, state_tree(card.state))
        evals.append((cpu.evaluate(mode, epoch), out))
        return out

    card._train_step, card.evaluate = both_step, both_evaluate
    k1.LAUNCHES = 0
    card.fit()
    assert next(cpu_items, None) is None
    assert card.device.type == 'cuda' and k1.LAUNCHES >= 4 * 160  # K1 on every micro-step, forward and recompute
    assert len(steps) == 4 and len(evals) == 2
    worst = {'step': 0.0, 'eval': 0.0, 'params': 0.0, 'noisy': 0.0, 'share': 0.0}
    for s in steps:
        for a, b in (s['loss'], s['gn']):
            worst['step'] = max(worst['step'], abs(b - a) / (1 + abs(a)))
        n = sum(int(v.sum()) for v in s['noisy'])
        worst['share'] = max(worst['share'], n / sum(v.numel() for v in s['noisy']))
        for a, b, noisy in zip(s['p0'], s['p1'], s['noisy']):
            torch.testing.assert_close(torch.where(noisy, a, b), a, atol=5e-4, rtol=5e-4)
            worst['params'] = max(worst['params'], float(torch.where(noisy, 0.0, b - a).abs().max()))
            gap = float(torch.where(noisy, b - a, 0.0).abs().max())
            worst['noisy'] = max(worst['noisy'], gap)
            assert gap <= 2.01 * s['lr']
    for theirs, ours in evals:
        assert set(theirs) == set(ours) and len(ours) == 1 + 2 + 6
        for k, v in theirs.items():
            worst['eval'] = max(worst['eval'], abs(ours[k] - v) / (1 + abs(v)))
    print(f'trainer fit, card vs CPU from the card\'s state each step: {worst} on {torch.cuda.get_device_name(0)}')
    assert worst['step'] <= 5e-4 and worst['eval'] <= 5e-4 and worst['share'] <= NOISY_SHARE


def test_staging_ring_waits_before_reusing_a_slot(card):
    """A slot's copy queued behind a busy stream: claiming the slot again
    waits for it, so writing the slot afterwards cannot reach the copy."""
    from wav2sleep_tpu_torch.train.loop import StagingRing

    ring = StagingRing(2, card)
    j = ring.claim()
    buf = ring.buffer(j, 'x', torch.float32, (1 << 22,))
    buf.fill_(1.0)
    torch.cuda._sleep(200_000_000)  # holds the stream ~0.1 s
    dev = ring.ship(j, {'x': buf})['x']
    assert ring.claim() != j
    assert ring.claim() == j  # waits for the first copy
    buf.fill_(2.0)
    assert bool((dev == 1.0).all())
    assert ring.buffer(j, 'x', torch.float32, (1 << 22,)) is buf  # made once, reused


def test_trainer_staging_under_back_to_back_steps(card, tmp_path):
    """The card trainer's own parquet batches, both epochs' (16 nights of
    one row), staged back to back through a ring of 2 while the stream is
    held: every batch reaches the card as the CPU data module's loader gives
    it on the host, in bf16, q8 and lossless."""
    from wav2sleep_tpu_torch.ops import q8_transport as q8

    root = tmp_path / 'corpus'
    _write_fit_corpus(str(root))
    host = _fit_trainer(root, tmp_path / 'host', _narrow_fit_model(), 'cpu').datamodule
    host.batch_size = 1
    batches = [item for epoch in (0, 1) for item in host.train_loader(epoch)]
    assert len(batches) == 16
    for kw in (dict(precision='bfloat16'), dict(input_transport='q8'), {}):
        trainer = _fit_trainer(root, tmp_path / 'run', _narrow_fit_model(), None, stage_ring=2, **kw)
        assert trainer.device.type == 'cuda'
        trainer.datamodule.batch_size = 1
        torch.cuda._sleep(200_000_000)
        staged = [trainer._stage_train(x, y) for epoch in (0, 1) for x, y in trainer.datamodule.train_loader(epoch)]
        assert len(staged) == len(batches)
        for (x, y), (xd, yd) in zip(batches, staged):
            np.testing.assert_array_equal(yd.cpu().numpy(), y)
            for k, v in x.items():
                if 'input_transport' in kw:
                    want = q8.encode_batch({k: v})[k]
                    for a, b in zip(xd[k], want):
                        np.testing.assert_array_equal(a.cpu().numpy(), b)
                else:
                    dtype = torch.bfloat16 if kw else torch.float32
                    torch.testing.assert_close(xd[k].cpu(), torch.from_numpy(v).to(dtype), rtol=0, atol=0)


def test_trainer_datamodule_and_tuning_run_on_the_card_by_default(card, tmp_path):
    from wav2sleep_tpu_torch.train.tuning import tune_batch_size

    root = tmp_path / 'corpus'
    _write_fit_corpus(str(root))
    trainer = _fit_trainer(root, tmp_path / 'run', _narrow_fit_model(), None)
    assert trainer.datamodule.device.type == 'cuda' and trainer.device.type == 'cuda'
    assert next(trainer.model.parameters()).device.type == 'cuda'
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    assert tune_batch_size(_narrow_fit_model(), ['ECG', 'THX'], epochs_per_night=2, start=2, max_batch=8) == 8
    assert torch.cuda.memory_allocated() - before <= 1 << 20
