"""Drive the PyTorch / CUDA port (wav2sleep_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles K1 (``wav2sleep_tpu_torch/csrc/conv_k3.cu``) with nvcc.
3. Kernel: K1 against its plain PyTorch version (``conv_k3_reference``) at
   every (C_in, C_out, stride) of the flagship encoders, at the ECG
   encoder's lengths for a batch of 8 ten-hour nights, with phi as the
   identity and as instance norm + gelu, in f32 (TF32 off, atol/rtol 1e-4)
   and in bf16 (see ``BF16_TOL``); median CUDA-event times of both.
4. Model: the recorded goldens (tests/goldens) reproduced on the card, and
   the flagship forward at full width (f32, 2 one-hour nights, seeded
   random weights) on the kernel path against the plain path; K1 must
   launch exactly 80 times per forward.
5. Serve: ``StreamingPipelineQ8`` in bf16, batch 8, on 16 ten-hour nights
   (one with an absent modality); every hypnogram has 1200 epochs in 0..3.
   The nights are seeded numpy waveforms mu-law encoded up front
   (``mulaw_q8``, the q8 transport's encoding) and handed over by a small
   extractor with ``Q8NightExtractor``'s ``extract_into`` interface, so the
   host side of the timed run is a copy of ready codes. Throughput is all
   nights served over all the time the passes took, the first pass included.

The line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from wav2sleep_tpu_torch.pipeline import grid_length

SIGNALS = ('ECG', 'PPG', 'ABD', 'THX')
# (C_in, C_out, stride, T): every K1 shape of the flagship encoders, at its
# first (longest) length in the ECG encoder for ten-hour nights.
KERNEL_SHAPES = [
    (16, 16, 1, 1_228_800),
    (16, 16, 2, 1_228_800),
    (16, 32, 1, 307_200),
    (32, 32, 1, 307_200),
    (32, 32, 2, 307_200),
    (32, 64, 1, 76_800),
    (64, 64, 1, 76_800),
    (64, 64, 2, 76_800),
    (64, 128, 1, 19_200),
    (128, 128, 1, 19_200),
    (128, 128, 2, 19_200),
]
F32_TOL = 1e-4
# bf16: |kernel - plain| <= BF16_TOL * (|plain| + rms(plain)). Both round y
# to bf16 once (1 ulp, 2**-8 to 2**-7 relative); the plain version also
# rounds phi(x) to bf16 before the conv (2**-9 relative per term, which adds
# up to about 2**-9 of rms(y)). 2**-6 leaves a margin of 2-4 bf16 ulps.
BF16_TOL = 2.0**-6
MODEL_TOL = 1e-3  # f32 logits, kernel path vs plain path, atol and rtol
GOLDEN_TOL = 5e-4  # as the JAX package's golden replay
BATCH, NIGHTS, HOURS = 8, 16, 10.0


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_kernel(torch, k1, block_stats):
    """K1 vs plain at every flagship shape; returns (max f32 |d|, largest-call times)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    max_f32_err, largest = 0.0, None
    for ci, co, stride, T in KERNEL_SHAPES:
        x32 = torch.randn((BATCH, T, ci), device='cuda', generator=gen) * 1.5 + 0.2
        w32 = (torch.rand((3, ci, co), device='cuda', generator=gen) * 2 - 1) / (3 * ci) ** 0.5
        b32 = torch.randn((co,), device='cuda', generator=gen) * 0.1
        mu, inv = block_stats(x32, 1e-2)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            for phi, args in (('identity', (b, None, None, stride, None)),
                              ('norm+gelu', (None, mu, inv, stride, 'gelu'))):
                got = k1.conv_k3(x, w, *args)
                want = k1.conv_k3_reference(x, w, *args)
                torch.cuda.synchronize()
                if got.shape != want.shape:
                    raise AssertionError(f'K1 shape {tuple(got.shape)} != plain {tuple(want.shape)}')
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                if dtype == torch.float32:
                    # Also against f64 arithmetic, so the f32 check does not
                    # rest on cuDNN alone.
                    exact = k1.conv_k3_reference(
                        x.double(), w.double(), *(None if a is None else a.double() for a in args[:3]), *args[3:]
                    )
                    err64 = float((got.double() - exact).abs().max())
                    plain64 = float((want.double() - exact).abs().max())
                    del exact
                    ok = bool((diff <= F32_TOL + F32_TOL * want.float().abs()).all()) and err64 <= F32_TOL
                    max_f32_err = max(max_f32_err, err)
                    tol = f'atol=rtol={F32_TOL:g}; vs f64: kernel {err64:.2e}, plain {plain64:.2e}'
                else:
                    ref = want.float()
                    bound = BF16_TOL * (ref.abs() + ref.square().mean().sqrt())
                    ok = bool((diff <= bound).all())
                    tol = f'<= 2^-6 (|y|+rms y)'
                ms = cuda_ms(lambda: k1.conv_k3(x, w, *args))
                plain_ms = cuda_ms(lambda: k1.conv_k3_reference(x, w, *args))
                name = 'f32' if dtype == torch.float32 else 'bf16'
                log(f'K1 {name:4s} {phi:9s} {ci:3d}->{co:3d} s{stride} B={BATCH} T={T}: '
                    f'max|d|={err:.3e} ({tol}) {"ok" if ok else "FAIL"}; '
                    f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
                if not ok:
                    raise AssertionError(f'K1 disagrees with its plain version at {ci}->{co} s{stride} {name} {phi}')
                if (ci, co, stride, dtype, phi) == (16, 16, 1, torch.bfloat16, 'norm+gelu'):
                    largest = (ms, plain_ms)
                del got, want, diff
        del x32, x, mu, inv
        torch.cuda.empty_cache()
    return max_f32_err, largest


def phase_model(torch, k1, layers, wav2sleep):
    """Goldens on the card, then the full-width flagship on both paths."""
    root = os.path.dirname(os.path.abspath(__file__))
    for name in ('wav2sleep_cardio', 'wav2sleep_eog'):
        data = np.load(os.path.join(root, 'tests', 'goldens', f'{name}.npz'))
        cfg = json.loads(bytes(data['config_json']).decode())
        model = wav2sleep.build_wav2sleep(
            cfg['num_classes'], cfg['signal_map'], cfg['encoders'], cfg['epoch_mixer'], cfg['sequence_mixer']
        )
        model.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith('sd/')})
        model = model.cuda().eval()
        x = {k[3:]: torch.from_numpy(data[k]).cuda() for k in data.files if k.startswith('in/')}
        before = k1.LAUNCHES
        with torch.inference_mode():
            logits = model(x).cpu().numpy()
        err = float(np.abs(logits - data['logits']).max())
        log(f'golden {name}: max|d|={err:.3e} vs recorded logits (atol=rtol={GOLDEN_TOL:g}), '
            f'K1 launches {k1.LAUNCHES - before}')
        np.testing.assert_allclose(logits, data['logits'], atol=GOLDEN_TOL, rtol=GOLDEN_TOL)

    gen = torch.Generator().manual_seed(0)
    model = wav2sleep.flagship_model(device='cuda', dtype=torch.float32, generator=gen)
    S = 120  # one-hour nights
    g = torch.Generator(device='cuda').manual_seed(1)
    x = {c: torch.randn((2, grid_length(c, 1.0)), device='cuda', generator=g) for c in SIGNALS}
    x['PPG'][1] = -torch.inf  # an absent modality
    if sum(m.kernel_eligible for m in model.modules() if isinstance(m, layers.Conv1D)) != 80:
        raise AssertionError('expected 80 kernel-eligible convs in the flagship')
    with torch.inference_mode():
        before = k1.LAUNCHES
        kern = model(x)
        torch.cuda.synchronize()
        launches = k1.LAUNCHES - before
        with plain_convs(layers, k1):
            before = k1.LAUNCHES
            plain = model(x)
            torch.cuda.synchronize()
            plain_launches = k1.LAUNCHES - before
    err = float((kern - plain).abs().max())
    log(f'flagship f32 B=2 S={S}: logits {tuple(kern.shape)}, kernel vs plain max|d|={err:.3e} '
        f'(atol=rtol={MODEL_TOL:g}); K1 launches per forward: {launches} (plain path: {plain_launches})')
    if launches != 80 or plain_launches != 0:
        raise AssertionError(f'K1 launches per forward {launches} (plain {plain_launches}), expected 80 (0)')
    if kern.shape != (2, S, 4) or not bool(torch.isfinite(kern).all()):
        raise AssertionError('flagship logits have the wrong shape or are not finite')
    torch.testing.assert_close(kern, plain, atol=MODEL_TOL, rtol=MODEL_TOL)


@contextlib.contextmanager
def plain_convs(layers, k1):
    """Route the model's K1 convs to the plain version, for an A/B of the
    same model on the same inputs."""
    layers.conv_k3 = k1.conv_k3_reference
    try:
        yield
    finally:
        layers.conv_k3 = k1.conv_k3


def mulaw_q8(wave: np.ndarray) -> tuple[np.ndarray, float]:
    """mu-law int8 codes of a finite row against its peak, and the peak.

    The q8 transport's encoding: |code| counts the f32 rounding thresholds
    2**((k - 0.5) * 8 / 127), k = 1..127, at or below 1 + 255 |x| / peak,
    and the code takes x's sign.
    """
    x = np.asarray(wave, np.float32)
    peak = np.float32(np.abs(x).max())
    scale = np.float32(255.0) / (peak if peak > 0 else np.float32(1.0))
    t = (1.0 + np.minimum(np.abs(x) * scale, np.float32(255.0))).astype(np.float32)
    thresholds = np.exp2((np.arange(1, 128, dtype=np.float64) - 0.5) * 8.0 / 127).astype(np.float32)
    k = np.searchsorted(thresholds, t, side='right').astype(np.int8)
    return np.where(np.signbit(x), -k, k).astype(np.int8), float(peak)


class SyntheticQ8Nights:
    """Seeded numpy nights, q8-encoded up front; ``extract_into`` copies one
    night's codes and metadata into the pipeline's buffers, as
    ``Q8NightExtractor`` does from an EDF."""

    def __init__(self, n_nights: int, hours: float, seed: int = 0, absent: dict | None = None):
        self.n_epochs = int(round(hours * 120))
        self.nights = {}
        for i in range(n_nights):
            rng = np.random.default_rng(seed + i)
            night = {}
            for col in SIGNALS:
                if col in (absent or {}).get(i, ()):
                    continue
                n = grid_length(col, hours)
                t = np.arange(n, dtype=np.float32) * (self.n_epochs / n)  # in epochs
                wave = np.sin(t * rng.uniform(1.0, 40.0)) * rng.uniform(50, 500)
                wave = (wave + rng.normal(scale=30.0, size=n)).astype(np.float32)
                night[col] = mulaw_q8(wave)
            self.nights[f'night{i:02d}'] = night

    def extract_into(self, fp, out_i8, meta, row) -> int:
        night = self.nights[fp]
        for col in out_i8:
            dst, m = out_i8[col][row], meta[col]
            if col not in night:
                dst.fill(0)
                m[row] = (0.0, 0.0, 1.0, 0, 0, False)
                continue
            codes, peak = night[col]
            dst[:] = codes
            m[row] = (1.0, 0.0, peak, len(codes), len(codes), True)
        return self.n_epochs


def phase_serve(torch, k1, layers, wav2sleep, pipeline, card):
    t0 = time.time()
    nights = SyntheticQ8Nights(NIGHTS, HOURS, seed=0, absent={5: ('THX',)})
    log(f'serve: encoded {NIGHTS} nights of {HOURS:g} h on the host in {time.time() - t0:.1f} s (set-up)')
    model = wav2sleep.flagship_model(generator=torch.Generator().manual_seed(0))
    pipe = pipeline.StreamingPipelineQ8(
        model, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS, precision='bfloat16',
        device='cuda', extractor=nights,
    )
    pipe.warmup()
    names = sorted(nights.nights)
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = 0
    walls, passes = [], 3
    for _ in range(passes):
        t0 = time.perf_counter()
        out = list(pipe.run(names))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = k1.LAUNCHES
    if [fp for fp, _ in out] != names:
        raise AssertionError('serve: nights missing from the output')
    for fp, hyp in out:
        if hyp.shape != (nights.n_epochs,) or hyp.min() < 0 or hyp.max() > 3:
            raise AssertionError(f'serve: bad hypnogram for {fp}: shape {hyp.shape}, range {hyp.min()}..{hyp.max()}')
    expected = 80 * passes * (-(-NIGHTS // BATCH))
    if launches != expected:
        raise AssertionError(f'serve: K1 launches {launches}, expected {expected}')
    # All nights served over all the time the passes took, the first included.
    total = sum(walls)
    log(f'serve q8 bf16 batch {BATCH}: {passes} passes of {NIGHTS} nights x {HOURS:g} h in '
        f'{", ".join(f"{w:.3f}" for w in walls)} s: {passes * NIGHTS} nights in {total:.3f} s, '
        f'{passes * NIGHTS / total:.2f} nights/s, {3600 * passes * NIGHTS / total:.0f} recordings/hour '
        f'on {card}; K1 launches {launches}; '
        f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    # One batch's forward from the pooled pinned codes (H2D copy included),
    # kernel vs plain path.
    slot = pipe._slots[0]
    for i, fp in enumerate(names[:BATCH]):
        nights.extract_into(fp, slot.codes_np, slot.meta, i)
    times = {'kernel': [], 'plain': []}
    for path in ('kernel', 'plain', 'plain', 'kernel'):
        with plain_convs(layers, k1) if path == 'plain' else contextlib.nullcontext():
            times[path].append(cuda_ms(lambda: pipe._launch(slot), reps=5, warmup=1))
    log(f'forward bf16 B={BATCH} x {HOURS:g} h from pinned codes: K1 path '
        f'{", ".join(f"{t:.2f}" for t in times["kernel"])} ms, plain path '
        f'{", ".join(f"{t:.2f}" for t in times["plain"])} ms (run kernel, plain, plain, kernel)')
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA card')
    from wav2sleep_tpu_torch import pipeline
    from wav2sleep_tpu_torch.models import layers, wav2sleep
    from wav2sleep_tpu_torch.ops import conv_k3 as k1
    from wav2sleep_tpu_torch.ops.block_domain import block_stats

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}')
    log(f'nvidia-smi: {card}')

    t0 = time.time()
    k1.build()
    log(f'build: conv_k3 in {time.time() - t0:.1f} s')
    for line in k1.BUILD_LOG.splitlines():
        if 'registers' in line or 'spill' in line.lower():
            log('  ptxas: ' + line.strip())

    with torch.inference_mode():
        max_err, (ms, plain_ms) = phase_kernel(torch, k1, block_stats)
    phase_model(torch, k1, layers, wav2sleep)
    launches = phase_serve(torch, k1, layers, wav2sleep, pipeline, card)

    kernels = [{
        'name': 'conv_k3',
        'route': 'cuda',
        'source': 'wav2sleep_tpu_torch/csrc/conv_k3.cu',
        'replaces': 'wav2sleep_tpu/ops/pallas_conv.py:136',
        'launches': launches,
        'max_abs_err': max_err,  # largest |kernel - plain| over the f32 checks
        'ms': ms,  # bf16 16->16 s1 norm+gelu, B=8, T=1,228,800 (the largest call)
        'plain_ms': plain_ms,
    }]
    log(f'nvidia-smi: {card}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
