"""Drive the PyTorch / CUDA port (wav2sleep_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles ``csrc/conv_k3.cu`` (K1, K2), ``csrc/ema_norm.cu``
   (K3) and ``csrc/conv_variants.cu`` (the five profiling variants) with
   nvcc and the native host library (``native/src``, EDF decode and the f64
   EMA) with g++, all four at once; prints each build time.
3. K1 against its plain PyTorch version (``conv_k3_reference``) at every
   (C_in, C_out, stride) of the flagship encoders, at the ECG encoder's
   lengths for a batch of 8 ten-hour nights, with phi as the identity and as
   instance norm + gelu, in f32 (TF32 off, atol/rtol 1e-4) and in bf16 (see
   ``BF16_TOL``); times of K1, the plain version and, for the identity, one
   ``F.conv1d`` call on the same tensors, each in two ways
   (``bench_conv.both_ms``): CUDA events around one call, median of 10
   (the times of the kernels line), and around runs of 10 back-to-back
   calls, median of 5 (the card's time alone, without the host's time per
   call); each call's bound and the share of it reached; per dtype, the
   shapes at which K1 is slower than ``F.conv1d``.
4. K2 (``conv_k3_stats``) at the same shapes: y as K1's is checked; mu and inv
   within atol/rtol 1e-5 (f32) and 1e-3 (bf16) of ``block_stats`` of the
   plain output; times of K2, of K1 + ``block_stats``, and of the plain
   version, both ways. Then K1, K2 and ``F.conv1d`` summed over the 80 k3
   convs of one bf16 flagship forward (8 ten-hour nights), each call timed
   both ways on the inputs the forward gives it, beside the sum of their
   bounds.
5. K3 (``ema_normalize``) on the rows of one serving batch (8 ten-hour
   nights x 4 modalities, each at its grid rate) in one launch: over the
   whole length against the native host f64 recurrence (atol 5e-3 plus
   1e-3 of |z|, see ``EMA_HOST_RTOL``), and on
   the first 65,536 samples against ``ema_normalize_reference`` on the card
   (atol 1e-4; the warm-up window of the prefix equals the full row's, which
   is checked); median time per forward, and the nanoseconds per step of
   the longest row that follow from it.
6. Model: the recorded goldens (tests/goldens) on the card; the flagship at
   full width (f32, 2 one-hour nights, seeded random weights) on the kernel
   path against the plain path, 80 K1 launches per forward; the flagship bf16
   forward on 8 ten-hour nights with kernel statistics off and on (80 K1 and
   0 K2 launches, then 0 and 80), logits within twice the forward's own
   bf16-vs-f32 difference, times in the order off, on, on, off.
7. Serve q8: ``StreamingPipelineQ8`` in bf16, batch 8, on 16 ten-hour nights
   (one with an absent modality), the nights mu-law encoded up front
   (``mulaw_q8``) and handed over by a small extractor; 2 passes.
8. Serve f32, causal: 16 ten-hour EDF nights (ECG and Pleth at 256 Hz, Thor
   and Abdo at 32 Hz, one without Thor) written with the port's
   ``write_edf`` (set-up, not timed), served by ``StreamingPipeline(
   normalize='causal', precision='bfloat16', batch_size=8)`` with host decode
   in the loop: 2 passes, then 1 pass in the kernel-statistics configuration,
   then 1 untimed pass with ``normalize='zscore'``. Every hypnogram has 1,200
   epochs in 0..3; the launch counts of K1, K2 and K3 are asserted.
9. Serve CLI: a flagship checkpoint folder written with the port's
   ``save_checkpoint_folder`` (the seeded weights of phase 8, full width),
   loaded by ``load_model`` in bf16 and served over the q16, q4 and raw
   transports (``StreamingPipelineQ16`` / ``Q4`` / ``Raw``, batch 8) on
   phase 8's EDF nights, host extraction in the loop: a warm-up, then 2
   timed passes each, with 80 K1 launches per batch and the native library
   in use asserted; each transport's hypnograms against phase 8's z-score
   pass. Then one run of ``wav2sleep_tpu_torch.serve.main`` with the
   default transport (q16) and device (the card): 16 CSV files of 1,200
   rows whose ``Pred`` column is the q16 pass's hypnograms; then one run
   with each other ``--transport`` and one with ``--precision float32``,
   each giving 16 valid files.

10. Profile variants: the K1 bisection ladder of ``ops/conv_variants.py``
   (``scripts/profile_pallas_variants.py``'s kernels) at x [8, 153,600, 128]
   bf16, tb 2048. First the proof of each rung's route in the built
   library's SASS (``cuobjdump -sass``): V2, V3, V4 and V7 on wgmma and
   TMA (HGMMA, UTMALDG and UTMASTG, none missing, V7 with V3's 24 HGMMA),
   V0 one 16-byte load and store, beside ptxas's registers and spills.
   Then ``python -m wav2sleep_tpu_torch.profile_variants``'s ``run`` once
   (its JSON line; launches counted from 0 around it); then each kernel
   against its plain version on the same inputs, V0 bit for bit and
   the others within ``BF16_TOL`` of |plain| + rms(plain), V7 with zero,
   random and true-neighbour halos (``run`` holds the last against K1); each
   rung, its plain version, K1 and one PyTorch call of the same function
   (``Tensor.copy_``, ``torch.matmul``, ``torch.einsum``, ``F.conv1d`` of
   the tiles, ``F.conv1d``), each library call first held against the plain
   version, timed both ways, with the share of the bound and the gaps
   between rungs.
11. Train: the training step (``wav2sleep_tpu_torch.train``) on ten-hour
   nights of the flagship, under torch's default TF32 flags (restored for
   the phase): (a) f32 at the config's batch 16, lossless, masker and flip
   on, remat on, EMA off: step 1 on the kernel path against the plain path
   (loss, gradient norm and each parameter's gradient, as Adam's first
   moment, within ``TRAIN_TOL`` relative), 160 K1 launches
   a step (forward and recompute), then chained steps timed (compute and
   e2e, every loss and gradient norm finite) and the peak memory; (b) bf16
   at batch 8 through ``train_bench.run``, lossless (compute and e2e) and on
   a batch q8-encoded up front (compute), EMA on, 160 K1 launches a step,
   and the card's q8 decode of that batch against the CPU's
   (``Q8_DECODE_ULPS``); (c) step 1 of (b)'s lossless state, batch and seed
   with kernel statistics on (160 K2 launches) against off, loss and
   gradient norm within twice the step's bf16 error, and the step times off,
   on, on, off. Prints a
   ``train`` JSON line.
12. Families: the other model kinds at full width. (a) SleepPPG-Net
   (``scripts/config/model/ppgnet.yaml``: batch norm, leaky, dropout 0.2)
   on ten-hour nights of seeded N(0, 1) PPG, f32 at the config's batch 16
   under torch's default TF32 flags, flip on: step 1 with remat off and on
   from the same weights, batch and seed (loss, gradient norm, each
   parameter's gradient as Adam's first moment and every running statistic
   within ``TRAIN_TOL`` relative; each batch norm updated once), then
   chained steps timed and the peak memory, the eval step on the running
   statistics (parameters and EMA), and ``save_checkpoint_folder`` ->
   ``load_model(precision='bfloat16')``: a B=8 bf16 forward within
   ``FAMILY_BF16_TOL`` of the f32 eval logits; no K1/K2 launch. (b) The
   flagship with ``causal: true`` (conv-causal encoders and sequence mixer)
   in f32 through ``StreamingPipeline(normalize='causal')`` on phase 8's EDF
   nights: one K3 launch a batch, no K1, valid hypnograms, recordings/hour;
   then causality on the card: the first half of a night gives the first
   half of the whole night's logits (layer-norm encoders; the config's
   instance norm spans the night, and its |d| is printed). (c) A
   chunk-causal flagship with the default (batch-norm) sequence mixer and a
   post-norm epoch mixer, from a checkpoint folder in bf16, one batch of
   the EDF nights: valid hypnograms, no K1. Prints a ``families`` JSON line
   and the phase's wall time.

13. Trainer: ``python -m wav2sleep_tpu_torch.train``'s ``main(argv)`` on the
   card. (a) A parquet corpus written with ``data.parquet.write_night`` as
   ingest lays it out: mesa and shhs, each 8 train, 4 val and 2 test
   ten-hour nights (ECG, PPG, ABD, THX with a stage-dependent amplitude,
   and a Stage column), one night without THX and one ``.issues`` night;
   bytes and seconds printed. (b) The flagship at full width
   (``scripts/config/model/wav2sleep.yaml``: remat on, masker and flip on,
   f32 under torch's default TF32 flags), 2 epochs at batch 8 with
   accumulation 2 (target 16), EMA from step 0, the test set: every loss
   finite, metrics.jsonl with the JAX trainer's keys, ``checkpoints/
   {last,best}`` and their sidecars, ``final_metrics.json``, and K1
   launched 160 times a training micro-step (forward and remat recompute,
   counted around each training epoch). (c) ``epochs=3 ckpt_path=last``
   into the same run directory: exactly one more epoch, appended to the
   same metrics.jsonl, from a restored state whose parameters, Adam moments
   and EMA equal the saved ones bit for bit. (d) ``<run>/model`` through
   ``api.load_model(precision='bfloat16')`` on one batch of the val nights:
   1,200-epoch hypnograms in 0..3. (e) ``tune_batch_size`` for the f32
   flagship on ten-hour nights up to its ceiling of 512: the tuned batch,
   the batch that ran out of memory and the seconds, with the card's
   allocated memory back within 64 MiB. Prints a ``trainer`` JSON line.
14. API: the inference API (``wav2sleep_tpu_torch.api``) on the card. (a)
   ``predict_on_folder`` with the device and batch at their defaults (the
   card, 4) over 4 of phase 8's ten-hour EDF nights (night 5 without Thor)
   from phase 9's checkpoint folder, f32 then bf16: every night 1,200
   epochs in 0..3, each CSV 1,200 rows stamped from the EDF start + 30 s +
   30/1024 s (the cache's first grid point) holding the predictions, K1
   launched in every forward and no K2 or K3; ``prepare`` seconds a night,
   ``predict`` nights/hour and ``save_predictions`` seconds; agreement with
   phase 8's z-score hypnograms (report only). Then ``W2SModel.logits`` in
   f32 on K1 against the same model with its convs plain, on the batch
   ``predict`` forms: |d| <= 5e-4 (1 + |plain|). (b) ``python -m
   wav2sleep_tpu_torch.cli.predict``'s ``main`` with ``--no-preprocess``
   over phase 13's labeled val nights and its exported model: the kappa
   and accuracy lines printed, CSVs with a Stage column. Prints an ``api``
   JSON line.

Serving throughput is all nights served over all the time the passes took,
the first pass included. Each path's kernel launches are counted from 0 just
before it runs. The ``train``, ``families``, ``trainer`` and ``api`` lines come before the ``kernels``
line; the line before the last is a JSON object describing the kernels (K1's
and K2's entries also carry ``train_launches``, per training step, K1's
``trainer_launches``, per training micro-step of phase 13, and
``api_launches``, phase 14's f32 ``predict_on_folder`` run, and K3's
``causal_flagship_launches``, phase 12 (b)'s); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wav2sleep_tpu_torch.bench_conv import SHAPES as KERNEL_SHAPES
from wav2sleep_tpu_torch.bench_conv import both_ms, cuda_ms
from wav2sleep_tpu_torch.bench_ema import rates as ema_rates
from wav2sleep_tpu_torch.bench_ema import serving_rows
from wav2sleep_tpu_torch.pipeline import grid_length
from wav2sleep_tpu_torch.utils import card_line

ROOT = os.path.dirname(os.path.abspath(__file__))
SIGNALS = ('ECG', 'PPG', 'ABD', 'THX')
F32_TOL = 1e-4
# bf16: |kernel - plain| <= BF16_TOL * (|plain| + rms(plain)). Both round
# phi(x) to bf16 before the products (from the same f32 values, up to the
# last bit of the activation), sum the exact bf16 products in f32 in their
# own orders, and round y to bf16 once (1 ulp, 2**-8 to 2**-7 relative).
# 2**-6 leaves a margin of 2-4 bf16 ulps.
BF16_TOL = 2.0**-6
STATS_TOL = {'float32': 1e-5, 'bfloat16': 1e-3}  # K2's mu, inv vs block_stats of the plain y
# K3 vs the f64 host recurrence over whole rows: |d| <= EMA_HOST_TOL +
# EMA_HOST_RTOL |z|. 5e-3 is the JAX package's bound (tests/data/
# test_pallas_ema.py, 20,000 samples). Over whole ten-hour rows an f32
# recurrence also carries the f32 rounding of its rates: alpha and 1 - alpha
# stored in f32 need not sum to 1, and the recurrences then settle with a
# relative bias of up to 2**-25 / alpha in their state (9e-4 for sigma**2 at
# the ECG rate, alpha_v = 1 / (900 s x 34.13 Hz)), about half that in z; so
# a relative term of 1e-3, which matters where |z| is large (artifacts).
EMA_HOST_TOL, EMA_HOST_RTOL = 5e-3, 1e-3
EMA_PLAIN_TOL = 1e-4  # K3 vs its plain version, both f32
EMA_PREFIX = 65_536
MODEL_TOL = 1e-3  # f32 logits, kernel path vs plain path, atol and rtol
GOLDEN_TOL = 5e-4  # as the JAX package's golden replay
NORM_EPS = 1e-2  # the encoders' instance-norm eps
BATCH, NIGHTS, HOURS = 8, 16, 10.0
# Published H100 SXM peaks (dense): HBM bytes/s; FLOP/s of f32 outside the
# tensor cores and of bf16 in them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
# EDF channels of the served nights: label -> (rate Hz, physical range).
EDF_CHANNELS = {'ECG': (256.0, (-5.0, 5.0)), 'Pleth': (256.0, (-100.0, 100.0)),
                'Thor': (32.0, (-10.0, 10.0)), 'Abdo': (32.0, (-10.0, 10.0))}


def log(*args):
    print(*args, flush=True)


def fmt(t: tuple[float, float]) -> str:
    return f'{t[0]:.4f} ({t[1]:.4f})'


def bound(n_bytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """Least time in ms the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for the dtype."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def conv_work(B, T, ci, co, stride, dtype_name, fused: bool, stats: bool) -> tuple[int, int]:
    """Bytes and FLOPs of one K1 / K2 call: x, w, bias (and mu, inv in)
    read once, y (and mu, inv out) written once; the conv's multiply-adds,
    2 FLOPs each."""
    item = 4 if dtype_name == 'float32' else 2
    t_out = (T - 1) // stride + 1
    n_bytes = (B * T * ci + 3 * ci * co + co + B * t_out * co) * item
    n_bytes += 2 * B * ci * 4 if fused else 0
    n_bytes += 2 * B * co * 4 if stats else 0
    return n_bytes, 2 * 3 * ci * co * t_out * B


def conv_bound(B, T, ci, co, stride, dtype_name, fused: bool, stats: bool) -> tuple[float, str]:
    return bound(*conv_work(B, T, ci, co, stride, dtype_name, fused, stats), dtype_name)


def counts(k1, k3) -> dict:
    return {'K1': k1.LAUNCHES, 'K2': k1.STATS_LAUNCHES, 'K3': k3.LAUNCHES}


def zero_counts(k1, k3) -> None:
    k1.LAUNCHES = k1.STATS_LAUNCHES = k3.LAUNCHES = 0


def phase_build(k1, k3, cv, native):
    """Build the three kernel libraries and the native host library at once."""

    def timed(name, fn):
        t0 = time.time()
        fn()
        return name, time.time() - t0

    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(timed, n, f) for n, f in (
            ('conv_k3.cu (K1, K2)', k1.build), ('ema_norm.cu (K3)', k3.build),
            ('conv_variants.cu (V0-V7)', cv.build), ('native host library', native.build))]
        done = [f.result() for f in futures]  # raises if a build failed
    log('build: ' + ', '.join(f'{n} {s:.1f} s' for n, s in done))
    for name, mod in (('conv_k3.cu', k1), ('ema_norm.cu', k3), ('conv_variants.cu', cv)):
        text = mod.BUILD_LOG
        regs = [int(v) for v in re.findall(r'Used (\d+) registers', text)]
        smem = [int(v) for v in re.findall(r'(\d+) bytes smem', text)]
        spills = sum(int(v) for v in re.findall(r'(\d+) bytes spill stores', text))
        if regs:
            log(f'  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, '
                f'{min(smem, default=0)}-{max(smem, default=0)} bytes static smem, {spills} bytes spilled')


def phase_k1(torch, F, k1, block_stats):
    """K1 vs plain at every flagship shape; returns (max f32 |d|, the line's call)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    max_f32_err, line = 0.0, None
    slower = {'float32': ([], []), 'bfloat16': ([], [])}
    for ci, co, stride, T in KERNEL_SHAPES:
        x32 = torch.randn((BATCH, T, ci), device='cuda', generator=gen) * 1.5 + 0.2
        w32 = (torch.rand((3, ci, co), device='cuda', generator=gen) * 2 - 1) / (3 * ci) ** 0.5
        b32 = torch.randn((co,), device='cuda', generator=gen) * 0.1
        mu, inv = block_stats(x32, NORM_EPS)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
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
                    del exact
                    ok = bool((diff <= F32_TOL + F32_TOL * want.float().abs()).all()) and err64 <= F32_TOL
                    max_f32_err = max(max_f32_err, err)
                    tol = f'atol=rtol={F32_TOL:g}, vs f64 {err64:.1e}'
                else:
                    ref = want.float()
                    ok = bool((diff <= BF16_TOL * (ref.abs() + ref.square().mean().sqrt())).all())
                    tol = '<=2^-6(|y|+rms)'
                if not ok:
                    raise AssertionError(f'K1 disagrees with its plain version at {ci}->{co} s{stride} {name} {phi}')
                ms = both_ms(lambda: k1.conv_k3(x, w, *args))
                plain_ms = both_ms(lambda: k1.conv_k3_reference(x, w, *args))
                lib_ms = None
                if phi == 'identity':
                    w_oik = w.permute(2, 1, 0).contiguous()
                    lib = F.conv1d(x.transpose(1, 2), w_oik, b, stride=stride, padding=1).transpose(1, 2)
                    if not torch.allclose(lib.float(), want.float(), atol=1e-2, rtol=1e-2):
                        raise AssertionError(f'F.conv1d is not the same function at {ci}->{co} s{stride} {name}')
                    del lib
                    lib_ms = both_ms(lambda: F.conv1d(x.transpose(1, 2), w_oik, b, stride=stride, padding=1))
                    for i in (0, 1):
                        if ms[i] > lib_ms[i]:
                            slower[name][i].append(f'{ci}->{co} s{stride}')
                bound_ms, bound_by = conv_bound(BATCH, T, ci, co, stride, name, phi != 'identity', False)
                log(f'K1 {name:8s} {phi:9s} {ci:3d}->{co:3d} s{stride} T={T}: max|d|={err:.2e} ({tol}) ok; '
                    f'ms one call (back to back): K1 {fmt(ms)}, plain {fmt(plain_ms)}, F.conv1d '
                    f'{"-" if lib_ms is None else fmt(lib_ms)}, bound {bound_ms:.4f} ({bound_by}), '
                    f'{100 * bound_ms / ms[0]:.1f}% ({100 * bound_ms / ms[1]:.1f}%) of the bound')
                if (ci, co, stride, name, phi) == (16, 16, 1, 'bfloat16', 'identity'):
                    line = dict(ms=ms[0], plain_ms=plain_ms[0], bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms[0], call_ms=ms[1], plain_call_ms=plain_ms[1],
                                library_call_ms=lib_ms[1])
                del got, want, diff
        del x32, x, mu, inv
        torch.cuda.empty_cache()
    for name, short in (('bfloat16', 'bf16'), ('float32', 'f32')):
        for how, shapes in zip(('one call', 'back to back'), slower[name]):
            log(f'K1 {short} identity slower than F.conv1d at {len(shapes)} of {len(KERNEL_SHAPES)} shapes ({how})'
                f'{": " + ", ".join(shapes) if shapes else ""}')
    return max_f32_err, line


def phase_k2(torch, k1, block_stats):
    """K2 vs plain at every flagship shape; returns (max f32 |d|, the line's call)."""
    gen = torch.Generator(device='cuda').manual_seed(2)
    max_f32_err, line, slower = 0.0, None, ([], [])
    for ci, co, stride, T in KERNEL_SHAPES:
        x32 = torch.randn((BATCH, T, ci), device='cuda', generator=gen) * 1.5 + 0.2
        w32 = (torch.rand((3, ci, co), device='cuda', generator=gen) * 2 - 1) / (3 * ci) ** 0.5
        b32 = torch.randn((co,), device='cuda', generator=gen) * 0.1 + 0.5
        mu, inv = block_stats(x32, NORM_EPS)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            for phi, args in (('identity', (b, None, None, stride, None)),
                              ('norm+gelu', (b, mu, inv, stride, 'gelu'))):
                y, mu_k, inv_k = k1.conv_k3_stats(x, w, *args, NORM_EPS)
                want = k1.conv_k3_reference(x, w, *args)
                mu_p, inv_p = block_stats(want, NORM_EPS)
                torch.cuda.synchronize()
                diff = (y.float() - want.float()).abs()
                tol = STATS_TOL[name]
                stats_ok = all(bool(((a - e).abs() <= tol + tol * e.abs()).all()) for a, e in ((mu_k, mu_p), (inv_k, inv_p)))
                err = max(float(diff.max()), float((mu_k - mu_p).abs().max()), float((inv_k - inv_p).abs().max()))
                if dtype == torch.float32:
                    y_ok = bool((diff <= F32_TOL + F32_TOL * want.float().abs()).all())
                    max_f32_err = max(max_f32_err, err)
                else:
                    ref = want.float()
                    y_ok = bool((diff <= BF16_TOL * (ref.abs() + ref.square().mean().sqrt())).all())
                if not (y_ok and stats_ok):
                    raise AssertionError(f'K2 disagrees with its plain version at {ci}->{co} s{stride} {name} {phi} '
                                         f'(y ok {y_ok}, stats ok {stats_ok})')

                def k1_then_stats():
                    return block_stats(k1.conv_k3(x, w, *args), NORM_EPS)

                ms = both_ms(lambda: k1.conv_k3_stats(x, w, *args, NORM_EPS))
                k1_stats_ms = both_ms(k1_then_stats)
                plain_ms = both_ms(lambda: k1.conv_k3_stats_reference(x, w, *args, NORM_EPS))
                bound_ms, bound_by = conv_bound(BATCH, T, ci, co, stride, name, phi != 'identity', True)
                for i in (0, 1):
                    if name == 'bfloat16' and ms[i] >= k1_stats_ms[i]:
                        slower[i].append(f'{ci}->{co} s{stride} {phi}')
                log(f'K2 {name:8s} {phi:9s} {ci:3d}->{co:3d} s{stride} T={T}: max|d| y {float(diff.max()):.2e}, '
                    f'mu {float((mu_k - mu_p).abs().max()):.2e}, inv {float((inv_k - inv_p).abs().max()):.2e} ok; '
                    f'ms one call (back to back): K2 {fmt(ms)}, K1+block_stats {fmt(k1_stats_ms)}, '
                    f'plain {fmt(plain_ms)}, bound {bound_ms:.4f} ({bound_by}), '
                    f'{100 * bound_ms / ms[0]:.1f}% ({100 * bound_ms / ms[1]:.1f}%) of the bound')
                if (ci, co, stride, name, phi) == (16, 16, 1, 'bfloat16', 'norm+gelu'):
                    line = dict(ms=ms[0], plain_ms=plain_ms[0], bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None, call_ms=ms[1], plain_call_ms=plain_ms[1], library_call_ms=None)
                del y, want, diff
        del x32, x, mu, inv
        torch.cuda.empty_cache()
    for how, calls in zip(('one call', 'back to back'), slower):
        log(f'K2 bf16 not faster than K1 + block_stats at {len(calls)} of {2 * len(KERNEL_SHAPES)} calls ({how})'
            f'{": " + ", ".join(calls) if calls else ""}')
    return max_f32_err, line


def phase_forward_convs(torch, F, k1, layers, wav2sleep):
    """K1, K2 and ``F.conv1d`` summed over the k3 convs of one bf16
    flagship forward (8 ten-hour nights), each call timed on the inputs the
    forward gives it, beside the sum of the calls' bounds."""
    model = wav2sleep.flagship_model(dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device='cuda').manual_seed(4)
    xb = {c: torch.randn((BATCH, grid_length(c, HOURS)), device='cuda', generator=g).to(torch.bfloat16)
          for c in SIGNALS}
    tot = dict.fromkeys(('calls', 'bytes', 'flops', 'bound'), 0.0)
    tot.update({k: np.zeros(2) for k in ('k1', 'k2', 'lib')})

    def timed_conv(x, w, bias=None, mu=None, inv=None, stride=1, act=None):
        args = (bias, mu, inv, stride, act)
        w_oik = w.permute(2, 1, 0).contiguous()
        tot['k1'] += both_ms(lambda: k1.conv_k3(x, w, *args))
        tot['k2'] += both_ms(lambda: k1.conv_k3_stats(x, w, *args, NORM_EPS))
        tot['lib'] += both_ms(lambda: F.conv1d(x.transpose(1, 2), w_oik, bias, stride=stride, padding=1))
        work = conv_work(*x.shape, w.shape[2], stride, 'bfloat16', mu is not None, False)
        tot['bytes'] += work[0]
        tot['flops'] += work[1]
        tot['bound'] += bound(*work, 'bfloat16')[0]
        tot['calls'] += 1
        return k1.conv_k3(x, w, *args)

    layers.conv_k3 = timed_conv
    try:
        model(xb)
    finally:
        layers.conv_k3 = k1.conv_k3
    if tot['calls'] != 80:
        raise AssertionError(f'{tot["calls"]:.0f} k3 convs in the flagship forward, expected 80')
    k1_ms, k2_ms, lib_ms = (tot[k] for k in ('k1', 'k2', 'lib'))
    log(f'K1/K2 over one bf16 flagship forward (B={BATCH} x {HOURS:g} h, 80 calls at their lengths), '
        f'ms one call (back to back): K1 {k1_ms[0]:.3f} ({k1_ms[1]:.3f}), '
        f'{100 * tot["bound"] / k1_ms[0]:.1f}% ({100 * tot["bound"] / k1_ms[1]:.1f}%) of the bound; '
        f'K2 {k2_ms[0]:.3f} ({k2_ms[1]:.3f}); F.conv1d {lib_ms[0]:.3f} ({lib_ms[1]:.3f}); '
        f'bound {tot["bound"]:.3f} ms ({tot["bytes"] / 1e9:.2f} GB, {tot["flops"] / 1e9:.1f} GFLOP)')


def phase_k3(torch, k3):
    """K3 on one serving batch's rows; returns (max |d| vs plain, the line's call, ms per forward)."""
    fss, args = ema_rates()
    xs = serving_rows(seed=3)
    got = k3.ema_normalize(xs, fss, **args)
    torch.cuda.synchronize()
    # (a) Whole rows against the host f64 recurrence.
    err_host = err_small = rel_host = ratio = 0.0
    for x, z, fs in zip(xs, got, fss):
        for i in range(BATCH):
            want = k3.ema_normalize_host(x[i].cpu().numpy(), fs, **args)
            d = np.abs(z[i].cpu().numpy() - want)
            err_host = max(err_host, float(d.max()))
            err_small = max(err_small, float(d[np.abs(want) <= 4].max()))
            rel_host = max(rel_host, float((d / np.maximum(np.abs(want), 1.0)).max()))
            ratio = max(ratio, float((d / (EMA_HOST_TOL + EMA_HOST_RTOL * np.abs(want))).max()))
    log(f'K3 whole rows ({", ".join(f"{BATCH}x{x.shape[1]}" for x in xs)}) vs host f64: max|d|={err_host:.3e}, '
        f'where |z|<=4 {err_small:.3e}, max|d|/max(|z|,1)={rel_host:.3e} '
        f'(|d| <= {EMA_HOST_TOL:g} + {EMA_HOST_RTOL:g}|z|: worst {ratio:.3f} of the bound)')
    if not ratio <= 1.0:
        raise AssertionError(f'K3 disagrees with the host f64 recurrence: {ratio:.3f} of the bound')
    # (b) The first EMA_PREFIX samples against the plain version on the card.
    for x, fs in zip(xs, fss):
        full, prefix = (k3.warmup_length(n, fs, **args) for n in (x.shape[1], EMA_PREFIX))
        if full != prefix:
            raise AssertionError(f'warm-up window of the prefix {prefix} != the full row\'s {full}')
    heads = [x[:, :EMA_PREFIX].contiguous() for x in xs]
    head_k = k3.ema_normalize(heads, fss, **args)
    t0 = time.time()
    head_p = k3.ema_normalize_reference(heads, fss, **args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)  # one run: the plain loop takes seconds
    err_plain = max(float((a - e).abs().max()) for a, e in zip(head_k, head_p))
    err_prefix = max(float((a - z[:, :EMA_PREFIX]).abs().max()) for a, z in zip(head_k, got))
    log(f'K3 first {EMA_PREFIX} samples of {4 * BATCH} rows: vs plain max|d|={err_plain:.3e} '
        f'(atol {EMA_PLAIN_TOL:g}); vs the whole rows\' first samples max|d|={err_prefix:.3e}')
    if not err_plain <= EMA_PLAIN_TOL or err_prefix != 0.0:
        raise AssertionError('K3 disagrees with its plain version on the prefix')
    ms_prefix = cuda_ms(lambda: k3.ema_normalize(heads, fss, **args), reps=5, warmup=1)
    ms_forward = cuda_ms(lambda: k3.ema_normalize(xs, fss, **args), reps=5, warmup=1)
    per_modality = [cuda_ms(lambda: k3.ema_normalize([x], [fs], **args), reps=3, warmup=1) for x, fs in zip(xs, fss)]
    log('K3 per modality alone (ms): ' + ', '.join(f'{c} {t:.3f}' for c, t in zip(SIGNALS, per_modality)))
    rows_prefix = 4 * BATCH * EMA_PREFIX
    bound_ms, bound_by = bound(rows_prefix * 8, rows_prefix * 14, 'float32')
    fwd_bound, _ = bound(sum(x.numel() for x in xs) * 8, sum(x.numel() for x in xs) * 14, 'float32')
    longest = max(x.shape[1] for x in xs)
    log(f'K3 prefix ({4 * BATCH} rows x {EMA_PREFIX}): kernel {ms_prefix:.3f} ms, plain {plain_ms:.1f} ms '
        f'(one run), bound {bound_ms:.4f} ms ({bound_by}); one forward\'s rows '
        f'({sum(x.numel() for x in xs)} samples, one launch): {ms_forward:.3f} ms, bound {fwd_bound:.4f} ms, '
        f'{1e6 * ms_forward / longest:.2f} ns per step of the longest row ({longest} samples)')
    call_prefix = cuda_ms(lambda: k3.ema_normalize(heads, fss, **args), reps=5, warmup=1, inner=10)
    line = dict(ms=ms_prefix, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call_ms=call_prefix, plain_call_ms=None, library_call_ms=None)
    return err_plain, line, ms_forward


@contextlib.contextmanager
def plain_convs(layers, k1):
    """Route the model's K1 / K2 convs to their plain versions, for an A/B
    of the same model on the same inputs."""
    layers.conv_k3, layers.conv_k3_stats = k1.conv_k3_reference, k1.conv_k3_stats_reference
    try:
        yield
    finally:
        layers.conv_k3, layers.conv_k3_stats = k1.conv_k3, k1.conv_k3_stats


@contextlib.contextmanager
def kernel_stats(bd, on: bool):
    bd.KERNEL_STATS = on
    try:
        yield
    finally:
        bd.KERNEL_STATS = None


def phase_model(torch, k1, k3, bd, layers, wav2sleep):
    """Goldens on the card, the full-width flagship on both conv paths, and
    the bf16 serving-size forward with kernel statistics off and on."""
    for name in ('wav2sleep_cardio', 'wav2sleep_eog'):
        data = np.load(os.path.join(ROOT, 'tests', 'goldens', f'{name}.npz'))
        cfg = json.loads(bytes(data['config_json']).decode())
        model = wav2sleep.build_wav2sleep(
            cfg['num_classes'], cfg['signal_map'], cfg['encoders'], cfg['epoch_mixer'], cfg['sequence_mixer']
        )
        model.load_state_dict({k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith('sd/')})
        model = model.cuda().eval()
        x = {k[3:]: torch.from_numpy(data[k]).cuda() for k in data.files if k.startswith('in/')}
        with torch.inference_mode():
            logits = model(x).cpu().numpy()
        err = float(np.abs(logits - data['logits']).max())
        log(f'golden {name}: max|d|={err:.3e} vs recorded logits (atol=rtol={GOLDEN_TOL:g})')
        np.testing.assert_allclose(logits, data['logits'], atol=GOLDEN_TOL, rtol=GOLDEN_TOL)

    model = wav2sleep.flagship_model(dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    S = 120  # one-hour nights
    g = torch.Generator(device='cuda').manual_seed(1)
    x = {c: torch.randn((2, grid_length(c, 1.0)), device='cuda', generator=g) for c in SIGNALS}
    x['PPG'][1] = -torch.inf  # an absent modality
    if sum(m.kernel_eligible for m in model.modules() if isinstance(m, layers.Conv1D)) != 80:
        raise AssertionError('expected 80 kernel-eligible convs in the flagship')
    with torch.inference_mode():
        zero_counts(k1, k3)
        kern = model(x)
        torch.cuda.synchronize()
        launches = counts(k1, k3)
        with plain_convs(layers, k1):
            zero_counts(k1, k3)
            plain = model(x)
            torch.cuda.synchronize()
            plain_launches = counts(k1, k3)
    err = float((kern - plain).abs().max())
    log(f'flagship f32 B=2 S={S}: logits {tuple(kern.shape)}, kernel vs plain max|d|={err:.3e} '
        f'(atol=rtol={MODEL_TOL:g}); launches per forward {launches} (plain path: {plain_launches})')
    if launches['K1'] != 80 or plain_launches['K1'] != 0 or launches['K2'] != 0:
        raise AssertionError(f'launches per forward {launches} (plain {plain_launches}), expected 80 K1 (0)')
    if kern.shape != (2, S, 4) or not bool(torch.isfinite(kern).all()):
        raise AssertionError('flagship logits have the wrong shape or are not finite')
    torch.testing.assert_close(kern, plain, atol=MODEL_TOL, rtol=MODEL_TOL)

    # Serving size, bf16: kernel statistics off and on.
    g = torch.Generator(device='cuda').manual_seed(2)
    xb = {c: torch.randn((BATCH, grid_length(c, HOURS)), device='cuda', generator=g).to(torch.bfloat16)
          for c in SIGNALS}
    out, seen = {}, {}
    with torch.inference_mode():
        for on in (False, True):
            with kernel_stats(bd, on):
                zero_counts(k1, k3)
                out[on] = model(xb)
                torch.cuda.synchronize()
                seen[on] = counts(k1, k3)
        ref32 = model({c: v.float() for c, v in xb.items()})
        times = {False: [], True: []}
        for on in (False, True, True, False):
            with kernel_stats(bd, on):
                times[on].append(cuda_ms(lambda: model(xb), reps=3, warmup=1))
    if seen[False] != {'K1': 80, 'K2': 0, 'K3': 0} or seen[True] != {'K1': 0, 'K2': 80, 'K3': 0}:
        raise AssertionError(f'launches per bf16 forward: stats off {seen[False]}, on {seen[True]}')
    d_stats = float((out[True] - out[False]).abs().max())
    d_bf16 = float((out[False] - ref32).abs().max())
    agree = float((out[True].argmax(-1) == out[False].argmax(-1)).float().mean())
    log(f'flagship bf16 B={BATCH} x {HOURS:g} h: kernel stats on vs off max|d logits|={d_stats:.3e} '
        f'(bound 2 x the forward\'s bf16-vs-f32 difference {d_bf16:.3e}), argmax agreement {agree:.5f}; '
        f'launches off {seen[False]}, on {seen[True]}; forward ms off '
        f'{", ".join(f"{t:.2f}" for t in times[False])}, on {", ".join(f"{t:.2f}" for t in times[True])} '
        f'(run off, on, on, off)')
    if not bool(torch.isfinite(out[True]).all()) or not d_stats <= 2 * d_bf16:
        raise AssertionError('kernel-statistics logits are not finite or not within the bound')
    return times


def mulaw_q8(wave: np.ndarray) -> tuple[np.ndarray, float]:
    """mu-law int8 codes of a finite row against its peak, and the peak: the
    q8 transport's encoding (``ops.q8_transport.encode_row_numpy``)."""
    from wav2sleep_tpu_torch.ops.q8_transport import encode_row_numpy

    codes, peak, _ = encode_row_numpy(wave)
    return codes, float(peak)


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


def check_hypnograms(out, names, n_epochs, what):
    if [fp for fp, _ in out] != names:
        raise AssertionError(f'{what}: nights missing from the output')
    for fp, hyp in out:
        if hyp.shape != (n_epochs,) or hyp.min() < 0 or hyp.max() > 3:
            raise AssertionError(f'{what}: bad hypnogram for {fp}: shape {hyp.shape}, range {hyp.min()}..{hyp.max()}')


def timed_passes(torch, pipe, names, passes):
    walls, out = [], None
    for _ in range(passes):
        t0 = time.perf_counter()
        out = list(pipe.run(names))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, out


def phase_serve_q8(torch, k1, k3, layers, wav2sleep, pipeline, card):
    t0 = time.time()
    nights = SyntheticQ8Nights(NIGHTS, HOURS, seed=0, absent={5: ('THX',)})
    log(f'serve q8: encoded {NIGHTS} nights of {HOURS:g} h on the host in {time.time() - t0:.1f} s (set-up)')
    model = wav2sleep.flagship_model(generator=torch.Generator().manual_seed(0))
    pipe = pipeline.StreamingPipelineQ8(
        model, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS, precision='bfloat16', extractor=nights,
    )
    pipe.warmup()
    names = sorted(nights.nights)
    torch.cuda.reset_peak_memory_stats()
    passes = 2
    zero_counts(k1, k3)
    walls, out = timed_passes(torch, pipe, names, passes)
    launches = counts(k1, k3)
    check_hypnograms(out, names, nights.n_epochs, 'serve q8')
    batches = passes * -(-NIGHTS // BATCH)
    if launches != {'K1': 80 * batches, 'K2': 0, 'K3': 0}:
        raise AssertionError(f'serve q8: launches {launches}, expected {80 * batches} K1')
    total = sum(walls)
    log(f'serve q8 bf16 batch {BATCH}: {passes} passes of {NIGHTS} nights x {HOURS:g} h in '
        f'{", ".join(f"{w:.3f}" for w in walls)} s: {passes * NIGHTS} nights in {total:.3f} s, '
        f'{3600 * passes * NIGHTS / total:.0f} recordings/hour on {card}; launches {launches}; '
        f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    # One batch's forward from the pooled pinned codes (H2D copy included),
    # kernel vs plain path.
    slot = pipe._slots[0]
    for i, fp in enumerate(names[:BATCH]):
        nights.extract_into(fp, slot.rows_np, slot.meta, i)
    times = {'kernel': [], 'plain': []}
    for path in ('kernel', 'plain', 'plain', 'kernel'):
        with plain_convs(layers, k1) if path == 'plain' else contextlib.nullcontext():
            times[path].append(cuda_ms(lambda: pipe._launch(slot), reps=5, warmup=1))
    log(f'forward q8 bf16 B={BATCH} x {HOURS:g} h from pinned codes: K1 path '
        f'{", ".join(f"{t:.2f}" for t in times["kernel"])} ms, plain path '
        f'{", ".join(f"{t:.2f}" for t in times["plain"])} ms (run kernel, plain, plain, kernel)')


def write_nights(folder: str, n_nights: int, hours: float, seed: int, absent: dict) -> list[str]:
    """Seeded EDF nights with MESA-like channels and rates (``EDF_CHANNELS``),
    written with the port's ``write_edf`` in 30-second records."""
    from wav2sleep_tpu_torch.data.edf import write_edf

    fps = []
    for i in range(n_nights):
        rng = np.random.default_rng(seed + i)
        sigs, rates, ranges = {}, {}, {}
        for label, (fs, (lo, hi)) in EDF_CHANNELS.items():
            if label in absent.get(i, ()):
                continue
            n = int(hours * 3600 * fs)
            t = np.arange(n, dtype=np.float32) / np.float32(fs)
            wave = np.sin(t * np.float32(rng.uniform(0.5, 8.0))) * np.float32(0.3 * hi)
            wave += rng.standard_normal(n, dtype=np.float32) * np.float32(0.05 * hi)
            sigs[label], rates[label], ranges[label] = wave, fs, (lo, hi)
        fp = os.path.join(folder, f'night{i:02d}.edf')
        write_edf(fp, sigs, rates, units={'ECG': 'mV'}, physical_ranges=ranges, record_duration=30.0)
        fps.append(fp)
    return fps


def phase_serve_f32(torch, k1, k3, bd, wav2sleep, pipeline, card, fps):
    """The f32 transport with causal normalization, host EDF decode in the
    loop; returns the launch counts of its main path and of the
    kernel-statistics configuration, and the hypnograms of the z-score
    pass."""
    n_epochs = int(round(HOURS * 120))
    model = wav2sleep.flagship_model(generator=torch.Generator().manual_seed(0))
    pipe = pipeline.StreamingPipeline(
        model, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS, precision='bfloat16',
        normalize='causal', device='cuda',
    )
    if pipe.decoder._lib is None:
        raise AssertionError('serve f32: the native host library is not in use')
    pipe.warmup()
    torch.cuda.reset_peak_memory_stats()
    passes, batches = 2, -(-NIGHTS // BATCH)
    pipe.fill_seconds = 0.0
    zero_counts(k1, k3)
    walls, out = timed_passes(torch, pipe, fps, passes)
    main = counts(k1, k3)
    check_hypnograms(out, fps, n_epochs, 'serve f32')
    if main != {'K1': 80 * passes * batches, 'K2': 0, 'K3': passes * batches}:
        raise AssertionError(f'serve f32: launches {main}')
    total = sum(walls)
    log(f'serve f32 causal bf16 batch {BATCH}: {passes} passes of {NIGHTS} EDF nights x {HOURS:g} h in '
        f'{", ".join(f"{w:.3f}" for w in walls)} s: {passes * NIGHTS} nights in {total:.3f} s, '
        f'{3600 * passes * NIGHTS / total:.0f} recordings/hour on {card}; producer decoding '
        f'{pipe.fill_seconds:.3f} s ({100 * pipe.fill_seconds / total:.1f}% of the wall); launches {main}; '
        f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    with kernel_stats(bd, True):
        pipe.fill_seconds = 0.0
        zero_counts(k1, k3)
        walls_s, out_s = timed_passes(torch, pipe, fps, 1)
        stats = counts(k1, k3)
    check_hypnograms(out_s, fps, n_epochs, 'serve f32, kernel statistics')
    if stats != {'K1': 0, 'K2': 80 * batches, 'K3': batches}:
        raise AssertionError(f'serve f32, kernel statistics: launches {stats}')
    agree = np.mean(np.concatenate([a == b for (_, a), (_, b) in zip(out, out_s)]))
    log(f'serve f32 causal, kernel statistics on: 1 pass in {walls_s[0]:.3f} s '
        f'({3600 * NIGHTS / walls_s[0]:.0f} recordings/hour); launches {stats}; epochs agreeing with '
        f'the statistics-off pass {agree:.5f}')

    zpipe = pipeline.StreamingPipeline(
        model, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS, precision='bfloat16',
        normalize='zscore', device='cuda',
    )
    zero_counts(k1, k3)
    out_z = list(zpipe.run(fps))
    check_hypnograms(out_z, fps, n_epochs, 'serve f32 zscore')
    log(f'serve f32 zscore: 1 untimed pass, {len(out_z)} valid hypnograms; launches {counts(k1, k3)}')
    return main, stats, out_z


def q4_witness(torch, pipeline, fps, card):
    """Where q4's disagreement comes from, on one batch of nights: the card's
    f32 decode (the model's z-scored input, captured) against a host f64
    decode of the same codes, and that f64 decode against the lossless q16
    codes' f64 z-score. A card error far below the codec's puts the blame on
    the codec; q16's card decode against its f64 one is the floor."""
    n_grid = {c: grid_length(c, HOURS) for c in SIGNALS}
    batch = fps[:BATCH]
    e16 = pipeline.Q16NightExtractor(list(SIGNALS), HOURS)
    e4 = pipeline.Q4NightExtractor(list(SIGNALS), n_grid, HOURS)
    q16 = {c: np.zeros((len(batch), n_grid[c]), np.int16) for c in SIGNALS}
    m16 = {c: np.zeros(len(batch), pipeline.Q16_META_DTYPE) for c in SIGNALS}
    q4 = {c: np.zeros((len(batch), pipeline.q4_row_len(n_grid[c])), np.uint8) for c in SIGNALS}
    m4 = {c: np.zeros(len(batch), pipeline.Q8_META_DTYPE) for c in SIGNALS}
    for i, fp in enumerate(batch):
        e16.extract_into(fp, q16, m16, i)
        e4.extract_into(fp, q4, m4, i)

    class Inputs(torch.nn.Module):
        """Keeps the model input; its logits are zeros."""

        def forward(self, x):
            self.x = {c: v.float().cpu().numpy() for c, v in x.items()}
            v = next(iter(x.values()))
            return v.new_zeros((v.shape[0], int(round(HOURS * 120)), 4))

    def card_inputs(fwd, rows, meta):
        dev = lambda d: {c: torch.from_numpy(np.ascontiguousarray(v)).cuda() for c, v in d.items()}  # noqa: E731
        fwd(dev(rows), *(dev({c: meta[c][f] for c in SIGNALS}) for f in meta[SIGNALS[0]].dtype.names))

    def zscore64(v, m):
        iot = np.arange(v.shape[1])[None, :]
        v = np.where(iot < m['n_valid'][:, None], v, 0.0)
        valid = iot < m['n_pad'][:, None]
        cnt = valid.sum(1, keepdims=True)
        mu = v.sum(1, keepdims=True) / np.maximum(cnt, 1)
        std = np.sqrt((np.where(valid, v - mu, 0.0) ** 2).sum(1, keepdims=True) / np.maximum(cnt - 1, 1))
        return np.where(valid, (v - mu) / np.maximum(std, 1e-6), np.nan)

    cap = Inputs()
    card_inputs(pipeline.make_streaming_forward_q4(cap, n_grid, 'float32', output='logits'), q4, m4)
    z4_card = cap.x
    card_inputs(pipeline.make_streaming_forward_q16(cap, 'float32', output='logits'), q16, m16)
    z16_card = cap.x
    for c in SIGNALS:
        n, r = n_grid[c], q4[c]
        mp, nbk = (n + 1) // 2, -(-n // pipeline.Q4_BLOCK)
        p = r[:, :mp].astype(np.int64)
        nib = np.stack([p & 0xF, p >> 4], axis=-1).reshape(len(batch), -1)[:, :n]
        step = np.repeat(pipeline._EXP8_SCALE[r[:, mp : mp + nbk]], pipeline.Q4_BLOCK, axis=1)[:, :n]
        dig = np.cumsum((1 - 2 * (nib >> 3)) * (nib & 7) * step, axis=1)
        z4 = zscore64(dig * m4[c]['a'][:, None].astype(np.float64) + m4[c]['b'][:, None], m4[c])
        z16 = zscore64(q16[c] * m16[c]['a'][:, None].astype(np.float64) + m16[c]['b'][:, None], m16[c])
        keep = m4[c]['present'][:, None] & np.isfinite(z4)
        if not keep.any():
            continue
        parts = {'q4 card f32 vs host f64, same codes': z4_card[c] - z4, 'q4 host f64 vs q16 (the codec)': z4 - z16,
                 'q16 card f32 vs host f64': z16_card[c] - z16}
        log(f'q4 witness {c} ({keep.sum()} samples of {int(m4[c]["present"].sum())} nights, z units): ' + '; '.join(
            f'{k} rms {np.sqrt(np.mean(d[keep] ** 2)):.3e} max {np.abs(d[keep]).max():.3e}' for k, d in parts.items())
            + f' on {card}')


def phase_serve_cli(torch, k1, k3, wav2sleep, pipeline, card, fps, out_z, work):
    """The serving CLI's path on the EDF nights ``fps``: a flagship
    checkpoint folder, ``load_model`` in bf16, the q16, q4 and raw
    pipelines timed, then the CLI itself; returns each transport's launch
    counts."""
    from wav2sleep_tpu_torch import api, checkpoint, serve
    from wav2sleep_tpu_torch.instantiate import target_config

    n_epochs = int(round(HOURS * 120))
    ckpt = os.path.join(work, 'checkpoint')
    cfg = wav2sleep.flagship_config()
    t0 = time.time()
    checkpoint.save_checkpoint_folder(
        ckpt, target_config(**cfg), wav2sleep.build_wav2sleep(**cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    )
    model = api.load_model(ckpt, precision='bfloat16')
    if {p.dtype for p in model.parameters()} != {torch.bfloat16} or next(model.parameters()).device.type != 'cuda':
        raise AssertionError('serve cli: load_model did not give bf16 parameters on the card')
    log(f'serve cli: checkpoint folder written and loaded (bf16, on the card) in {time.time() - t0:.1f} s (set-up)')
    zscore = dict(out_z)
    passes, batches = 2, -(-NIGHTS // BATCH)
    g = torch.Generator(device='cuda').manual_seed(3)
    xb = {c: torch.randn((BATCH, grid_length(c, HOURS)), device='cuda', generator=g).to(torch.bfloat16)
          for c in SIGNALS}
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: model(xb), reps=3, warmup=1)
    del xb
    launches, hyps = {}, {}
    for name, cls in (('q16', pipeline.StreamingPipelineQ16), ('q4', pipeline.StreamingPipelineQ4),
                      ('raw', pipeline.StreamingPipelineRaw)):
        pipe = cls(model, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS, precision='bfloat16')
        if name == 'raw':
            pipe.warmup(fps[0])  # the raw rows ship the EDF's samples: no native host kernel
        else:
            if pipe.extractor._lib is None:
                raise AssertionError(f'serve {name}: the native host library is not in use')
            pipe.warmup()
        torch.cuda.reset_peak_memory_stats()
        pipe.fill_seconds = 0.0
        zero_counts(k1, k3)
        walls, out = timed_passes(torch, pipe, fps, passes)
        launches[name] = counts(k1, k3)
        check_hypnograms(out, fps, n_epochs, f'serve {name}')
        if launches[name] != {'K1': 80 * passes * batches, 'K2': 0, 'K3': 0}:
            raise AssertionError(f'serve {name}: launches {launches[name]}, expected {80 * passes * batches} K1')
        agree = np.mean(np.concatenate([hyp == zscore[fp] for fp, hyp in out]))
        total = sum(walls)
        log(f'serve {name} bf16 batch {BATCH} (load_model): {passes} passes of {NIGHTS} EDF nights x {HOURS:g} h in '
            f'{", ".join(f"{w:.3f}" for w in walls)} s: {passes * NIGHTS} nights in {total:.3f} s, '
            f'{3600 * passes * NIGHTS / total:.0f} recordings/hour on {card}; producer filling '
            f'{pipe.fill_seconds:.3f} s ({100 * pipe.fill_seconds / total:.1f}% of the wall); launches '
            f'{launches[name]}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
            f'epochs agreeing with the f32 z-score pass {agree:.5f}')
        # One batch from the slot's pinned rows (the last batch served):
        # H2D copy, the transport's decode and the forward.
        batch_ms = cuda_ms(lambda: pipe._launch(pipe._slots[0]), reps=3, warmup=1)
        log(f'serve {name}: one batch from pinned rows (copy, decode, forward) {batch_ms:.2f} ms, the forward '
            f'alone on bf16 rows {forward_ms:.2f} ms ({100 * (batch_ms - forward_ms) / batch_ms:.1f}% copy and '
            f'decode) on {card}')
        hyps[name] = dict(out)
        del pipe

    out_dir = os.path.join(work, 'preds')
    t0 = time.time()
    serve.main(['--input-folder', os.path.dirname(fps[0]), '--output-folder', out_dir, '--model-folder', ckpt,
                '--batch-size', str(BATCH), '--max-length-hours', str(HOURS)])
    wall = time.time() - t0
    for fp in fps:
        csv = os.path.join(out_dir, os.path.splitext(os.path.basename(fp))[0] + '.preds.csv')
        with open(csv) as f:
            lines = f.read().splitlines()
        if lines[0] != 'Timestamp,Pred' or len(lines) != 1 + n_epochs:
            raise AssertionError(f'serve cli: {csv} has {len(lines) - 1} rows, expected {n_epochs}')
        pred = np.array([int(line.rsplit(',', 1)[1]) for line in lines[1:]])
        if not np.array_equal(pred, hyps['q16'][fp]):
            raise AssertionError(f'serve cli: {csv} differs from the q16 pass\'s hypnogram')
    log(f'serve cli: python -m wav2sleep_tpu_torch.serve (q16, bf16, the card) wrote {len(fps)} CSV files of '
        f'{n_epochs} rows equal to the q16 pass\'s hypnograms in {wall:.1f} s (model load and one pass) on {card}')

    # Every other --transport, and q16 and q4 in float32 (TF32 off in their
    # forwards): q4 against q16 in f32 is the codec's agreement without bf16.
    preds = {}
    for transport, precision in (('q8', 'bfloat16'), ('q4', 'bfloat16'), ('raw', 'bfloat16'), ('f32', 'bfloat16'),
                                 ('q16', 'float32'), ('q4', 'float32')):
        out = os.path.join(work, f'preds_{transport}_{precision}')
        t0 = time.time()
        serve.main(['--input-folder', os.path.dirname(fps[0]), '--output-folder', out, '--model-folder', ckpt,
                    '--transport', transport, '--precision', precision, '--batch-size', str(BATCH),
                    '--max-length-hours', str(HOURS)])
        wall = time.time() - t0
        same = total = 0
        for fp in fps:
            csv = os.path.splitext(os.path.basename(fp))[0] + '.preds.csv'
            with open(os.path.join(out, csv)) as f:
                lines = f.read().splitlines()
            pred = np.array([int(line.rsplit(',', 1)[1]) for line in lines[1:]])
            if lines[0] != 'Timestamp,Pred' or pred.shape != (n_epochs,) or pred.min() < 0 or pred.max() > 3:
                raise AssertionError(f'serve cli --transport {transport} --precision {precision}: bad {csv}')
            same += int((pred == hyps['q16'][fp]).sum())
            total += n_epochs
            preds[transport, precision, fp] = pred
        log(f'serve cli --transport {transport} --precision {precision}: {len(fps)} CSV files of {n_epochs} valid '
            f'rows in {wall:.1f} s; epochs equal to the default run {same / total:.5f}')
    for precision in ('bfloat16', 'float32'):
        agree = np.mean([preds['q4', precision, fp] == (hyps['q16'][fp] if precision == 'bfloat16' else
                                                          preds['q16', precision, fp]) for fp in fps])
        log(f'serve cli: q4 against q16, both --precision {precision}: epochs equal {agree:.5f}')
    q4_witness(torch, pipeline, fps, card)
    return launches


# Phase 10's shape: scripts/profile_pallas_variants.py's, K1's hot shape
# (B = 8 ten-hour nights of 16 channels at 1,228,800 samples, 128 lanes).
VARIANT_B, VARIANT_NB, VARIANT_TB = 8, 153_600, 2048
VARIANT_REPLACES = {'copy': 79, 'mm1f': 85, 'mm3': 93, 'mm3s': 106, 'v7': 136}
# Each rung's kernel by a part of its mangled name, and the SASS opcodes
# that prove its route, each with the count it must have (None: at least
# one): V2, V3, V4 and V7 (csrc/conv_variants_wgmma.cuh) wgmma (HGMMA), TMA
# loads (UTMALDG) and stores (UTMASTG), V7 with V3's 24 wgmma k-steps on
# its one path (the three taps read one window); V0 (csrc/conv_variants.cu)
# one 16-byte load and one store (LDG.E.128, STG.E.128), a vector per
# thread and no loop.
WGMMA_OPCODES = dict.fromkeys(('HGMMA', 'UTMALDG', 'UTMASTG'))
SASS_EVIDENCE = {'copy': ('copy_kernel', {'LDG.E.128': 1, 'STG.E.128': 1}),
                 'mm1f': ('mm_wgmma_kernelILi1E', WGMMA_OPCODES), 'mm3': ('mm_wgmma_kernelILi3E', WGMMA_OPCODES),
                 'mm3s': ('mm_wgmma_kernelILi4E', WGMMA_OPCODES),
                 'v7': ('v7_wgmma_kernel', {**WGMMA_OPCODES, 'HGMMA': 24})}
VARIANT_SOURCES = {'copy': 'conv_variants.cu', 'mm1f': 'conv_variants_wgmma.cuh', 'mm3': 'conv_variants_wgmma.cuh',
                   'mm3s': 'conv_variants_wgmma.cuh', 'v7': 'conv_variants_wgmma.cuh'}


def sass_evidence(cv, cuda_build) -> dict:
    """Per wrapper of the ladder: its kernel's counts of the opcodes of
    its route in the SASS of the built library and ptxas's registers and
    spilled bytes; raises unless each kernel has every opcode of its route,
    as many times as the route says."""
    opcodes = sorted({op for _, ops in SASS_EVIDENCE.values() for op in ops})
    counts = cuda_build.sass_counts(cuda_build.sass(cuda_build.library_path('conv_variants.cu')), opcodes)
    ptxas = cuda_build.ptxas_report(cv.BUILD_LOG)
    evidence = {}
    for name, (key, route) in SASS_EVIDENCE.items():
        found = [fn for fn in counts if key in fn]
        if len(found) != 1 or found[0] not in ptxas:
            raise AssertionError(f'variants: no single {key} kernel in the SASS ({found}) with a ptxas report')
        fn, ops = found[0], {op: counts[found[0]][op] for op in route}
        if min(ops.values()) < 1:
            raise AssertionError(f'variants: {name}\'s kernel lacks an opcode of its route in its SASS: {ops}')
        exact = {op: want for op, want in route.items() if want is not None}
        if any(ops[op] != want for op, want in exact.items()):
            raise AssertionError(f'variants: {name}\'s kernel has {ops} in its SASS; its route needs {exact}')
        evidence[name] = {**{f'sass_{op.lower().replace(".", "_")}': n for op, n in ops.items()},
                          'registers': ptxas[fn]['registers'], 'spill_bytes': ptxas[fn]['spill_bytes']}
        log(f'variants: {name} kernel {fn}: SASS ' + ', '.join(f'{op} {n}' for op, n in ops.items())
            + f'; ptxas {ptxas[fn]["registers"]} registers, {ptxas[fn]["spill_bytes"]} bytes spilled')
    return evidence


def variant_library_calls(torch, F, x, w, tb):
    """One PyTorch call of each rung's function on x [B, nb, 128] and W:
    name -> (the call, its output back in x's layout). V3's einsum contracts
    the tap axis, which only W has, first: x @ bf16(W0 + W1 + W2). V4 is a
    zero-padded conv of each tile of tb rows, the tiles a batch of a
    [B * nb / tb, 128, tb] view. V7 with true halos is the conv over all nb
    rows. The views are free; cuDNN copies them to its layout in the call."""
    B, nb, D = x.shape
    w_oik = w.permute(2, 1, 0).contiguous()
    y = torch.empty_like(x)
    tiles = x.view(B * nb // tb, tb, D).transpose(1, 2)
    return {
        'copy': (lambda: y.copy_(x), lambda out: out),
        'mm1f': (lambda: torch.matmul(x, w[0]), lambda out: out),
        'mm3': (lambda: torch.einsum('bnc,kco->bno', x, w), lambda out: out),
        'mm3s': (lambda: F.conv1d(tiles, w_oik, None, padding=1),
                 lambda out: out.transpose(1, 2).reshape(B, nb, D)),
        'v7': (lambda: F.conv1d(x.transpose(1, 2), w_oik, None, padding=1), lambda out: out.transpose(1, 2)),
    }


def phase_variants(torch, F, k1, cv, cuda_build, profile_variants):
    """Phase 10: the K1 bisection ladder; returns its kernels-line entries."""
    B, nb, tb, D = VARIANT_B, VARIANT_NB, VARIANT_TB, cv.D
    evidence = sass_evidence(cv, cuda_build)
    x, w = profile_variants.inputs(B, nb, 'cuda')
    cv.LAUNCHES.update(dict.fromkeys(cv.NAMES, 0))
    prof = profile_variants.run(B, nb, tb, xw=(x, w))
    launches = dict(cv.LAUNCHES)
    if min(launches.values()) < 1:
        raise AssertionError(f'variants: profile_variants.run did not launch every kernel: {launches}')
    log(f'variants: profile_variants.run at x [{B}, {nb}, {D}] bf16, tb {tb}: launches {launches}; V7 with true '
        f'halos against K1 (conv_k3 128->128 s1) in it: max|d| {prof["v7_vs_k1_max_abs_err"]:.3e} '
        f'(<=2^-6(|y|+rms)) ok')

    w0 = w[0]
    n_halo = nb // tb * 8
    gen = torch.Generator(device='cuda').manual_seed(10)
    halos = {
        'zero': (torch.zeros((B, n_halo, D), dtype=torch.bfloat16, device='cuda'),) * 2,
        'random': tuple(torch.randn((B, n_halo, D), device='cuda', generator=gen).bfloat16() for _ in range(2)),
        'true': cv.true_halos(x, tb),
    }
    xp, xn = halos['true']
    lib_calls = variant_library_calls(torch, F, x, w, tb)
    # name -> (kernel, plain version)
    calls = {
        'copy': (lambda: cv.copy(x, tb), lambda: cv.copy_reference(x, tb)),
        'mm1f': (lambda: cv.mm1f(x, w0, tb), lambda: cv.mm1f_reference(x, w0, tb)),
        'mm3': (lambda: cv.mm3(x, w, tb), lambda: cv.mm3_reference(x, w, tb)),
        'mm3s': (lambda: cv.mm3s(x, w, tb), lambda: cv.mm3s_reference(x, w, tb)),
        'v7': (lambda: cv.v7(x, xp, xn, w, tb), lambda: cv.v7_reference(x, xp, xn, w, tb)),
    }

    errs = {}
    for name, (kernel, plain) in calls.items():
        cases = {'': (kernel, plain)}
        if name == 'v7':
            cases = {f' {h} halos': ((lambda p=p, n=n: cv.v7(x, p, n, w, tb)),
                                     (lambda p=p, n=n: cv.v7_reference(x, p, n, w, tb)))
                     for h, (p, n) in halos.items()}
        errs[name] = 0.0
        for label, (k_fn, p_fn) in cases.items():
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                raise AssertionError(f'variants: {name}{label} gives {tuple(got.shape)} {got.dtype}')
            if name == 'copy':
                ok, err = torch.equal(got, want), float((got.float() - want.float()).abs().max())
            else:
                ok, err = cv.agree(got, want, BF16_TOL)
            if not ok:
                raise AssertionError(f'variants: {name}{label} disagrees with its plain version (max |d| {err:.3e})')
            errs[name] = max(errs[name], err)
            log(f'variants: {name}{label} against its plain version: max|d| {err:.3e} '
                f'({"bit for bit" if name == "copy" else "<=2^-6(|y|+rms)"}) ok')
            del got, want
        lib, lib_y = lib_calls[name]
        same, err = cv.agree(lib_y(lib()), plain(), BF16_TOL)
        if not same:
            raise AssertionError(f'variants: the library call is not the function of {name} (max |d| {err:.3e})')
        log(f'variants: {name}\'s library call against its plain version: max|d| {err:.3e} (<=2^-6(|y|+rms)) ok')
    torch.cuda.empty_cache()

    entries, times = [], {}
    for name, (kernel, plain) in calls.items():
        taps = {'copy': 0, 'mm1f': 1}.get(name, 3)
        n_bytes = 2 * (2 * B * nb * D + taps * D * D + (2 * B * n_halo // 8 * D if name == 'v7' else 0))
        bound_ms, bound_by = bound(n_bytes, 2 * B * nb * D * D * taps, 'bfloat16')
        ms, plain_ms = both_ms(kernel), both_ms(plain)
        lib_ms = both_ms(lib_calls[name][0])
        times[name] = ms
        log(f'variants: {name} ({"true halos" if name == "v7" else "x " + str(list(x.shape))}): ms one call '
            f'(back to back): kernel {fmt(ms)}, plain {fmt(plain_ms)}, library {fmt(lib_ms)}, '
            f'bound {bound_ms:.4f} ({bound_by}), {100 * bound_ms / ms[0]:.1f}% ({100 * bound_ms / ms[1]:.1f}%) '
            f'of the bound')
        entries.append(dict(
            name=f'conv_variants.{name}', route='cuda',
            source='wav2sleep_tpu_torch/csrc/' + VARIANT_SOURCES[name],
            replaces=f'scripts/profile_pallas_variants.py:{VARIANT_REPLACES[name]}', launches=launches[name],
            max_abs_err=errs[name], ms=ms[0], plain_ms=plain_ms[0], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms[0], call_ms=ms[1], plain_call_ms=plain_ms[1], library_call_ms=lib_ms[1],
            **evidence.get(name, {})))
    times['k1'] = both_ms(lambda: k1.conv_k3(x, w))
    log(f'variants: K1 (conv_k3 128->128 s1) on the same x and W: {fmt(times["k1"])} ms one call (back to back)')
    for a, b in (('mm1f', 'copy'), ('mm3', 'mm1f'), ('mm3s', 'mm3'), ('v7', 'mm3'), ('v7', 'mm3s'), ('k1', 'v7')):
        log(f'variants: gap {a} - {b}: {times[a][0] - times[b][0]:+.4f} ms one call, '
            f'{times[a][1] - times[b][1]:+.4f} ms back to back')
    log('variants: profile_variants marginal ms: ' + ', '.join(
        f'{key} {prof[key]:.4f}' for key in ('copy_ms', 'mm1_f32acc_ms', 'mm3_ms', 'mm3_shift_ms', 'v7_full_ms',
                                             'k1_ms', 'conv1d_ms', 'bound_ms')))
    return entries


TRAIN_HOURS = 10.0
# The config's default batch (scripts/config/main.yaml) in f32; bf16 at the
# serving batch.
TRAIN_BATCH_F32, TRAIN_BATCH_BF16 = 16, 8
TRAIN_K, TRAIN_REPS = 4, 2  # chained steps of a marginal timing, repetitions
# Step 1, kernel path vs plain path: loss, gradient norm and each
# parameter's gradient, relative. The two read alike to the bit where K1's
# f32 output equals F.conv1d's (phase 1 prints max|d| per flagship shape):
# the backward of both paths is autograd of the plain version.
TRAIN_TOL = 5e-4
TRAIN_SEED = 11
# The card's q8 decode against the CPU's, in f32 ulps: torch's CUDA and
# CPU expm1 differ, and the decode rounds twice more after it.
Q8_DECODE_ULPS = 2


def max_ulps(got, want) -> float:
    """The largest |got - want| in f32 ulps of ``want`` over its finite
    values; raises unless the non-finite values are the same."""
    finite = want.isfinite()
    if not bool((got.isfinite() == finite).all()) or not bool((got[~finite] == want[~finite]).all()):
        raise AssertionError('the decodes differ outside the finite values')
    b = want[finite].abs()
    ulp = (b.nextafter(b.new_full(b.shape, float('inf'))) - b).double()
    return float(((got[finite].double() - want[finite].double()).abs() / ulp).max())


def phase_train(torch, k1, k3, bd, layers, train_bench, q8, tf32_defaults):
    """Phase 11: the training step on full nights, under torch's default TF32
    flags. (a) f32 at the config's batch, remat on, EMA off: step 1 on the
    kernel path against the plain path, then timed chained steps; (b) bf16 at
    batch 8 through ``train_bench.run``, lossless (compute and e2e) and on a
    q8 batch encoded up front (compute; the card's decode against the CPU's);
    (c) kernel statistics off against on, step 1 and step times. Returns the
    ``train`` line and the K1 and K2 launches per step."""
    S = int(round(TRAIN_HOURS * 120))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    try:
        out = {'tf32_flags': {'cudnn': tf32_defaults[0], 'matmul': tf32_defaults[1]}}
        # (a) The config's step, f32.
        x, y = train_bench.example_batch(TRAIN_BATCH_F32, S, seed=TRAIN_SEED)
        first, moments, main = {}, {}, None
        for path in ('kernel', 'plain'):
            s = train_bench.build('float32', device='cuda', remat=True, ema=False)
            batch = train_bench.device_batch(x, y, 'lossless', torch.float32, s.device)
            torch.cuda.reset_peak_memory_stats()
            with plain_convs(layers, k1) if path == 'plain' else contextlib.nullcontext():
                zero_counts(k1, k3)
                _, m = s.step(s.state, batch, TRAIN_SEED)
                torch.cuda.synchronize()
                first[path] = dict(loss=float(m['loss']), grad_norm=float(m['grad_norm']), launches=counts(k1, k3),
                                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            # Adam's first moment after step 1: 0.1 of the clipped gradient.
            moments[path] = [mu.cpu() for mu in s.state.opt_state.mu]
            if path == 'kernel':
                main = (s, batch)
            del s, batch, m
        rel = {key: abs(first['kernel'][key] - first['plain'][key]) / abs(first['plain'][key])
               for key in ('loss', 'grad_norm')}
        rel['gradients'] = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                               for a, b in zip(moments['kernel'], moments['plain']))
        log(f'train f32 B={TRAIN_BATCH_F32} x {TRAIN_HOURS:g} h (remat, masker, flip, torch\'s default TF32 flags): '
            f'step 1 kernel path {first["kernel"]}, plain path {first["plain"]}; relative differences loss '
            f'{rel["loss"]:.3e}, gradient norm {rel["grad_norm"]:.3e}, per-parameter gradients (max |d| over the '
            f'largest |g|, {len(moments["plain"])} parameters) {rel["gradients"]:.3e} (bound {TRAIN_TOL:g})')
        del moments
        if not max(rel.values()) <= TRAIN_TOL:
            raise AssertionError(f'train f32: the kernel path\'s step 1 disagrees with the plain path: {rel}')
        if first['kernel']['launches'] != {'K1': 160, 'K2': 0, 'K3': 0} or first['plain']['launches']['K1'] != 0:
            raise AssertionError(f'train f32: launches per step {first["kernel"]["launches"]} (plain '
                                 f'{first["plain"]["launches"]}), expected 160 K1 (0)')
        s, batch = main
        torch.cuda.reset_peak_memory_stats()
        zero_counts(k1, k3)
        ms_k, _ = train_bench.chain_ms(s, batch, TRAIN_K, TRAIN_SEED)
        chained = counts(k1, k3)
        if chained != {'K1': 160 * TRAIN_K, 'K2': 0, 'K3': 0}:
            raise AssertionError(f'train f32: launches over {TRAIN_K} chained steps {chained}, expected 160 K1 a step')
        per_step = {k: v // TRAIN_K for k, v in chained.items()}
        compute = train_bench.compute_ms(s, batch, TRAIN_K, TRAIN_REPS)
        del batch
        e2e = train_bench.e2e_ms(s, x, y, 'lossless', TRAIN_K, TRAIN_REPS)
        out['f32'] = dict(batch=TRAIN_BATCH_F32, hours=TRAIN_HOURS, remat=True, step1=first, step1_rel_diff=rel,
                          chain_ms=ms_k, compute_ms_per_step=compute, e2e_ms_per_step=e2e,
                          nights_per_hour_e2e=TRAIN_BATCH_F32 / e2e * 3.6e6, launches_per_step=per_step,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f'train f32 B={TRAIN_BATCH_F32}: {TRAIN_K} chained steps {ms_k:.1f} ms, compute {compute:.1f} ms/step, '
            f'e2e {e2e:.1f} ms/step ({out["f32"]["nights_per_hour_e2e"]:.0f} nights/hour); launches per step '
            f'{per_step}; peak device memory {out["f32"]["peak_gib"]:.2f} GiB')
        del s, main
        torch.cuda.empty_cache()

        # (b) bf16 at batch 8, lossless and q8, through the bench.
        for transport in ('lossless', 'q8'):
            r = train_bench.run(batch=TRAIN_BATCH_BF16, epochs_per_night=S, precision='bfloat16', transport=transport,
                                k=TRAIN_K, reps=TRAIN_REPS, device='cuda', e2e=transport == 'lossless')
            if (r['k1_launches_per_step'], r['k2_launches_per_step']) != (160, 0):
                raise AssertionError(f'train bf16 {transport}: launches per step {r}')
            out[f'bf16_{transport}'] = r
            log(f'train bf16 {transport}: {json.dumps(r)}')
            torch.cuda.empty_cache()
        xb, yb = train_bench.example_batch(TRAIN_BATCH_BF16, S)  # (b)'s batch
        codes = q8.encode_batch(xb)
        card = q8.dequant_batch({k: tuple(torch.from_numpy(a).cuda() for a in v) for k, v in codes.items()})
        host = q8.dequant_batch({k: tuple(torch.from_numpy(a) for a in v) for k, v in codes.items()})
        ulps = max(max_ulps(card[k].cpu(), host[k]) for k in host)
        out['bf16_q8']['decode_max_ulps_vs_cpu'] = ulps
        log(f'train q8: the card\'s decode of {TRAIN_BATCH_BF16} nights against the CPU\'s: max {ulps:g} f32 ulps '
            f'(bound {Q8_DECODE_ULPS})')
        if not ulps <= Q8_DECODE_ULPS:
            raise AssertionError(f'train q8: the card\'s decode is {ulps} ulps from the CPU\'s')
        del card, host, codes

        # (c) Kernel statistics off and on: step 1 on (b)'s initial state,
        # batch and seed (and the same step in f32 for the bf16 error), then
        # step times.
        losses, norms, setups = {}, {}, {}
        for name, precision, on in (('f32', 'float32', False), ('off', 'bfloat16', False), ('on', 'bfloat16', True)):
            s = train_bench.build(precision, device='cuda', remat=True)
            batch = train_bench.device_batch(xb, yb, 'lossless', s.dtype, s.device)
            with kernel_stats(bd, on):
                zero_counts(k1, k3)
                m = s.step(s.state, batch, 0)[1]  # (b)'s seed
                losses[name], norms[name] = float(m['loss']), float(m['grad_norm'])
                seen = counts(k1, k3)
            want = {'K1': 0, 'K2': 160, 'K3': 0} if on else {'K1': 160, 'K2': 0, 'K3': 0}
            if seen != want:
                raise AssertionError(f'train bf16, kernel statistics {name}: launches per step {seen}, expected {want}')
            if on:
                stats_per_step = seen
            if name != 'f32':
                setups[name] = (s, batch)
            del s, batch
        bounds = {key: 2 * max(abs(v['off'] - v['f32']), 2.0**-8 * abs(v['f32']))
                  for key, v in (('loss', losses), ('grad_norm', norms))}
        times = {'off': [], 'on': []}
        for name in ('off', 'on', 'on', 'off'):
            with kernel_stats(bd, name == 'on'):
                times[name].append(train_bench.compute_ms(*setups[name], TRAIN_K, TRAIN_REPS))
        out['bf16_kernel_stats'] = dict(step1_loss=losses, step1_grad_norm=norms, launches_per_step_on=stats_per_step,
                                        compute_ms_per_step=times)
        log(f'train bf16 B={TRAIN_BATCH_BF16}, kernel statistics: step 1 loss off {losses["off"]:.6f}, on '
            f'{losses["on"]:.6f}, f32 {losses["f32"]:.6f}; |on - off| {abs(losses["on"] - losses["off"]):.3e} (bound '
            f'{bounds["loss"]:.3e}); gradient norm off {norms["off"]:.6f}, on {norms["on"]:.6f}, f32 '
            f'{norms["f32"]:.6f}; |on - off| {abs(norms["on"] - norms["off"]):.3e} (bound {bounds["grad_norm"]:.3e}); '
            'bounds: twice the larger of |bf16 - f32| and 2^-8 |f32|; compute ms/step off '
            f'{", ".join(f"{t:.1f}" for t in times["off"])}, on {", ".join(f"{t:.1f}" for t in times["on"])} '
            '(run off, on, on, off)')
        for key, v in (('loss', losses), ('grad_norm', norms)):
            if not abs(v['on'] - v['off']) <= bounds[key]:
                raise AssertionError(f'train bf16: the kernel-statistics step 1 {key} is outside the bf16 bound')
        del setups
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return out, per_step['K1'], stats_per_step['K2']


# Phase 12: the other model families. SleepPPG-Net as scripts/config/model/
# ppgnet.yaml gives it (4 classes) at the config's f32 batch.
PPGNET_CFG = {'_target_': 'wav2sleep.models.ppgnet.SleepPPGNet', 'n_classes': 4, 'norm': 'batch',
              'feature_dim': 128, 'activation': 'leaky', 'dropout': 0.2, 'remat': True}
PPGNET_BATCH, PPGNET_SERVE_BATCH = 16, 8
FAMILY_K, FAMILY_REPS = 3, 2  # chained steps of a marginal timing, repetitions
FAMILY_SEED = 13
# bf16 SleepPPG-Net logits (parameters and running statistics cast by
# load_model) against the f32 eval logits: |bf16 - f32| <= FAMILY_BF16_TOL
# * (max |f32| + rms(f32)). 2**-8 is one bf16 rounding of a unit value;
# the forward has 58 layers, each rounding its output once.
FAMILY_BF16_TOL = 2.0**-3
FAMILY_F32_TOL = 5e-4  # f32 logits, atol and rtol (PERF.md §2)


def family_config(wav2sleep, causal: bool, chunk_causal: bool, enc_norm: str = 'instance',
                  seq_norm: str | None = 'layer', norm_first: bool = True) -> dict:
    """``build_wav2sleep``'s arguments of the flagship at full width with
    ``causal`` encoders and sequence mixer (scripts/config/model/
    wav2sleep.yaml with ``causal: true``); ``seq_norm`` None is the JAX
    package's default, batch norm."""
    cfg = wav2sleep.flagship_config()
    cfg['encoders'].update(causal=causal, chunk_causal=chunk_causal, norm=enc_norm)
    cfg['sequence_mixer'].update(causal=causal, norm=seq_norm or 'batch')
    cfg['epoch_mixer']['norm_first'] = norm_first
    return cfg


def phase_families(torch, k1, k3, wav2sleep, pipeline, train_bench, card, fps, work, tf32_defaults):
    """Phase 12: (a) SleepPPG-Net's training step at f32 B=16 x 10 h under
    torch's default TF32 flags, remat on against off, chained steps, the
    eval step, and a bf16 checkpoint forward; (b) the causal flagship served
    f32 with causal normalization on the EDF nights, and causality on the
    card; (c) a chunk-causal flagship with a batch-norm sequence mixer and a
    post-norm epoch mixer from a checkpoint folder in bf16. Returns the
    ``families`` line and K3's launches on (b)'s path."""
    from wav2sleep_tpu_torch import api, checkpoint, instantiate
    from wav2sleep_tpu_torch.models.ppgnet import SleepPPGNet, build_ppgnet
    from wav2sleep_tpu_torch.train import step as tstep
    from wav2sleep_tpu_torch.train.metrics import cross_entropy_ignore_index
    from wav2sleep_tpu_torch.utils import full_f32

    t_phase = time.time()
    dev = torch.device('cuda')
    n_epochs = int(round(HOURS * 120))
    out = {}

    # (a) SleepPPG-Net, f32, the config's batch, under torch's default flags.
    rng = np.random.default_rng(FAMILY_SEED)
    x = torch.from_numpy(rng.normal(size=(PPGNET_BATCH, SleepPPGNet.INPUT_LENGTH)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(-1, 4, size=(PPGNET_BATCH, n_epochs)).astype(np.float32)).to(dev)
    kwargs = {k: v for k, v in PPGNET_CFG.items() if k != '_target_'}

    def setup(remat: bool):
        model = build_ppgnet(torch.Generator().manual_seed(0), **{**kwargs, 'remat': remat}).to(dev)
        opt = tstep.make_optimizer(1e-3, weight_decay=1e-4, grad_clip=1.0)
        state = tstep.init_train_state(model, opt, ema=True)
        step = tstep.make_train_step(model, opt, 4, flip_polarity=True, ema_decay=0.9999, family='ppgnet')
        return model, train_bench.Setup(state, step, dev, torch.float32)

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    try:
        first = {}
        for remat in (False, True):
            model, s = setup(remat)
            torch.cuda.reset_peak_memory_stats()
            zero_counts(k1, k3)
            _, m = s.step(s.state, ({'PPG': x}, y), FAMILY_SEED)
            torch.cuda.synchronize()
            first[remat] = dict(loss=float(m['loss']), grad_norm=float(m['grad_norm']), launches=counts(k1, k3),
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                mu=[mu.cpu() for mu in s.state.opt_state.mu],
                                stats={k: v.cpu().clone() for k, v in s.state.batch_stats.items()})
            if not remat:
                del model, s, m
                torch.cuda.empty_cache()
        off, on = first[False], first[True]
        rel = {key: abs(on[key] - off[key]) / abs(off[key]) for key in ('loss', 'grad_norm')}
        rel['gradients'] = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                               for a, b in zip(on['mu'], off['mu']))
        rel['running_stats'] = max(float((on['stats'][k].float() - v.float()).abs().max() / v.float().abs().max())
                                   for k, v in off['stats'].items() if not k.endswith('num_batches_tracked'))
        tracked = {int(v) for k, v in on['stats'].items() if k.endswith('num_batches_tracked')}
        log(f'families (a) SleepPPG-Net f32 B={PPGNET_BATCH} x {HOURS:g} h (flip, dropout 0.2, torch\'s default TF32 '
            f'flags): step 1 remat off loss {off["loss"]:.6f}, gradient norm {off["grad_norm"]:.4f}, peak '
            f'{off["peak_gib"]:.2f} GiB; remat on {on["loss"]:.6f}, {on["grad_norm"]:.4f}, {on["peak_gib"]:.2f} GiB; '
            f'relative differences {rel} (bound {TRAIN_TOL:g}); batch norms updated {tracked} time(s); launches '
            f'{on["launches"]}')
        if not max(rel.values()) <= TRAIN_TOL:
            raise AssertionError(f'families (a): remat on and off disagree at step 1: {rel}')
        if tracked != {1}:
            raise AssertionError(f'families (a): running statistics updated {tracked} times in one step')
        if on['launches'] != {'K1': 0, 'K2': 0, 'K3': 0} or off['launches'] != on['launches']:
            raise AssertionError(f'families (a): SleepPPG-Net launched {on["launches"]}, {off["launches"]}')
        torch.cuda.reset_peak_memory_stats()
        zero_counts(k1, k3)
        chain, metrics = train_bench.chain_ms(s, ({'PPG': x}, y), FAMILY_K, FAMILY_SEED)
        compute = train_bench.compute_ms(s, ({'PPG': x}, y), FAMILY_K, FAMILY_REPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        chained = counts(k1, k3)
        losses = [float(mm['loss']) for mm in metrics]
        evaluate = tstep.make_eval_step(model, 4, 'ppgnet')
        ev = evaluate(s.state.params, ({'PPG': x}, y))
        ev_ema = evaluate(s.state.ema_params, ({'PPG': x}, y))
        with torch.inference_mode(), full_f32():
            want = model.eval()(x[:PPGNET_SERVE_BATCH]).float()
        out['ppgnet'] = dict(batch=PPGNET_BATCH, hours=HOURS, step1={'remat_off': {k: off[k] for k in (
            'loss', 'grad_norm', 'peak_gib')}, 'remat_on': {k: on[k] for k in ('loss', 'grad_norm', 'peak_gib')}},
            step1_rel_diff=rel, chain_ms=chain, compute_ms_per_step=compute, peak_gib=peak, losses=losses,
            launches=chained, eval_loss=float(ev['loss']), eval_loss_ema=float(ev_ema['loss']))
        log(f'families (a) SleepPPG-Net: {FAMILY_K} chained steps {chain:.1f} ms, compute {compute:.1f} ms/step, '
            f'peak device memory {peak:.2f} GiB, losses {losses}; eval step on the running statistics loss '
            f'{float(ev["loss"]):.6f} (EMA {float(ev_ema["loss"]):.6f}); launches {chained}')
        if chained != {'K1': 0, 'K2': 0, 'K3': 0} or not all(np.isfinite(losses)) \
                or not (np.isfinite(float(ev['loss'])) and np.isfinite(float(ev_ema['loss']))):
            raise AssertionError(f'families (a): launches {chained}, losses {losses}, eval {float(ev["loss"])}')
        folder = os.path.join(work, 'ppgnet')
        checkpoint.save_checkpoint_folder(folder, PPGNET_CFG, model.state_dict())
        del s, model, metrics
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    loaded = api.load_model(folder, precision='bfloat16')
    floats = {v.dtype for v in loaded.state_dict().values() if v.is_floating_point()}
    zero_counts(k1, k3)
    with torch.inference_mode():
        got = loaded(x[:PPGNET_SERVE_BATCH].bfloat16()).float()
    bf16_launches = counts(k1, k3)
    err = float((got - want).abs().max())
    scale = float(want.abs().max() + want.square().mean().sqrt())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    preds = got.argmax(-1)
    log(f'families (a) SleepPPG-Net checkpoint folder -> load_model(bfloat16): B={PPGNET_SERVE_BATCH} forward logits '
        f'{tuple(got.shape)}, max |bf16 - f32 eval| {err:.4e} (bound {FAMILY_BF16_TOL:g} x {scale:.4f}), argmax '
        f'agreeing {agree:.4f}; launches {bf16_launches}')
    out['ppgnet'].update(bf16_max_abs_diff=err, bf16_scale=scale, bf16_argmax_agreement=agree)
    if floats != {torch.bfloat16} or got.shape != (PPGNET_SERVE_BATCH, n_epochs, 4) \
            or not bool(torch.isfinite(got).all()) or int(preds.min()) < 0 or int(preds.max()) > 3 \
            or not err <= FAMILY_BF16_TOL * scale or bf16_launches['K1'] != 0:
        raise AssertionError(f'families (a): the bf16 checkpoint forward failed its checks ({floats}, {err})')
    del loaded, got, want, x, y
    torch.cuda.empty_cache()

    # (b) The causal flagship, f32 with causal normalization on the EDF nights.
    cfg = family_config(wav2sleep, causal=True, chunk_causal=False)
    model = wav2sleep.build_wav2sleep(**cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    pipe = pipeline.StreamingPipeline(model, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS,
                                      precision='float32', normalize='causal', device='cuda')
    pipe.warmup()
    batches = -(-NIGHTS // BATCH)
    zero_counts(k1, k3)
    walls, served = timed_passes(torch, pipe, fps, 1)
    causal_launches = counts(k1, k3)
    check_hypnograms(served, fps, n_epochs, 'families (b)')
    rate = 3600 * NIGHTS / walls[0]
    log(f'families (b) causal flagship f32, normalize=causal, batch {BATCH}: 1 pass of {NIGHTS} EDF nights x '
        f'{HOURS:g} h in {walls[0]:.3f} s, {rate:.0f} recordings/hour on {card}; launches {causal_launches}')
    if causal_launches != {'K1': 0, 'K2': 0, 'K3': batches}:
        raise AssertionError(f'families (b): launches {causal_launches}, expected K3 {batches} and no K1')
    del pipe
    # Causality on the card: the first half of a night gives the first half
    # of the whole night's logits. Layer-norm encoders: the config's
    # instance norm takes its statistics over the whole night (printed).
    gen = torch.Generator(device='cuda').manual_seed(FAMILY_SEED)
    night = {c: torch.randn(1, grid_length(c, HOURS), device=dev, generator=gen) for c in SIGNALS}
    half = {c: v[:, : v.shape[1] // 2] for c, v in night.items()}
    prefix = {}
    for name, norm in (('layer', 'layer'), ('instance', 'instance')):
        m = wav2sleep.build_wav2sleep(**family_config(wav2sleep, True, False, enc_norm=norm),
                                      generator=torch.Generator().manual_seed(0)).to(dev).eval()
        with torch.inference_mode(), full_f32():
            full_logits, half_logits = m(night), m(half)
        prefix[name] = float((full_logits[:, : n_epochs // 2] - half_logits).abs().max())
        scale = float(full_logits.abs().max())
        del m
    log(f'families (b) causality, one {HOURS:g} h night, f32: first half vs the whole night\'s first half, max |d| '
        f'{prefix["layer"]:.3e} with layer-norm encoders (bound {FAMILY_F32_TOL:g}); {prefix["instance"]:.3e} with '
        f'the config\'s instance-norm encoders, whose statistics span the night')
    if not prefix['layer'] <= FAMILY_F32_TOL * (1 + scale):
        raise AssertionError(f'families (b): the causal flagship is not causal on the card: {prefix}')
    out['causal'] = dict(batch=BATCH, nights=NIGHTS, hours=HOURS, wall_s=walls[0], recordings_per_hour=rate,
                         launches=causal_launches, prefix_max_abs_diff=prefix)
    del model
    torch.cuda.empty_cache()

    # (c) Chunk-causal encoders, batch-norm sequence mixer (the config's
    # default), post-norm epoch mixer, from a checkpoint folder in bf16.
    cfg = family_config(wav2sleep, causal=True, chunk_causal=True, seq_norm=None, norm_first=False)
    target = instantiate.target_config(**cfg)
    del target['sequence_mixer']['norm']  # left out: the JAX package's default
    folder = os.path.join(work, 'chunk_causal')
    checkpoint.save_checkpoint_folder(folder, target, wav2sleep.build_wav2sleep(
        **cfg, generator=torch.Generator().manual_seed(0)).state_dict())
    loaded = api.load_model(folder, precision='bfloat16')
    pipe = pipeline.StreamingPipeline(loaded, list(SIGNALS), batch_size=BATCH, max_length_hours=HOURS,
                                      precision='bfloat16', normalize='zscore', device='cuda')
    zero_counts(k1, k3)
    walls_c, served_c = timed_passes(torch, pipe, fps[:BATCH], 1)
    chunk_launches = counts(k1, k3)
    check_hypnograms(served_c, fps[:BATCH], n_epochs, 'families (c)')
    log(f'families (c) chunk-causal flagship, batch-norm sequence mixer, post-norm mixer, bf16 from a checkpoint '
        f'folder: {BATCH} nights in {walls_c[0]:.3f} s (one batch, host decode in the loop); launches {chunk_launches}')
    if chunk_launches['K1'] != 0 or chunk_launches['K2'] != 0:
        raise AssertionError(f'families (c): launches {chunk_launches}')
    out['chunk_causal'] = dict(batch=BATCH, wall_s=walls_c[0], launches=chunk_launches)
    del pipe, loaded
    torch.cuda.empty_cache()
    out['wall_s'] = time.time() - t_phase
    log(f'families: phase 12 took {out["wall_s"]:.1f} s')
    return out, causal_launches['K3']


# Phase 13: the trainer. A parquet corpus of ten-hour nights as ingest lays
# it out (one table a night, shorter columns null-padded, a Stage column):
# mesa and shhs, each with these nights a split.
TRAINER_NIGHTS = {'train': 8, 'val': 4, 'test': 2}
TRAINER_SEED = 17
TRAINER_SPE = {'ECG': 1024, 'PPG': 1024, 'ABD': 256, 'THX': 256}
TRAINER_BATCH = 8
TRAINER_OVERRIDES = ['datasets.train=[mesa,shhs]', 'datasets.val=[mesa,shhs]', 'datasets.test=[mesa]',
                     f'batch_size={TRAINER_BATCH}', 'target_batch_size=16', f'training.val_batch_size={TRAINER_BATCH}',
                     f'training.test_batch_size={TRAINER_BATCH}', 'training.ema.enabled=true',
                     'training.ema.start_step=0', 'test=true']
# The keys of the JAX trainer's metrics.jsonl rows for this corpus, per
# epoch: the train row, its confusion row, and the eval matrix's rows
# (tests/test_torch_trainer.py holds the port's keys equal to JAX's).
TRAIN_ROW = {'step', 'time', 'train_loss', 'train_steps_per_sec', 'lr_step', 'lr', 'host_loader_frac'}
VAL_SUBSETS = {'mesa': ('ECG', 'ECG_THX', 'PPG', 'PPG_THX'), 'shhs': ('ECG', 'ECG_THX')}
VAL_ROW = ({'step', 'time', 'val_loss', 'val_loss_mesa', 'val_loss_shhs'}
           | {f'val_{s}_loss_{d}' for d, subs in VAL_SUBSETS.items() for s in subs}
           | {f'val_eval_seconds_{d}' for d in ('all', 'mesa', 'shhs')})
CONFUSION_PREFIXES = (['train_all', 'val_all', 'val_mesa'] + [f'val_{s}_mesa' for s in VAL_SUBSETS['mesa']]
                      + ['val_shhs'] + [f'val_{s}_shhs' for s in VAL_SUBSETS['shhs']])
TUNE_MEMORY_SLACK = 64 * 2**20  # bytes the card may hold after tuning beyond what it held before


def write_trainer_corpus(root: str) -> tuple[int, float]:
    """The phase's parquet corpus (written with ``data.parquet.write_night``):
    seeded signals whose amplitude follows the stage (as
    tests/train/test_trainer_smoke.py writes them), one mesa train night
    without THX, and one ``.issues`` night the data module must skip.
    Returns the bytes written and the seconds taken."""
    from wav2sleep_tpu_torch.data.parquet import write_night

    t0, n_bytes = time.time(), 0
    S = int(round(TRAIN_HOURS * 120))
    rng = np.random.default_rng(TRAINER_SEED)
    for ds in ('mesa', 'shhs'):
        for split, n_nights in TRAINER_NIGHTS.items():
            folder = os.path.join(root, ds, split)
            os.makedirs(folder)
            for n in range(n_nights):
                labels = rng.integers(0, 4, size=S).astype(np.float32)
                cols = {}
                for sig, spe in TRAINER_SPE.items():
                    if (ds, split, n) == ('mesa', 'train', 0) and sig == 'THX':
                        continue
                    amp = np.repeat(labels + 1.0, spe).astype(np.float32)
                    base = np.tile(np.sin(np.arange(spe, dtype=np.float32) / np.float32(3.0)), S) if spe == 1024 else 1.0
                    cols[sig] = amp * base + np.float32(0.05) * rng.standard_normal(S * spe, dtype=np.float32)
                cols['Stage'] = labels
                fp = os.path.join(folder, f'{ds}-night{n}.parquet')
                write_night(fp, cols, metadata={k: {'samples_per_epoch': v} for k, v in TRAINER_SPE.items()})
                n_bytes += os.path.getsize(fp)
    bad = os.path.join(root, 'mesa', 'train', 'bad.issues.parquet')
    write_night(bad, {'ECG': np.zeros(S * 1024, np.float32), 'Stage': np.zeros(S, np.float32)})
    return n_bytes + os.path.getsize(bad), time.time() - t0


def _jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_trainer_log(rows: list[dict], epochs: list[int]) -> None:
    """The JAX trainer's metrics.jsonl keys for ``epochs``, every loss finite."""
    for epoch in epochs:
        mine = [r for r in rows if r['step'] == epoch]
        train = [r for r in mine if 'train_loss' in r]
        val = [r for r in mine if 'val_loss' in r]
        if len(train) != 1 or set(train[0]) != TRAIN_ROW or len(val) != 1 or set(val[0]) != VAL_ROW:
            raise AssertionError(f'trainer: metrics.jsonl rows of epoch {epoch} do not have the JAX trainer\'s keys: '
                                 f'{[sorted(r) for r in train + val]}')
        prefixes = [next(k for k in r if k.endswith('_acc'))[: -len('_acc')] for r in mine if
                    any(k.endswith('_acc') for k in r)]
        prefixes = [p for p in prefixes if not p.startswith('test_')]
        if prefixes != CONFUSION_PREFIXES:
            raise AssertionError(f'trainer: confusion rows of epoch {epoch}: {prefixes}')
        losses = {k: v for r in train + val for k, v in r.items() if 'loss' in k}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f'trainer: a loss of epoch {epoch} is not finite: {losses}')


def phase_trainer(torch, k1, k3, card, work, tf32_defaults):
    """Phase 13: ``python -m wav2sleep_tpu_torch.train``'s ``main`` on the
    card: the flagship at full width on ten-hour parquet nights, 2 epochs,
    then a resume from ``last`` for one more, the exported folder served in
    bf16, and batch-size tuning past an out-of-memory. Returns the
    ``trainer`` line and K1's launches per training micro-step."""
    from wav2sleep_tpu_torch import api
    from wav2sleep_tpu_torch.data.dataset import ParquetDataset, collate
    from wav2sleep_tpu_torch.instantiate import build_model
    from wav2sleep_tpu_torch.config import compose
    from wav2sleep_tpu_torch.train import __main__ as train_cli
    from wav2sleep_tpu_torch.train import checkpointing, loop
    from wav2sleep_tpu_torch.train.tuning import tune_batch_size

    t_phase = time.time()
    corpus, run = os.path.join(work, 'corpus'), os.path.join(work, 'run')
    n_bytes, write_s = write_trainer_corpus(corpus)
    log(f'trainer: wrote {sum(TRAINER_NIGHTS.values()) * 2} parquet nights of {TRAIN_HOURS:g} h and one .issues night, '
        f'{n_bytes / 2**20:.1f} MiB, in {write_s:.1f} s (set-up)')
    # Count K1 over each training epoch and its micro-steps; keep the state
    # saved at the last epoch's checkpoint, and compare what the resumed run
    # restores with it.
    epochs, saved, restored = [], {}, {}
    orig_epoch, orig_save, orig_restore = loop.Trainer.train_epoch, checkpointing.CheckpointManager.save, \
        checkpointing.CheckpointManager.restore

    def counted_epoch(self, epoch):
        self.ensure_state()
        step0, before = self.state.step, k1.LAUNCHES
        out = orig_epoch(self, epoch)
        epochs.append(dict(epoch=epoch, micro_steps=self.state.step - step0, k1=k1.LAUNCHES - before))
        return out

    def kept_save(self, trainer, epoch, val_loss, is_best):
        orig_save(self, trainer, epoch, val_loss, is_best)
        saved['epoch'], saved['tree'] = epoch, checkpointing.state_tree(trainer.state)

    def checked_restore(self, trainer, which='last'):
        epoch = orig_restore(self, trainer, which)
        if which == 'last':
            restored['epoch'], restored['tree'] = epoch, checkpointing.state_tree(trainer.state)
        return epoch

    saved_flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    loop.Trainer.train_epoch, checkpointing.CheckpointManager.save = counted_epoch, kept_save
    checkpointing.CheckpointManager.restore = checked_restore
    try:
        args = [*TRAINER_OVERRIDES, f'max_length_hours={TRAIN_HOURS:g}', f'data_location={corpus}', f'run_dir={run}']
        torch.cuda.reset_peak_memory_stats()
        zero_counts(k1, k3)
        t0 = time.time()
        final = train_cli.main([*args, 'epochs=2'])
        torch.cuda.synchronize()
        fit_s, fit_launches = time.time() - t0, counts(k1, k3)
        fit_peak = torch.cuda.max_memory_allocated() / 2**30
        first_saved = dict(saved)
        rows = _jsonl(os.path.join(run, 'metrics.jsonl'))
        check_trainer_log(rows, [0, 1])
        for name in ('last', 'best'):
            for path in (os.path.join(run, 'checkpoints', name, checkpointing.STATE_FILE),
                         os.path.join(run, 'checkpoints', f'{name}.meta.json')):
                if not os.path.exists(path):
                    raise AssertionError(f'trainer: {path} is missing')
        with open(os.path.join(run, 'final_metrics.json')) as f:
            if json.load(f).keys() != final.keys() or not all(np.isfinite(v) for v in final.values()):
                raise AssertionError(f'trainer: final_metrics.json disagrees with {final}')
        micro = [e['micro_steps'] for e in epochs]
        if micro != [2, 2] or any(e['k1'] != 160 * e['micro_steps'] for e in epochs):
            raise AssertionError(f'trainer: K1 launches per training epoch {epochs}, expected 160 a micro-step over 2 '
                                 f'micro-steps (16 train nights, batch {TRAINER_BATCH}; the .issues night skipped)')
        k1_per_micro_step = epochs[0]['k1'] // epochs[0]['micro_steps']
        log(f'trainer: 2 epochs through main() in {fit_s:.1f} s (test set included); K1 {k1_per_micro_step} launches '
            f'a training micro-step (forward and remat recompute), {fit_launches["K1"] - sum(e["k1"] for e in epochs)} in '
            f'the eval and test passes; peak device memory {fit_peak:.2f} GiB; final {final}')

        # (c) Resume from last for exactly one more epoch.
        epochs.clear()
        t0 = time.time()
        train_cli.main([*args, 'epochs=3', 'ckpt_path=last'])
        resume_s = time.time() - t0
        if [e['epoch'] for e in epochs] != [2] or restored.get('epoch') != 2:
            raise AssertionError(f'trainer: the resumed run trained epochs {[e["epoch"] for e in epochs]}, expected [2]')
        want, got = first_saved['tree'], restored['tree']
        mismatched = [k for k in want['params'] if not torch.equal(want['params'][k], got['params'][k])]
        mismatched += [f'mu{i}' for i, (a, b) in enumerate(zip(want['opt_state']['mu'], got['opt_state']['mu']))
                       if not torch.equal(a, b)]
        mismatched += [f'ema {k}' for k in want['ema_params'] if not torch.equal(want['ema_params'][k],
                                                                               got['ema_params'][k])]
        if first_saved['epoch'] != 1 or mismatched or got['step'] != want['step']:
            raise AssertionError(f'trainer: the restored state is not the saved one: {mismatched[:5]}')
        rows = _jsonl(os.path.join(run, 'metrics.jsonl'))
        check_trainer_log(rows, [0, 1, 2])
        train_rows = [r for r in rows if 'train_loss' in r]
        log(f'trainer: resumed from last at epoch 2 in {resume_s:.1f} s; restored parameters, Adam moments and EMA '
            f'equal the saved ones bit for bit ({len(want["params"])} tensors each); metrics.jsonl train rows '
            f'{[r["step"] for r in train_rows]}')
    finally:
        loop.Trainer.train_epoch, checkpointing.CheckpointManager.save = orig_epoch, orig_save
        checkpointing.CheckpointManager.restore = orig_restore
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_flags

    # (d) The exported folder, served in bf16 on one batch of the val nights.
    model = api.load_model(os.path.join(run, 'model'), precision='bfloat16')
    dev = next(model.parameters()).device
    val = sorted(os.path.join(corpus, ds, 'val', f) for ds in ('mesa', 'shhs')
                 for f in os.listdir(os.path.join(corpus, ds, 'val')))[:TRAINER_BATCH]
    x, _ = collate([ParquetDataset(val, list(TRAINER_SPE))[i] for i in range(len(val))])
    with torch.inference_mode():
        hyp = model({k: torch.from_numpy(v).to(dev, torch.bfloat16) for k, v in x.items()}).argmax(-1).cpu().numpy()
    S = int(round(TRAIN_HOURS * 120))
    if hyp.shape != (len(val), S) or hyp.min() < 0 or hyp.max() > 3:
        raise AssertionError(f'trainer: exported model served bad hypnograms: {hyp.shape}, {hyp.min()}..{hyp.max()}')
    log(f'trainer: {run}/model served {len(val)} val nights in bf16 through load_model: hypnograms {hyp.shape}, '
        f'classes {sorted(set(hyp.ravel().tolist()))}')
    del model

    # (e) Batch-size tuning of the f32 flagship on ten-hour nights.
    torch.cuda.empty_cache()
    cfg = compose(train_cli.CONFIG_DIR.as_posix(), 'main', [])
    tune_model = build_model(cfg['model'], generator=torch.Generator().manual_seed(0))
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    tuned = tune_batch_size(tune_model, columns=list(TRAINER_SPE), epochs_per_night=S)
    tune_s = time.time() - t0
    after = torch.cuda.memory_allocated()
    if not 0 < tuned < 512:
        raise AssertionError(f'trainer: tune_batch_size settled on {tuned}; expected an out-of-memory under 512')
    if after - before > TUNE_MEMORY_SLACK:
        raise AssertionError(f'trainer: tuning left {(after - before) / 2**20:.1f} MiB allocated on the card')
    log(f'trainer: tune_batch_size (f32 flagship, {S} epochs a night, ceiling 512): {tuned} fits, {2 * tuned} ran out '
        f'of memory, {tune_s:.1f} s; memory allocated {before / 2**20:.1f} MiB before, {after / 2**20:.1f} MiB after')

    eval_rows = [r for r in rows if 'val_loss' in r]
    test_rows = [r for r in rows if any(k.startswith('test_eval_seconds_') for k in r)]
    line = dict(
        card=card, hours=TRAIN_HOURS, batch=TRAINER_BATCH, accumulate=2, precision='float32',
        corpus_mib=n_bytes / 2**20, corpus_write_s=write_s, fit_s=fit_s, resume_s=resume_s,
        steps_per_s=[r['train_steps_per_sec'] for r in train_rows],
        host_loader_frac=[r['host_loader_frac'] for r in train_rows],
        eval_s={r['step']: {k[len('val_eval_seconds_'):]: v for k, v in r.items() if k.startswith('val_eval_seconds_')}
                for r in eval_rows},
        test_eval_s=[{k[len('test_eval_seconds_'):]: v for k, v in r.items() if k.startswith('test_eval_seconds_')}
                     for r in test_rows],
        train_loss=[r['train_loss'] for r in train_rows], val_loss=[r['val_loss'] for r in eval_rows],
        k1_launches_per_micro_step=k1_per_micro_step, peak_gib=fit_peak,
        tuned_batch=tuned, oom_batch=2 * tuned, tune_s=tune_s,
        tune_memory_mib={'before': before / 2**20, 'after': after / 2**20}, phase_s=time.time() - t_phase,
    )
    return line, k1_per_micro_step


# Phase 14: the inference API. Four of phase 8's EDF nights (night 5 has no
# Thor channel) through predict_on_folder, f32 and bf16, from phase 9's
# checkpoint folder; predict's rate over all of phase 8's nights; then the
# predict CLI over phase 13's labeled val nights.
API_NIGHTS = (0, 1, 5, 9)
API_BATCH = 4  # the API's default batch
# f32 API logits on K1 against the same model with its convs plain, on the
# card: |d| <= API_TOL * (1 + |plain|).
API_TOL = 5e-4


@contextlib.contextmanager
def timed_calls(module, names):
    """Wall seconds of each call to ``module.<name>`` made inside the
    block (the entry point calls them through the module)."""
    seconds = {n: 0.0 for n in names}
    saved = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] += time.perf_counter() - t0
        return call

    for n in names:
        setattr(module, n, timed(n, saved[n]))
    try:
        yield seconds
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _read_csv_rows(path: str) -> list[list[str]]:
    with open(path) as f:
        return [line.split(',') for line in f.read().splitlines()]


def _linked(folder: str, fps: list[str]) -> str:
    os.makedirs(folder)
    for fp in fps:
        os.symlink(fp, os.path.join(folder, os.path.basename(fp)))
    return folder


def phase_api(torch, k1, k3, layers, card, fps, out_z, work):
    """Phase 14: ``api.predict_on_folder`` with the device and batch at
    their defaults, f32 then bf16, on four ten-hour EDF nights from phase
    9's checkpoint folder; the f32 logits on K1 against the plain path;
    ``api.predict``'s rate over all of phase 8's nights; then
    ``cli.predict.main`` over phase 13's labeled val nights with its
    exported model. Returns the ``api`` line and K1's launches in the f32
    ``predict_on_folder`` run."""
    import io

    from wav2sleep_tpu_torch import api
    from wav2sleep_tpu_torch.cli import predict as predict_cli
    from wav2sleep_tpu_torch.data.dataset import collate, pad_or_truncate_item
    from wav2sleep_tpu_torch.data.edf import get_edf_start

    t_phase = time.time()
    n_epochs = int(round(HOURS * 120))
    nights = sorted(fps[i] for i in API_NIGHTS)
    inp = _linked(os.path.join(work, 'api_in'), nights)
    ckpt, cache = os.path.join(work, 'checkpoint'), os.path.join(work, 'api_cache')
    line = dict(card=card, nights=len(nights), hours=HOURS, batch=API_BATCH)
    k1_api = None
    for precision in ('float32', 'bfloat16'):
        out = os.path.join(work, f'api_preds_{precision}')
        with timed_calls(api, ('prepare', 'predict', 'save_predictions')) as seconds:
            zero_counts(k1, k3)
            t0 = time.perf_counter()
            preds, labels = api.predict_on_folder(inp, out, model_folder=ckpt, precision=precision,
                                                  tmp_root_folder=cache, return_tensors=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts(k1, k3)
        forwards = -(-len(nights) // API_BATCH)
        if labels is not None or [p.shape for p in preds] != [(n_epochs,)] * len(nights) or \
                min(p.min() for p in preds) < 0 or max(p.max() for p in preds) > 3:
            raise AssertionError(f'api {precision}: bad predictions {[(p.shape, p.min(), p.max()) for p in preds]}')
        if launches['K1'] <= 0 or launches['K1'] % forwards or launches['K2'] or launches['K3']:
            raise AssertionError(f'api {precision}: launches {launches} over {forwards} forwards')
        for fp, pred in zip(nights, preds):
            rel = os.path.relpath(os.path.join(inp, os.path.basename(fp)), os.sep)
            rows = _read_csv_rows(os.path.join(out, os.path.splitext(rel)[0] + '.preds.csv'))
            first = f'{get_edf_start(fp) + datetime.timedelta(seconds=30):%Y-%m-%d %H:%M:%S}.029296875'
            if rows[0] != ['Timestamp', 'Pred'] or len(rows) != 1 + n_epochs or rows[1][0] != first or \
                    [int(r[1]) for r in rows[1:]] != pred.tolist():
                raise AssertionError(f'api {precision}: {rel} has {len(rows) - 1} rows from {rows[1][0]}, '
                                     f'expected {n_epochs} from {first} holding the predictions')
        agree = float(np.mean(np.concatenate([p == dict(out_z)[fp] for fp, p in zip(nights, preds)])))
        line[precision] = dict(
            wall_s=wall, prepare_s_per_night=seconds['prepare'] / len(nights), predict_s=seconds['predict'],
            predict_forwards=forwards, save_predictions_s=seconds['save_predictions'],
            k1_launches=launches['K1'], k1_launches_per_forward=launches['K1'] // forwards,
            agree_with_phase8_zscore=agree,
        )
        if precision == 'float32':
            k1_api = launches['K1']
        log(f'api predict_on_folder {precision}: {len(nights)} EDF nights x {HOURS:g} h in {wall:.2f} s; prepare '
            f'{seconds["prepare"] / len(nights):.2f} s a night, predict {seconds["predict"]:.3f} s '
            f'({forwards} B={API_BATCH} forward, parquet read included), save_predictions '
            f'{seconds["save_predictions"]:.3f} s; K1 {launches["K1"] // forwards} launches a forward; '
            f'{len(nights)} CSV files of {n_epochs} rows from the EDF start + 30 s + 30/1024 s; epochs agreeing '
            f'with phase 8\'s z-score hypnograms {agree:.5f} (report only) on {card}')

    # The f32 API forward on K1 against the same module with its convs
    # plain, on the batch predict formed.
    model = api.W2SModel.load(ckpt)
    signals = model.valid_signals
    ds = api.load_dataset(api.prepare(inp, signals, tmp_root_folder=cache), signals,
                          max_length_hours=10)
    x, _ = collate([pad_or_truncate_item(ds[i], n_epochs) for i in range(len(ds))])
    got = model.logits(x)
    with plain_convs(layers, k1):
        want = model.logits(x)
    err = float(np.max(np.abs(got - want) / (1 + np.abs(want))))
    if not np.isfinite(got).all() or err > API_TOL:
        raise AssertionError(f'api: f32 logits on K1 vs plain, max |d| / (1 + |plain|) {err:.3e} > {API_TOL}')
    line['f32_logits_vs_plain'] = err
    log(f'api: f32 W2SModel.logits on K1 vs the plain path, B={len(ds)} x {HOURS:g} h: max |d| / (1 + |plain|) '
        f'{err:.3e} (gate {API_TOL})')
    del model, x

    # (c) predict's rate over a folder: every night of phase 8 in the
    # cache (prepare adds the ones (a) did not read), one timed predict
    # call per precision with the default batch, warm from (a).
    for fp in sorted(set(fps) - set(nights)):
        os.symlink(fp, os.path.join(inp, os.path.basename(fp)))
    t0 = time.perf_counter()
    folder = api.prepare(inp, signals, tmp_root_folder=cache)
    line['folder_prepare_s_per_night'] = (time.perf_counter() - t0) / (len(fps) - len(nights))
    for precision in ('float32', 'bfloat16'):
        model = api.W2SModel.load(ckpt, precision=precision)
        ds = api.load_dataset(folder, signals, max_length_hours=10)
        forwards = -(-len(ds) // API_BATCH)
        zero_counts(k1, k3)
        t0 = time.perf_counter()
        preds, _ = api.predict(model, ds)
        predict_s = time.perf_counter() - t0
        launches = counts(k1, k3)
        if len(preds) != len(fps) or any(p.shape != (n_epochs,) for p in preds) or \
                launches['K1'] != forwards * line[precision]['k1_launches_per_forward']:
            raise AssertionError(f'api predict {precision} over {len(fps)} nights: {len(preds)} results, {launches}')
        line[precision]['folder'] = dict(nights=len(ds), forwards=forwards, predict_s=predict_s,
                                         s_per_forward=predict_s / forwards, nights_per_hour=3600 * len(ds) / predict_s)
        log(f'api predict {precision} over {len(ds)} ten-hour nights: {predict_s:.3f} s in {forwards} B={API_BATCH} '
            f'forwards ({predict_s / forwards:.3f} s a forward, parquet read included; '
            f'{3600 * len(ds) / predict_s:.0f} nights/hour) on {card}')
        del model, ds, preds

    # (b) The predict CLI over phase 13's labeled val nights, without
    # preprocessing, with its exported model.
    corpus = os.path.join(work, 'corpus')
    val = _linked(os.path.join(work, 'api_val'), sorted(
        os.path.join(corpus, ds_, 'val', f) for ds_ in ('mesa', 'shhs') for f in os.listdir(os.path.join(corpus, ds_, 'val'))))
    out = os.path.join(work, 'api_cli_preds')
    printed = io.StringIO()
    zero_counts(k1, k3)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        predict_cli.main(['--input-folder', val, '--output-folder', out, '--model-folder',
                          os.path.join(work, 'run', 'model'), '--no-preprocess'])
    cli_s, cli_launches = time.perf_counter() - t0, counts(k1, k3)
    text = printed.getvalue()
    kappa = re.search(r"^Cohen's kappa: (-?[0-9.]+|nan)$", text, re.M)
    acc = re.search(r'^Accuracy: ([0-9.]+|nan)$', text, re.M)
    csvs = sorted(os.listdir(out))  # without preprocessing, relative to the input folder
    if not (kappa and acc) or len(csvs) != len(os.listdir(val)) or cli_launches['K1'] <= 0:
        raise AssertionError(f'api cli: printed {text!r}, wrote {csvs}, launches {cli_launches}')
    for name in csvs:
        rows = _read_csv_rows(os.path.join(out, name))
        if rows[0] != ['Timestamp', 'Pred', 'Stage'] or len(rows) != 1 + n_epochs or rows[1][0] != '30.0':
            raise AssertionError(f'api cli: {name} starts {rows[:2]} with {len(rows) - 1} rows')
    line['cli'] = dict(nights=len(csvs), wall_s=cli_s, kappa=float(kappa.group(1)), accuracy=float(acc.group(1)),
                       k1_launches=cli_launches['K1'])
    log(f'api cli: python -m wav2sleep_tpu_torch.cli.predict --no-preprocess over {len(csvs)} labeled val nights '
        f'in {cli_s:.1f} s (model load included): {text.strip()!r}; CSVs with Stage; K1 {cli_launches["K1"]} launches')
    line['phase_s'] = time.time() - t_phase
    log(f'api: phase 14 took {line["phase_s"]:.1f} s')
    return line, k1_api


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA card')
    import torch.nn.functional as F

    from wav2sleep_tpu_torch import native, pipeline
    from wav2sleep_tpu_torch.models import layers, wav2sleep
    from wav2sleep_tpu_torch.ops import block_domain as bd
    from wav2sleep_tpu_torch import profile_variants
    from wav2sleep_tpu_torch.ops import conv_k3 as k1
    from wav2sleep_tpu_torch.ops import conv_variants as cv
    from wav2sleep_tpu_torch.ops import cuda_build
    from wav2sleep_tpu_torch.ops import ema_norm as k3
    from wav2sleep_tpu_torch.ops import q8_transport as q8
    from wav2sleep_tpu_torch import train_bench

    tf32_defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}')
    log(f'nvidia-smi: {card}')

    phase_build(k1, k3, cv, native)
    with torch.inference_mode():
        k1_err, k1_line = phase_k1(torch, F, k1, bd.block_stats)
        k2_err, k2_line = phase_k2(torch, k1, bd.block_stats)
        phase_forward_convs(torch, F, k1, layers, wav2sleep)
        k3_err, k3_line, _ = phase_k3(torch, k3)
    phase_model(torch, k1, k3, bd, layers, wav2sleep)
    phase_serve_q8(torch, k1, k3, layers, wav2sleep, pipeline, card)
    build_dir = os.path.join(ROOT, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as nights, tempfile.TemporaryDirectory(dir=build_dir) as work:
        t0 = time.time()
        fps = write_nights(nights, NIGHTS, HOURS, seed=10, absent={5: ('Thor',)})
        log(f'serve: wrote {NIGHTS} EDF nights of {HOURS:g} h ({sum(os.path.getsize(f) for f in fps) / 2**20:.0f} MiB) '
            f'with write_edf in {time.time() - t0:.1f} s (set-up)')
        main_counts, stats_counts, out_z = phase_serve_f32(torch, k1, k3, bd, wav2sleep, pipeline, card, fps)
        phase_serve_cli(torch, k1, k3, wav2sleep, pipeline, card, fps, out_z, work)
        with torch.inference_mode():
            variant_lines = phase_variants(torch, F, k1, cv, cuda_build, profile_variants)
        train_line, k1_train, k2_train = phase_train(torch, k1, k3, bd, layers, train_bench, q8, tf32_defaults)
        families_line, k3_causal = phase_families(torch, k1, k3, wav2sleep, pipeline, train_bench, card, fps, work,
                                                   tf32_defaults)
        torch.cuda.empty_cache()
        trainer_line, k1_trainer = phase_trainer(torch, k1, k3, card, work, tf32_defaults)
        torch.cuda.empty_cache()
        api_line, k1_api = phase_api(torch, k1, k3, layers, card, fps, out_z, work)

    source = 'wav2sleep_tpu_torch/csrc/'
    kernels = [
        # K1 line: bf16, identity phi, 16->16 s1, B=8, T=1,228,800;
        # launches: the f32 causal serving path; train_launches: per
        # training step of phase 11 (a) (forward and recompute);
        # trainer_launches: per training micro-step of phase 13's main();
        # api_launches: phase 14's f32 predict_on_folder run.
        dict(name='conv_k3', route='cuda', source=source + 'conv_k3.cu',
             replaces='wav2sleep_tpu/ops/pallas_conv.py:136', launches=main_counts['K1'],
             train_launches=k1_train, trainer_launches=k1_trainer, api_launches=k1_api, max_abs_err=k1_err,
             **k1_line),
        # K2 line: bf16, norm+gelu phi, 16->16 s1, B=8, T=1,228,800;
        # launches: the same path in the kernel-statistics configuration;
        # train_launches: per training step of phase 11 (c).
        dict(name='conv_k3_stats', route='cuda', source=source + 'conv_k3.cu',
             replaces='wav2sleep_tpu/ops/pallas_conv.py:184', launches=stats_counts['K2'],
             train_launches=k2_train, max_abs_err=k2_err, **k2_line),
        # K3 line: the first 65,536 samples of one serving batch's 32 rows;
        # causal_flagship_launches: phase 12 (b)'s pass.
        dict(name='ema_norm', route='cuda', source=source + 'ema_norm.cu',
             replaces='wav2sleep_tpu/ops/pallas_ema.py:27', launches=main_counts['K3'],
             causal_flagship_launches=k3_causal, max_abs_err=k3_err, **k3_line),
        # The five profiling variants: phase 10, x [8, 153,600, 128] bf16,
        # tb 2048; launches: the profile_variants run; each also carries its
        # SASS counts (V0 LDG.E.128, STG.E.128; V2-V7 HGMMA, UTMALDG,
        # UTMASTG) and ptxas registers.
        *variant_lines,
    ]
    log(f'nvidia-smi: {card}')
    print(json.dumps({'train': train_line}))
    print(json.dumps({'families': families_line}))
    print(json.dumps({'trainer': trainer_line}))
    print(json.dumps({'api': api_line}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
