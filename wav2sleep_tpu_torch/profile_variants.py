"""Bisect K1's cost on one NVIDIA card: the port of ``scripts/profile_pallas_variants.py``.

    python -m wav2sleep_tpu_torch.profile_variants [--tb 2048] [--k 5] [--reps 3] [--both] [--device cuda]

Times the five rungs of ``ops/conv_variants.py`` at K1's hot shape (B = 8
nights of 1,228,800 samples of 16 channels, packed as x [8, 153,600, 128]
bf16), each a hand-written kernel of ``csrc/conv_variants.cu`` (V2-V7 in
its header ``csrc/conv_variants_wgmma.cuh``):

- ``copy_ms``: V0, ``y = x``, the floor of one pass over x;
- ``mm1_f32acc_ms``: V2, one 128 x 128 product on the tensor cores;
- ``mm3_ms``: V3, three products summed;
- ``mm3_shift_ms``: V4, three products with the tap shifts done on the f32
  outputs, 0 at every edge of ``--tb`` rows;
- ``v7_full_ms``: V7, K1's formulation, shifted on the bf16 inputs (each
  tap's operand one row further into a 66-row window of the tile), with
  halo rows of zeros as the JAX script gives it.

Then it checks V7, with the true neighbours as halo rows, against K1
(``conv_k3`` at 128 -> 128, stride 1) and times, on the same x and W,
``k1_ms`` (K1), ``conv1d_ms`` (``F.conv1d``, channels-first views of the
same tensors, as ``chip_smoke.py`` times it) and the one PyTorch call of
V0's, V2's and V3's function: ``tensor_copy_ms`` (``Tensor.copy_`` into a
y allocated once, the runtime's device-to-device copy; and
``tensor_copy_fresh_ms``, into a y allocated each call, as V0's wrapper
allocates its y), ``matmul_ms`` (``torch.matmul(x, W0)``) and
``einsum_ms`` (``torch.einsum('bnc,kco->bno', x, W)``, which sums W over
the taps first). With ``--both`` (the card only; ``chip_smoke.py`` times
its calls both ways itself and counts the launches of the marginal runs
alone) it adds ``both_ms``: each of those calls timed as
``bench_conv.both_ms`` does, [one call, back to back] in ms.

For an A/B across versions of ``csrc/conv_variants.cu``: it uses only
functions the package has had since the ladder was ported, so a copy of
this file placed in an older checkout's package times that checkout's
kernels. Run the versions in one call, in the order A, B, B, A.

The inputs are the JAX script's: ``np.random.default_rng(0)``, x drawn
first, then W x 0.1, both rounded to bf16. Each time is the JAX script's
marginal cost, k chained calls against one call, measured between CUDA
events, median over ``--reps``. On the card each call is timed after
``IDLE_S`` of an idle card, so that a call drawing the 700 W limit (V3,
V4) does not slow the one timed after it. ``bound_ms`` is the least time
the card could take for any rung: x read once and y written once at 3.35
TB/s (every rung is bound by bytes; V7's halo rows and W add under 0.1%).

It prints the card's name and power limit, then one JSON line with those
keys, the shape and the device. The JAX script's ``mm3_parsem_ms`` and
``v7_parsem_ms`` are left out: they time V3 and V7 again under
``dimension_semantics``, a hint that lets the TPU compiler split the grid
across cores. A CUDA grid's blocks always run in parallel, so there is no
second version to time.

With ``device='cpu'`` (the tests) the wrappers run their plain versions,
and the times are the host's, named so by the ``device`` key.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from .bench_conv import both_ms
from .ops import conv_k3 as k1
from .ops import conv_variants as cv
from .utils import card_line, resolve_device

HBM_BYTES_PER_S = 3.35e12
# V7 with true halos against K1: |d| <= TOL (|K1| + rms(K1)); both sum exact
# bf16 products in f32, in their own orders, and round y once (1 ulp,
# 2**-8 to 2**-7 relative), as chip_smoke.py's bound for bf16 K1.
TOL = 2.0**-6
# Seconds the card idles before each call is timed.
IDLE_S = 1.0


def inputs(B: int, nb: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, nb, 128] and W [3, 128, 128], bf16, drawn as the JAX script draws them."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, nb, cv.D)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(3, cv.D, cv.D)) * 0.1).astype(np.float32)).to(torch.bfloat16)
    return x.to(device), w.to(device)


def bound_ms(B: int, nb: int) -> float:
    """x read once and y written once over the memory rate, in ms."""
    return 1e3 * 2 * B * nb * cv.D * 2 / HBM_BYTES_PER_S


def _chain_ms(device: torch.device):
    """``chain(fn, n)``: ms that n calls of fn in a row take until the last
    one has finished (CUDA events on the card, the host clock on the CPU)."""
    if device.type == 'cuda':
        def chain(fn, n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
    else:
        def chain(fn, n):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return 1e3 * (time.perf_counter() - t0)
    return chain


def timeit(fn, k: int, reps: int, device: torch.device) -> float:
    """The JAX script's ``timeit``: the marginal ms of a call, (k calls - 1
    call) / (k - 1), median over reps, after a warm-up call."""
    chain = _chain_ms(device)
    chain(fn, 1)
    chain(fn, 1)
    return statistics.median([(chain(fn, k) - chain(fn, 1)) / (k - 1) for _ in range(reps)])


def run(B: int = 8, nb: int = 153_600, tb: int = 2048, k: int = 5, reps: int = 3, device=None,
        xw: tuple[torch.Tensor, torch.Tensor] | None = None, both: bool = False) -> dict:
    """Time the ladder, K1, ``F.conv1d`` and V2's and V3's library calls;
    print and return the results. ``xw``: x and W to time on, on ``device``
    (default ``inputs(B, nb)``); ``both``: also time each call both ways."""
    dev = resolve_device(device)
    if k < 2 or reps < 1:
        raise ValueError(f'profile_variants: k={k} must be >= 2 and reps={reps} >= 1')
    on_card = dev.type == 'cuda'
    if both and not on_card:
        raise ValueError('profile_variants: both=True times with CUDA events and needs the card')
    if on_card:
        print(f'nvidia-smi: {card_line()}', flush=True)
    x, w = inputs(B, nb, dev) if xw is None else xw
    if x.shape != (B, nb, cv.D):
        raise ValueError(f'profile_variants: x has shape {tuple(x.shape)}, not ({B}, {nb}, {cv.D})')
    w0 = w[0]
    xp0 = torch.zeros((B, nb // tb * 8, cv.D), dtype=torch.bfloat16, device=dev)
    xn0 = torch.zeros_like(xp0)

    def idle():
        if on_card:
            torch.cuda.synchronize(dev)
            time.sleep(IDLE_S)

    results = {'shape': f'B={B} nb={nb} D={cv.D} TB={tb} bf16',
               'device': torch.cuda.get_device_name(dev) if on_card else 'cpu'}
    rungs = {
        'copy_ms': lambda: cv.copy(x, tb),
        'mm1_f32acc_ms': lambda: cv.mm1f(x, w0, tb),
        'mm3_ms': lambda: cv.mm3(x, w, tb),
        'mm3_shift_ms': lambda: cv.mm3s(x, w, tb),
        'v7_full_ms': lambda: cv.v7(x, xp0, xn0, w, tb),
    }
    with torch.inference_mode():
        for key, fn in rungs.items():
            idle()
            results[key] = timeit(fn, k, reps, dev)
        results['bound_ms'] = bound_ms(B, nb)
        xp, xn = cv.true_halos(x, tb)
        ok, err = cv.agree(cv.v7(x, xp, xn, w, tb), k1.conv_k3(x, w), TOL)
        if not ok:
            raise AssertionError(f'profile_variants: V7 with true halos is not K1 (max |d| {err:.3e})')
        results['v7_vs_k1_max_abs_err'] = err
        w_oik = w.permute(2, 1, 0).contiguous()
        y_copy = torch.empty_like(x)
        others = {
            'k1_ms': lambda: k1.conv_k3(x, w),
            'conv1d_ms': lambda: F.conv1d(x.transpose(1, 2), w_oik, None, padding=1),
            'tensor_copy_ms': lambda: y_copy.copy_(x),
            'tensor_copy_fresh_ms': lambda: torch.empty_like(x).copy_(x),
            'matmul_ms': lambda: torch.matmul(x, w0),
            'einsum_ms': lambda: torch.einsum('bnc,kco->bno', x, w),
        }
        for key, fn in others.items():
            idle()
            results[key] = timeit(fn, k, reps, dev)
        if both:
            results['both_ms'] = {}
            for key, fn in {**rungs, **others}.items():
                idle()
                results['both_ms'][key] = list(both_ms(fn))
    print(json.dumps(results), flush=True)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tb', type=int, default=2048)
    parser.add_argument('--k', type=int, default=5)
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--both', action='store_true', help='also time each call both ways (the card only)')
    parser.add_argument('--device', default=None, help='default: the card (cuda)')
    args = parser.parse_args(argv)
    run(tb=args.tb, k=args.k, reps=args.reps, device=args.device, both=args.both)


if __name__ == '__main__':
    main()
