"""Time the K1 and K2 kernels of this checkout on one NVIDIA card.

    python -m wav2sleep_tpu_torch.bench_conv [--label NAME] [--json FILE] [--dtype float32]

For A/Bs across versions of ``csrc/conv_k3.cu``: it uses only functions the
package has had since wav2sleep-eog was ported (``conv_k3``,
``conv_k3_stats``, ``flagship_model`` with its ``variant``, ``VARIANTS``,
``block_domain.KERNEL_STATS``), so a copy of this file placed in an older
checkout's package times that checkout's kernels. Run the versions in one
call, in the order A, B, B, A. It prints, and writes to ``--json``:

- per encoder shape of the flagship (B=8 ten-hour nights, each shape at its
  first length in the ECG encoder) and of wav2sleep-eog (each at its first
  length, blocks 0 and 1 at both of theirs), in ``--dtype`` (bfloat16 by
  default), phi the identity and norm + gelu: K1 and K2, and ``F.conv1d``
  (TF32 off) for the identity, timed two ways, CUDA events around one call
  (median of 10) and around runs of 10 back-to-back calls (median of 5);
- K1 and K2 summed over the 80 k3 convs of one bf16 flagship forward and
  the 58 of one wav2sleep-eog forward, each call timed both ways on the
  inputs the forward gives it;
- the host's time per K1 call at a call small enough that the host sets
  the pace (wall clock over 1,000 calls, no sync between them);
- the bf16 forward (CUDA events, median of 3) with kernel statistics off
  and on.

With ``--dtype float32`` it times the shapes only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from .models import layers
from .models.wav2sleep import VARIANTS, flagship_model
from .ops import block_domain as bd
from .ops import conv_k3 as k1
from .pipeline import grid_length

SIGNALS = ('ECG', 'PPG', 'ABD', 'THX')
BATCH, HOURS, NORM_EPS = 8, 10.0, 1e-2
# (C_in, C_out, stride, T): every K1 shape of the flagship encoders, at its
# first (longest) length in the ECG encoder for ten-hour nights.
SHAPES = [
    (16, 16, 1, 1_228_800), (16, 16, 2, 1_228_800), (16, 32, 1, 307_200), (32, 32, 1, 307_200),
    (32, 32, 2, 307_200), (32, 64, 1, 76_800), (64, 64, 1, 76_800), (64, 64, 2, 76_800),
    (64, 128, 1, 19_200), (128, 128, 1, 19_200), (128, 128, 2, 19_200),
]
# The same for wav2sleep-eog's encoders (4,096 samples an epoch), with
# blocks 0 and 1 (16 channels) at both of their lengths.
EOG_T0 = 4096 * 1200
EOG_SHAPES = [
    (16, 16, 1, EOG_T0), (16, 16, 2, EOG_T0), (16, 16, 1, EOG_T0 // 2), (16, 16, 2, EOG_T0 // 2),
    (16, 32, 1, EOG_T0 // 4), (32, 32, 1, EOG_T0 // 4), (32, 32, 2, EOG_T0 // 4), (32, 64, 1, EOG_T0 // 16),
    (64, 64, 1, EOG_T0 // 16), (64, 64, 2, EOG_T0 // 16), (64, 128, 1, EOG_T0 // 64),
    (128, 128, 1, EOG_T0 // 64), (128, 128, 2, EOG_T0 // 64),
]


def cuda_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn()`` in a row, divided by ``inner``, in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def both_ms(fn) -> tuple[float, float]:
    """Time of one call of ``fn``, two ways: CUDA events around one call,
    median of 10, and around runs of 10 back-to-back calls, median of 5,
    where the host enqueues ahead of the card, so a small call's host time
    drops out."""
    return cuda_ms(fn), cuda_ms(fn, reps=5, inner=10)


def per_shape(dtype=torch.bfloat16, shapes=SHAPES) -> list[dict]:
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for ci, co, stride, T in shapes:
        x32 = torch.randn((BATCH, T, ci), device='cuda', generator=gen) * 1.5 + 0.2
        x = x32.to(dtype)
        w = ((torch.rand((3, ci, co), device='cuda', generator=gen) * 2 - 1) / (3 * ci) ** 0.5).to(dtype)
        b = (torch.randn((co,), device='cuda', generator=gen) * 0.1).to(dtype)
        mu, inv = bd.block_stats(x32, NORM_EPS)
        del x32
        row = dict(c_in=ci, c_out=co, stride=stride, T=T)
        for phi, args in (('id', (b, None, None, stride, None)), ('ng', (b, mu, inv, stride, 'gelu'))):
            row[f'k1_{phi}'] = both_ms(lambda: k1.conv_k3(x, w, *args))
            row[f'k2_{phi}'] = both_ms(lambda: k1.conv_k3_stats(x, w, *args, NORM_EPS))
        w_oik = w.permute(2, 1, 0).contiguous()
        row['lib_id'] = both_ms(lambda: F.conv1d(x.transpose(1, 2), w_oik, b, stride=stride, padding=1))
        print(f'{ci:3d}->{co:3d} s{stride} T={T}: ms one call, back to back: '
              + ', '.join(f'{k} {v[0]:.4f} {v[1]:.4f}' for k, v in row.items() if isinstance(v, tuple)), flush=True)
        rows.append(row)
        del x, mu, inv
        torch.cuda.empty_cache()
    return rows


def forward_convs(model, xb) -> dict:
    tot = {'calls': 0, 'k1': np.zeros(2), 'k2': np.zeros(2)}

    def timed_conv(x, w, bias=None, mu=None, inv=None, stride=1, act=None):
        args = (bias, mu, inv, stride, act)
        tot['k1'] += both_ms(lambda: k1.conv_k3(x, w, *args))
        tot['k2'] += both_ms(lambda: k1.conv_k3_stats(x, w, *args, NORM_EPS))
        tot['calls'] += 1
        return k1.conv_k3(x, w, *args)

    # Kernel statistics off: every k3 conv of the forward goes through conv_k3.
    layers.conv_k3, bd.KERNEL_STATS = timed_conv, False
    try:
        model(xb)
    finally:
        layers.conv_k3, bd.KERNEL_STATS = k1.conv_k3, None
    return {'calls': tot['calls'], 'k1': tot['k1'].tolist(), 'k2': tot['k2'].tolist()}


def host_us_per_call(calls: int = 1000) -> float:
    x = torch.randn((1, 2048, 64), device='cuda').bfloat16()
    w = torch.randn((3, 64, 64), device='cuda').bfloat16()
    for _ in range(10):
        k1.conv_k3(x, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        k1.conv_k3(x, w)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * wall / calls


def eog_forward_convs() -> dict:
    """K1 and K2 over one bf16 wav2sleep-eog forward's calls."""
    model = flagship_model(variant='eog', dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device='cuda').manual_seed(4)
    xb = {c: torch.randn((BATCH, grid_length(c, HOURS)), device='cuda', generator=g).bfloat16()
          for c in VARIANTS['eog'][1]}
    fc = forward_convs(model, xb)
    print(f'bench_conv: over one eog forward ({fc["calls"]} calls), ms one call / back to back: '
          f'K1 {fc["k1"][0]:.3f} / {fc["k1"][1]:.3f}, K2 {fc["k2"][0]:.3f} / {fc["k2"][1]:.3f}', flush=True)
    del model, xb
    torch.cuda.empty_cache()
    return fc


def forward_parts(label: str) -> dict:
    """K1 and K2 over one bf16 forward's calls, the host's time per call and
    the forward with kernel statistics off and on."""
    out = {}
    model = flagship_model(dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device='cuda').manual_seed(4)
    xb = {c: torch.randn((BATCH, grid_length(c, HOURS)), device='cuda', generator=g).bfloat16() for c in SIGNALS}
    out['forward_convs'] = fc = forward_convs(model, xb)
    out['host_us_per_call'] = host_us_per_call()
    out['forward_ms'] = {}
    for on in (False, True):
        bd.KERNEL_STATS = on
        out['forward_ms']['on' if on else 'off'] = cuda_ms(lambda: model(xb), reps=3, warmup=1)
    bd.KERNEL_STATS = None
    print(f'bench_conv {label}: over one forward ({fc["calls"]} calls), ms one call / back to back: '
          f'K1 {fc["k1"][0]:.3f} / {fc["k1"][1]:.3f}, K2 {fc["k2"][0]:.3f} / {fc["k2"][1]:.3f}; host '
          f'{out["host_us_per_call"]:.2f} us per K1 call; forward ms statistics off {out["forward_ms"]["off"]:.2f}, '
          f'on {out["forward_ms"]["on"]:.2f}', flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--label', default='')
    parser.add_argument('--json', default=None)
    parser.add_argument('--dtype', default='bfloat16', choices=('bfloat16', 'float32'))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_conv needs an NVIDIA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'bench_conv {args.label}: {card}', flush=True)
    k1.build()
    out = {'label': args.label, 'card': card, 'dtype': args.dtype}
    with torch.inference_mode():
        out['shapes'] = per_shape(getattr(torch, args.dtype))
        out['eog_shapes'] = per_shape(getattr(torch, args.dtype), EOG_SHAPES)
        if args.dtype == 'bfloat16':
            out.update(forward_parts(args.label))
            out['eog_forward_convs'] = eog_forward_convs()
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f)


if __name__ == '__main__':
    main()
