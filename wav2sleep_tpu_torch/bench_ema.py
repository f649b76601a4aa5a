"""Time K3, the causal-EMA kernel of this checkout, on one NVIDIA card.

    python -m wav2sleep_tpu_torch.bench_ema [--label NAME] [--json FILE]

For A/Bs across versions of ``csrc/ema_norm.cu``: it uses only functions the
package has had since K3 was ported (``ema_normalize``, ``grid_length``,
``settings``), so a copy of this file placed in an older checkout's package
times that checkout's kernel. Run the versions in one call, in the order A,
B, B, A. On one serving batch's rows (8 ten-hour nights x 4 modalities, each
at its grid rate, one launch) it prints, and writes to ``--json``: the
kernel's time per forward (CUDA events, median of 5), the nanoseconds per
step of the longest row that follow from it, and each modality alone.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from . import settings
from .bench_conv import cuda_ms
from .ops import ema_norm
from .pipeline import grid_length

SIGNALS = ('ECG', 'PPG', 'ABD', 'THX')
BATCH, HOURS = 8, 10.0


def serving_rows(seed: int) -> list:
    """One serving batch of f32 rows per modality, on the card: 8 ten-hour
    nights at each modality's grid rate; a drifting oscillation plus noise,
    with a few outliers."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    rows = []
    for col in SIGNALS:
        n = grid_length(col, HOURS)
        t = torch.arange(n, device='cuda', dtype=torch.float32) / n
        amp = torch.rand((BATCH, 1), device='cuda', generator=g) * 2 + 0.1
        freq = torch.rand((BATCH, 1), device='cuda', generator=g) * 4000 + 500
        x = amp * torch.sin(freq * t) + 0.5 * torch.sin(7 * t) + 0.2 * torch.randn((BATCH, n), device='cuda', generator=g)
        spikes = torch.randint(0, n, (BATCH, 4), device='cuda', generator=g)
        x.scatter_(1, spikes, 25.0)
        rows.append(x.contiguous())
    return rows


def rates() -> tuple[list[float], dict]:
    """Each modality's sampling rate, and the serving path's time constants."""
    fss = [settings.COLS_TO_SAMPLES_PER_EPOCH[c] / settings.EPOCH_SECONDS for c in SIGNALS]
    args = dict(tau_seconds=settings.CAUSAL_NORM_TAU_SECONDS,
                baseline_tau_seconds=settings.CAUSAL_NORM_BASELINE_TAU_SECONDS)
    return fss, args


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--label', default='')
    parser.add_argument('--json', default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('bench_ema needs an NVIDIA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    ema_norm.build()
    fss, kw = rates()
    xs = serving_rows(seed=3)
    longest = max(x.shape[1] for x in xs)
    ms = cuda_ms(lambda: ema_norm.ema_normalize(xs, fss, **kw), reps=5, warmup=1)
    alone = [cuda_ms(lambda: ema_norm.ema_normalize([x], [fs], **kw), reps=3, warmup=1) for x, fs in zip(xs, fss)]
    out = {'label': args.label, 'card': card, 'forward_ms': ms, 'ns_per_step': 1e6 * ms / longest,
           'longest_row': longest, 'per_modality_ms': dict(zip(SIGNALS, alone))}
    print(f'bench_ema {args.label}: {card}; K3 over one forward\'s {sum(x.shape[0] for x in xs)} rows {ms:.3f} ms, '
          f'{out["ns_per_step"]:.2f} ns per step of the longest row ({longest}); alone: '
          + ', '.join(f'{c} {t:.3f}' for c, t in zip(SIGNALS, alone)), flush=True)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f)


if __name__ == '__main__':
    main()
