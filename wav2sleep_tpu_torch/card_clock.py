"""Sample the card's SM clock and power draw while a rung of the K1 ladder runs.

    python -m wav2sleep_tpu_torch.card_clock

A kernel bound by bytes can still be held back by the card's power limit:
a card at its limit lowers its SM clock. For each rung of
``ops/conv_variants.py`` at x [8, 153,600, 128] bf16 (``copy``, ``mm1f``,
``mm3``, ``mm3s``, ``v7`` with zero halos), ``einsum`` (V3's library call,
``torch.einsum('bnc,kco->bno', x, W)``), ``k1`` (K1, ``conv_k3``, at 128 ->
128 stride 1 on the same x and W) or ``k1_flagship`` (the same conv at the
flagship's 128 -> 128 shape, x [8, 19,200, 128]), it runs the call back to back
for 3 seconds while ``nvidia-smi`` samples ``clocks.sm`` and
``power.draw`` every 200 ms. It prints the card's name and power limit,
then one JSON line per rung: the samples after the first second (the power
reading's own lag), and their minimum, median and maximum.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from . import profile_variants
from .ops import conv_k3 as k1
from .ops import conv_variants as cv
from .utils import card_line

RUNGS = ('copy', 'mm1f', 'mm3', 'mm3s', 'v7', 'einsum', 'k1', 'k1_flagship')
PERIOD_MS, LAG_S, SECONDS = 200, 1.0, 3.0


def parse(text: str) -> list[tuple[float, float]]:
    """``nvidia-smi --format=csv,noheader`` lines of ``clocks.sm,power.draw``
    ("1980 MHz, 460.07 W") as (MHz, W) pairs."""
    pairs = []
    for line in text.splitlines():
        if line.strip():
            mhz, watts = (field.split()[0] for field in line.split(','))
            pairs.append((float(mhz), float(watts)))
    return pairs


def sample(fn, seconds: float) -> list[tuple[float, float]]:
    """(MHz, W) every PERIOD_MS while fn runs back to back for ``seconds``,
    without the first LAG_S; after one call outside the window (a first
    call builds the kernel library)."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw', '--format=csv,noheader',
                            '-lms', str(PERIOD_MS)], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.time()
        while time.time() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    return parse(out)[int(LAG_S * 1000 / PERIOD_MS):]


def run(tb: int = 2048) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError('card_clock: needs an NVIDIA card (nvidia-smi samples its clock)')
    print(f'nvidia-smi: {card_line()}', flush=True)
    x, w = profile_variants.inputs(8, 153_600, 'cuda')
    zeros = torch.zeros((8, 153_600 // tb * 8, cv.D), dtype=torch.bfloat16, device='cuda')
    x_flagship = x[:, :19_200].contiguous()
    calls = {
        'copy': lambda: cv.copy(x, tb), 'mm1f': lambda: cv.mm1f(x, w[0], tb), 'mm3': lambda: cv.mm3(x, w, tb),
        'mm3s': lambda: cv.mm3s(x, w, tb), 'v7': lambda: cv.v7(x, zeros, zeros, w, tb),
        'einsum': lambda: torch.einsum('bnc,kco->bno', x, w),
        'k1': lambda: k1.conv_k3(x, w), 'k1_flagship': lambda: k1.conv_k3(x_flagship, w),
    }
    results = []
    with torch.inference_mode():
        for rung in RUNGS:
            samples = sample(calls[rung], SECONDS)
            mhz, watts = [s[0] for s in samples], [s[1] for s in samples]
            row = {'rung': rung, 'samples': samples,
                   'sm_mhz': [min(mhz), statistics.median(mhz), max(mhz)],
                   'power_w': [min(watts), statistics.median(watts), max(watts)]}
            print(json.dumps(row), flush=True)
            results.append(row)
    return results


if __name__ == '__main__':
    run()
