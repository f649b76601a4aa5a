"""Seeded inputs of the benchmark: night waves, the serving transport's q8
codes and the training labels, all made on the run's device from the seed.

Every seed gets the same set of night lengths and absent signals, in
another order, so the work of a run does not depend on its seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MU = 255.0
# Base frequency (Hz) of each signal's wave: heart rate for ECG and PPG,
# breathing for the belts, slow eye movements for EOG.
BASE_HZ = {'ECG': 1.1, 'PPG': 1.1, 'ABD': 0.25, 'THX': 0.25, 'EOG-L': 0.3, 'EOG-R': 0.3}
EPOCH_SECONDS = 30.0


def night_epochs(n: int, lo: int, hi: int, seed: int) -> list[int]:
    """``n`` night lengths in epochs, evenly spread over [lo, hi], in a
    seeded order."""
    lengths = np.linspace(lo, hi, n).round().astype(int)
    return [int(v) for v in np.random.default_rng(seed).permutation(lengths)]


def waves(gen: torch.Generator, n: int, spe: int, epochs: int, signal: str, device) -> torch.Tensor:
    """f32 [n, epochs * spe]: two harmonics of a per-night frequency near the
    signal's base rate, at a per-night phase, plus white noise. Amplitude,
    rate and noise level change from epoch to epoch, as a night's signals
    change with its sleep stages, so the model's outputs vary along the
    night."""
    T = epochs * spe
    fs = spe / EPOCH_SECONDS

    def per_epoch(lo: float, hi: float) -> torch.Tensor:
        v = lo + (hi - lo) * torch.rand((n, epochs), generator=gen, device=device)
        return v.repeat_interleave(spe, dim=1)

    f = BASE_HZ[signal] * (0.8 + 0.4 * torch.rand((n, 1), generator=gen, device=device))
    ph = 2 * math.pi * torch.rand((n, 1), generator=gen, device=device)
    t = torch.arange(T, device=device, dtype=torch.float32) / fs
    w = 2 * math.pi * f * t * per_epoch(0.7, 1.4)
    x = per_epoch(0.3, 2.0) * (torch.sin(w + ph) + 0.5 * torch.sin(2 * w + 2 * ph))
    return x + per_epoch(0.05, 1.0) * torch.randn((n, T), generator=gen, device=device)


def mulaw_q8(d: torch.Tensor, vmax: torch.Tensor) -> torch.Tensor:
    """int8 mu-law codes of digital values ``d`` [n, T] against each row's
    peak ``vmax`` [n]: round(sign(d) 127 log(1 + 255 |d| / V) / log(256))."""
    x = torch.clamp(d.abs().double() / vmax[:, None].double(), 0.0, 1.0)
    q = torch.round(127.0 * torch.log1p(MU * x) / math.log1p(MU))
    return (torch.sign(d) * q).to(torch.int8)


def serving_pool(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The serving mix's pool of nights as q8 rows on the model grid, on the
    host: ``codes[sig]`` int8 [P, T], ``meta[sig]`` a dict of [P] arrays
    (a, b, vmax, n_valid, n_pad, present), ``epochs`` [P]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    P = mix['pool_nights']
    S = cfg['epochs_per_night']
    lo, hi = (round(h * 3600 / EPOCH_SECONDS) for h in mix['night_hours'])
    epochs = night_epochs(P, lo, hi, seed)
    absent_sig = mix.get('absent_signal')
    n_absent = P // mix['absent_every'] if absent_sig in cfg['signals'] else 0
    absent = set(np.random.default_rng(seed + 1).permutation(P)[:n_absent].tolist())
    codes, meta = {}, {}
    for sig, spe in cfg['signals'].items():
        T = S * spe
        x = waves(gen, P, spe, S, sig, device)
        A = 400.0 + 1600.0 * torch.rand((P, 1), generator=gen, device=device)
        d = torch.round(x * A)
        n_pad = torch.tensor([e * spe for e in epochs], device=device)
        # The resampler's last grid points before the night's end carry no
        # sample: n_valid is 0-3 short of n_pad.
        n_valid = n_pad - torch.randint(0, 4, (P,), generator=gen, device=device)
        iot = torch.arange(T, device=device)[None, :]
        d = torch.where(iot < n_valid[:, None], d, 0.0)
        vmax = d.abs().amax(dim=1).clamp_min(1.0)
        q = mulaw_q8(d, vmax)
        present = torch.tensor([i not in absent or sig != absent_sig for i in range(P)], device=device)
        q = torch.where(present[:, None], q, torch.zeros_like(q))
        a = (0.5 + 1.5 * torch.rand((P,), generator=gen, device=device)) / A[:, 0]
        b = 0.2 * torch.rand((P,), generator=gen, device=device) - 0.1
        codes[sig] = q.cpu().numpy()
        meta[sig] = {
            'a': torch.where(present, a, 0.0).float().cpu().numpy(),
            'b': torch.where(present, b, 0.0).float().cpu().numpy(),
            'vmax': torch.where(present, vmax, 1.0).float().cpu().numpy(),
            'n_valid': torch.where(present, n_valid, 0).int().cpu().numpy(),
            'n_pad': torch.where(present, n_pad, 0).int().cpu().numpy(),
            'present': present.cpu().numpy(),
        }
    return {'codes': codes, 'meta': meta, 'epochs': np.asarray(epochs, np.int64)}


def training_pool(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The training mix's pool: z-scored f32 rows of full-length nights on
    the host, zero past each night's end (``x[sig]`` [P, T]), and labels
    [P, S] in 0..K-1 with -1 past the night's end and for a share of
    unscored epochs, as f32 (the data module's label dtype). A share
    ``night_class_share`` of a night's epochs take a class of the night's
    own, so nights pull the model different ways, as nights of different
    sleepers do."""
    gen = torch.Generator(device=device).manual_seed(seed)
    P = mix['pool_nights']
    S = cfg['epochs_per_night']
    lo, hi = (round(h * 3600 / EPOCH_SECONDS) for h in mix['night_hours'])
    epochs = night_epochs(P, lo, hi, seed)
    ep = torch.tensor(epochs, device=device)
    x = {}
    for sig, spe in cfg['signals'].items():
        w = waves(gen, P, spe, S, sig, device)
        iot = torch.arange(S * spe, device=device)[None, :]
        inside = iot < (ep * spe)[:, None]
        cnt = inside.sum(dim=1, keepdim=True)
        mu = torch.where(inside, w, 0.0).sum(dim=1, keepdim=True) / cnt
        sd = torch.sqrt(torch.where(inside, (w - mu) ** 2, 0.0).sum(dim=1, keepdim=True) / (cnt - 1))
        x[sig] = torch.where(inside, (w - mu) / sd, 0.0).float().cpu().numpy()
    K = cfg['num_classes']
    y = torch.randint(0, K, (P, S), generator=gen, device=device)
    own = torch.randint(0, K, (P, 1), generator=gen, device=device).expand(P, S)
    y = torch.where(torch.rand((P, S), generator=gen, device=device) < mix.get('night_class_share', 0.0), own, y)
    unscored = torch.rand((P, S), generator=gen, device=device) < mix['unscored_share']
    y = torch.where(unscored | (torch.arange(S, device=device)[None, :] >= ep[:, None]), -1, y)
    return {'x': x, 'y': y.float().cpu().numpy(), 'epochs': np.asarray(epochs, np.int64)}
