"""Serving traffic: a folder of nights that never runs dry, through the
program's q8 streaming pipeline.

Set-up makes the configuration's weights and a pool of seeded nights as q8
rows on the model grid (``inputs.serving_pool``), builds
``StreamingPipelineQ8`` with the mix's batch and precision and a replay
extractor (the pipeline's ``extractor=`` hook: it copies a pool night's
codes and metadata into the slot's row, where the EDF extractor would
resample a file), and serves two batches to warm every shape. The window
submits nights in seeded passes over the pool and stops taking results
at the first whole batch after its seconds are up; ``serve_rec_per_h`` is
the nights yielded over the time from the first submission to the last
hypnogram.

The check takes a seeded sample of the yielded nights, the longest night of
the pool among them, and runs the plain reference (``reference.model``, in
f32) on each night's codes, decoded by the reference itself. The number
compared is the widest gap by which the logit of a served class lies below
the reference's best logit at that epoch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.reference import model as ref
from benchmark.reference.transport import q8_serving_input


class Replay:
    """``extract_into`` of a pool night: night ``k`` of the window is pool
    night ``order[k]``."""

    def __init__(self, pool: dict, order: np.ndarray):
        self.pool, self.order = pool, order

    def extract_into(self, fp: str, rows: dict, meta: dict, row: int) -> int:
        i = int(self.order[int(fp)])
        for sig, codes in self.pool['codes'].items():
            np.copyto(rows[sig][row], codes[i])
            m = self.pool['meta'][sig]
            meta[sig][row] = tuple(m[f][i] for f in meta[sig].dtype.names)
        return int(self.pool['epochs'][i])


class State:
    pass


def _order(P: int, passes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(P) for _ in range(passes)])


def setup(run: harness.Run) -> State:
    from wav2sleep_tpu_torch.pipeline import StreamingPipelineQ8

    cfg, mix = run.cfg, run.mix
    clock = harness.Stopwatch()
    s = State()
    s.run = run
    s.weights = ref.make_weights(cfg, run.seed, run.device)
    clock.lap('weights')
    s.pool = inputs.serving_pool(cfg, mix, run.seed, run.device)
    P = mix['pool_nights']
    s.order = _order(P, mix['max_passes'], run.seed)
    clock.lap('pool')
    model = harness.program_model(run, s.weights)
    s.pipe = StreamingPipelineQ8(model, list(cfg['signals']), batch_size=mix['batch_size'],
                                 max_length_hours=cfg['max_length_hours'], precision=mix['precision'],
                                 device=run.device, extractor=Replay(s.pool, s.order))
    clock.lap('model and pipeline')
    s.pipe.warmup()
    clock.lap('first forward (kernel build or load)')
    warm = [str(k) for k in range(2 * mix['batch_size'])]
    for _ in s.pipe.run(warm):
        pass
    s.first = len(warm)
    clock.lap('two batches served')
    clock.report()
    return s


def window(s: State, seconds: float) -> dict:
    from wav2sleep_tpu_torch.ops import conv_k3

    names = [str(k) for k in range(s.first, len(s.order))]
    s.pipe.fill_seconds = 0.0
    launches0 = conv_k3.LAUNCHES
    served: list[tuple[int, np.ndarray]] = []
    it = s.pipe.run(names)
    t0 = time.perf_counter()
    t_last = t0
    B = s.run.mix['batch_size']
    for fp, hyp in it:
        served.append((int(fp), hyp))
        t_last = time.perf_counter()
        # A batch's nights arrive together: the window takes the whole batch.
        if t_last - t0 >= seconds and len(served) % B == 0:
            break
    else:
        raise RuntimeError(f'the pool ran dry after {len(served)} nights: raise max_passes')
    it.close()
    s.run.sync()
    s.served = served
    last = served[-1][0] - s.first + 1
    span = t_last - t0
    return {
        'metrics': {'serve_rec_per_h': len(served) * 3600.0 / span},
        'attempted': last,
        'failed': last - len(served),
        'counters': {'window_s': span, 'batches': -(-len(served) // B), 'nights': len(served),
                     'fill_seconds': s.pipe.fill_seconds, 'k1_launches': conv_k3.LAUNCHES - launches0,
                     'batch': B, 'dtype': s.run.mix['precision']},
    }


def sample(s: State) -> list[tuple[int, np.ndarray]]:
    """A seeded sample of the served nights, one of the pool's longest
    nights among them."""
    mix = s.run.mix
    rng = np.random.default_rng(s.run.seed + 7)
    n = min(mix['check_nights'], len(s.served))
    picked = set(rng.choice(len(s.served), size=n, replace=False).tolist())
    longest = int(np.argmax(s.pool['epochs']))
    if not any(int(s.order[s.served[j][0]]) == longest for j in picked):
        hits = [j for j, (k, _) in enumerate(s.served) if int(s.order[k]) == longest]
        if hits:
            picked.add(hits[0])
    return [s.served[j] for j in sorted(picked)]


def reference_logits(s: State, idx: list[int], precision: str = 'f32') -> torch.Tensor:
    """Logits [n, S, K] of pool nights ``idx`` by the plain reference."""
    x = {sig: q8_serving_input(s.pool, sig, idx, s.run.device) for sig in s.run.cfg['signals']}
    with torch.no_grad():
        return ref.forward(s.weights, x, s.run.cfg, precision)


def gaps(s: State, picked, precision_of_served: str | None = None) -> dict:
    """Over the picked nights' epochs, the gap below the reference's best
    logit of each served class: its widest (``logit_gap``), its mean
    (``mean_gap``) and the percent of epochs where it is not 0
    (``flip_share``); and the count of hypnograms of a wrong length or with
    a class out of range. ``precision_of_served`` replaces the program's
    classes by the argmax of the reference in that precision (the
    control)."""
    worst, bad, total, flips, n_epochs = 0.0, 0, 0.0, 0, 0
    block = s.run.mix['batch_size']
    for j in range(0, len(picked), block):
        part = picked[j:j + block]
        idx = [int(s.order[k]) for k, _ in part]
        logits = reference_logits(s, idx).float()
        other = reference_logits(s, idx, precision_of_served) if precision_of_served else None
        for r, ((k, hyp), i) in enumerate(zip(part, idx)):
            n = int(s.pool['epochs'][i])
            if len(hyp) != n:
                bad += 1
                continue
            lg = logits[r, :n]
            cls = other[r, :n].argmax(dim=-1) if other is not None else torch.as_tensor(hyp, device=lg.device).long()
            if bool(((cls < 0) | (cls >= lg.shape[-1])).any()):
                bad += 1
                continue
            gap = lg.max(dim=-1).values - lg.gather(-1, cls[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            total += float(gap.double().sum())
            flips += int((gap > 0).sum())
            n_epochs += n
    return {'logit_gap': worst, 'mean_gap': total / max(n_epochs, 1), 'flip_share': 100.0 * flips / max(n_epochs, 1),
            'bad_hypnograms': bad}


def check(s: State) -> dict:
    s.pipe = None
    harness.release()
    return gaps(s, sample(s))


def calibrate(s: State, seconds: float) -> dict:
    """The program's readings after a short window, and the control's: the
    reference's classes in the precision below the served one, on the same
    sample."""
    window(s, seconds)
    program = check(s)
    control = gaps(s, sample(s), harness.CONTROL[s.run.mix['precision']])
    return {'program': program, 'control': control}
