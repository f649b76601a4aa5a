"""The benchmark's harness: finds a cell's files by name, builds what the
cell's traffic generator asks for, measures its window, reads the per-layer
metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the configuration's sizes;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, with the
  ``generator`` (``benchmark/traffic/<generator>.py``) that reads them;
- ``benchmark/workloads/<cell>.json``: the limits of the cell's compared
  numbers;
- ``benchmark/metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

A generator module has ``setup(run) -> state``, ``window(state, seconds) ->
dict`` and ``check(state) -> {name: value}``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'wav2sleep_tpu')
# The control of a precision: the reference in the nearest precision below it.
CONTROL = {'float32': 'tf32', 'bfloat16': 'fp8'}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is the JAX
    stack's or the JAX package's."""
    return sorted({m.split('.', 1)[0] for m in sys.modules} & set(FORBIDDEN))


def load_module(path: Path):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    name = 'benchmark_file_' + ''.join(c if c.isalnum() else '_' for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Run:
    """One run of one cell: what the generator and the metric readers see."""

    root: Path
    cell: str
    seed: int
    device: torch.device
    manifest: dict
    workload: dict
    cfg: dict
    mix: dict
    limits: dict
    counters: dict = field(default_factory=dict)
    trace: object = None

    @property
    def bench(self) -> Path:
        return self.root / 'benchmark'

    @property
    def cuda(self) -> bool:
        return self.device.type == 'cuda'

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


def open_run(root: Path, cell: str, seed: int, device: str) -> Run:
    manifest = read_json(root / 'BENCHMARK.json')
    by_name = {w['name']: w for w in manifest['workloads']}
    if cell not in by_name:
        raise SystemExit(f'unknown workload {cell!r}; BENCHMARK.json has {sorted(by_name)}')
    w = by_name[cell]
    conf = {c['name']: c for c in manifest['configs']}[w['config']]
    bench = root / 'benchmark'
    cfg = read_json(root / conf['file'])
    if not math.isclose(cfg['epochs_per_night'], cfg['max_length_hours'] * 120):
        raise ValueError(f"{conf['file']}: epochs_per_night must be max_length_hours * 120")
    mix = read_json(bench / 'traffic' / f"{w['traffic']}.json")
    limits = read_json(bench / 'workloads' / f'{cell}.json')['limits']
    return Run(root, cell, seed, torch.device(device), manifest, w, cfg, mix, limits)


def program_model(run: Run, weights: dict, remat: bool = False) -> torch.nn.Module:
    """The program's model of the run's configuration, made by its own
    ``build_wav2sleep`` at the configuration's widths, holding the
    benchmark's weights."""
    from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config

    cfg = run.cfg
    pcfg = flagship_config(cfg['feature_dim'], cfg['encoders']['max_channels'], cfg['variant'])
    pcfg['encoders']['remat'] = remat
    model = build_wav2sleep(**pcfg).to(run.device)
    model.load_state_dict(weights, strict=True)
    return model


class Stopwatch:
    """Seconds of each named part of a set-up, printed to standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.parts: list[str] = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f'{name} {now - self.t:.2f}')
        self.t = now

    def report(self) -> None:
        print('set-up parts (s): ' + ', '.join(self.parts), file=sys.stderr)


def release() -> None:
    """Give back the device memory of objects the caller has dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def per_layer_metrics(run: Run) -> dict:
    out = {}
    for m in run.manifest['per_layer']:
        if run.cell not in m.get('workloads', [run.cell]):
            continue
        value = load_module(run.bench / 'metrics' / f"{m['name']}.py").read(run)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def end_to_end_metrics(run: Run, measured: dict, setup_s: float) -> dict:
    out = {}
    for m in run.manifest['end_to_end']:
        if run.cell not in m.get('workloads', [run.cell]):
            continue
        value = setup_s if m['name'] == 'setup_s' else measured[m['name']]
        out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = 'cuda') -> dict:
    """Set up, measure and check one run; returns its result line's object."""
    run = open_run(root, cell, seed, device)
    gen = load_module(run.bench / 'traffic' / f"{run.mix['generator']}.py")
    print(f'set-up before the generator (interpreter, imports): {time.perf_counter() - t0:.2f} s', file=sys.stderr)
    state = gen.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t0
    if trace:
        from .trace import Profile, Trace

        with Profile(run.cuda) as prof:
            tw = time.perf_counter()
            out = gen.window(state, seconds)
            run.sync()
            window_s = time.perf_counter() - tw
        tr = time.perf_counter()
        run.trace = Trace(prof.events, window_s)
        print(f'trace: {len(prof.events)} events read in {time.perf_counter() - tr:.1f} s; device seconds '
              f'with no launch in the trace {run.trace.unlinked_s:.4f}', file=sys.stderr)
        del prof
    else:
        out = gen.window(state, seconds)
    run.counters = out['counters']
    device_info = {'platform': 'gpu' if run.cuda else 'cpu',
                   'kind': torch.cuda.get_device_name(run.device) if run.cuda else 'cpu',
                   'count': 1,
                   'memory_peak_bytes': int(torch.cuda.max_memory_reserved(run.device)) if run.cuda else 0}
    if trace:
        device_info['busy_s'] = run.trace.busy_s
        device_info['window_s'] = run.trace.window_s
    got = gen.check(state)
    checked = {k: got.get(k) for k in run.limits}  # a number the check did not give is not correct
    del state
    correct = all(v is not None and v <= run.limits[k] for k, v in checked.items())
    result = {
        'correct': bool(correct),
        'attempted': int(out['attempted']),
        'failed': int(out['failed']),
        'metrics': per_layer_metrics(run) if trace else end_to_end_metrics(run, out['metrics'], setup_s),
        'device': device_info,
    }
    if trace:
        result['breakdown'] = run.trace.breakdown()
    result['checked'] = {k: {'value': v, 'limit': run.limits[k]} for k, v in checked.items()}
    return result
