"""A copy of the benchmark at a size a CPU test run holds: the published
configurations narrowed (feature_dim 16, 16 channels, six epochs a night)
and small pools and batches; every file found by the same names."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345


def tiny_root(tmp: Path, serve_precision: str = 'bfloat16', limits: dict | None = None) -> Path:
    root = Path(tmp)
    shutil.copytree(REPO / 'benchmark', root / 'benchmark', ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    for f in (root / 'benchmark' / 'configs').glob('*.json'):
        c = json.loads(f.read_text())
        c.update(feature_dim=16, max_length_hours=0.05, epochs_per_night=6)
        c['encoders']['max_channels'] = 16
        f.write_text(json.dumps(c))
    for f in (root / 'benchmark' / 'traffic').glob('*.json'):
        m = json.loads(f.read_text())
        m['night_hours'] = [0.04, 0.05]
        if m['generator'] == 'serve_stream':
            m.update(batch_size=2, pool_nights=8, absent_every=4, check_nights=4, max_passes=50,
                     precision=serve_precision)
        else:
            m.update(batch_size=2, pool_nights=2 * m['check_steps'])
        f.write_text(json.dumps(m))
    for cell, lim in (limits or {}).items():
        (root / 'benchmark' / 'workloads' / f'{cell}.json').write_text(json.dumps({'limits': lim}))
    return root


def run(root: Path, cell: str, seed: int = SEED, seconds: float = 2.0, trace: bool = False) -> dict:
    from benchmark import harness

    return harness.run_cell(root, cell, seed, seconds, trace, time.perf_counter(), device='cpu')
