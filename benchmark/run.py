"""Run one cell of the benchmark of the PyTorch / CUDA port on this machine.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json``; each is a file under ``benchmark/`` (``harness.py``).
The run makes its weights and inputs from ``--seed``, warms up, measures
for ``--seconds`` seconds, checks what the window produced against the
plain reference, and prints one JSON line last on standard output; the
numbers compared, each with its limit, are the last lines on standard
error. With ``--trace 1`` the window runs under ``torch.profiler`` and the
line carries the per-layer metrics instead of the end-to-end ones.

It exits non-zero, printing no result, without a CUDA card, or when a
module of the JAX stack or the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    chips = {w['name']: w['chips'] for w in harness.read_json(ROOT / 'BENCHMARK.json')['workloads']}
    need = chips.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f'needs {need} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = harness.forbidden_modules()
    if found:
        print(f'modules of the JAX stack or package are loaded: {found}', file=sys.stderr)
        return 3
    for name, c in result['checked'].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
