"""Readings that the limits of a cell's compared numbers are set from.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 3] [--out FILE]

For each seed, in one process: the cell's set-up, a short window where the
cell serves, and the generator's ``calibrate``: the program's readings of
each compared number, the control's (the plain reference in the precision
below the configuration's), and, for training, the fault of half the batch
left out. Prints a JSON line a seed, then the largest program reading and
the smallest control and fault readings of each number. Runs on the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 2
    rows = []
    for seed in (int(v) for v in args.seeds.split(',')):
        t0 = time.perf_counter()
        run = harness.open_run(ROOT, args.workload, seed, 'cuda')
        gen = harness.load_module(run.bench / 'traffic' / f"{run.mix['generator']}.py")
        state = gen.setup(run)
        got = gen.calibrate(state, args.seconds)
        del state
        harness.release()
        row = {'seed': seed, 'seconds': round(time.perf_counter() - t0, 1), **got}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(row) + '\n')
    summary = {'workload': args.workload, 'seeds': len(rows), 'card': torch.cuda.get_device_name(0)}
    for kind in rows[0]:
        if not isinstance(rows[0][kind], dict) or kind == 'worst_leaf':
            continue
        pick = max if kind == 'program' else min
        summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
