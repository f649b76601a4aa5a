"""The device's idle gaps in one cell's traced window, labelled by the
program's spans on every thread, and the clock the spans share with the
trace.

    python3 benchmark/span_gaps.py --workload <cell> --seed <n> --seconds <s>

Sets the cell up as ``run.py`` does and runs its window under the
benchmark's ``Profile``; the program's recorder
(``wav2sleep_tpu_torch.tracing``) follows the profiler. Prints one JSON
line: the window's device busy and idle seconds; the idle gaps labelled as
``Trace`` labels them (the innermost host operation of the threads the
profiler records) and by program span (``label_gaps``), and every gap by
its length (``gaps_by_size``); each span's count and host ms; the offsets
between each main-thread span and the profiler's event of the
``record_function`` it opens; and the per-layer metrics of the run. The
check against the reference is not run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def innermost(spans) -> list[tuple[np.ndarray, list[str]]]:
    """Per thread, in the order of its first span, where each stretch of
    the innermost open span begins and its name ('' where none is open)."""
    threads: dict[int, list] = {}
    for sp in sorted(spans, key=lambda sp: sp.start_ns):
        threads.setdefault(sp.thread, []).append(sp)
    out = []
    for mine in threads.values():
        # Spans of a thread nest: at one time an end goes before a start,
        # an inner end before an outer one, an outer start before an inner one.
        bounds = sorted([(sp.start_ns, 1, -sp.end_ns, i) for i, sp in enumerate(mine)]
                        + [(sp.end_ns, 0, -sp.start_ns, i) for i, sp in enumerate(mine)])
        stack, at, names = [], [], []
        for t, is_start, _, i in bounds:
            if is_start:
                stack.append(i)
            else:
                stack.remove(i)
            at.append(t)
            names.append(mine[stack[-1]].name if stack else '')
        out.append((np.array(at, np.int64), names))
    return out


def labels_at(stretches, mids: np.ndarray) -> list[str]:
    """The innermost span of each thread open at each of ``mids``, joined
    with ' + ' ('' where none is)."""
    parts = []
    for at, names in stretches:
        j = np.searchsorted(at, mids, side='right') - 1
        parts.append([names[k] if k >= 0 else '' for k in j.tolist()])
    return [' + '.join(p for p in row if p) for row in zip(*parts)] if parts else [''] * len(mids)


def label_gaps(gaps, spans, fallback, examined: int, top: int) -> list:
    """Seconds of the ``examined`` longest gaps ``[(start_ns, end_ns)]``,
    summed by label: the innermost program span open at each gap's middle on
    each thread, joined with ' + ' in the order of each thread's first span;
    ``fallback(gap)`` labels a gap under no program span."""
    if not gaps:
        return []
    g = np.array(gaps, np.int64)
    g = g[np.argsort(g[:, 0] - g[:, 1], kind='stable')[:examined]]
    out: dict[str, float] = {}
    for (a, b), label in zip(g.tolist(), labels_at(innermost(spans), (g[:, 0] + g[:, 1]) // 2)):
        label = label or fallback((a, b))
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


SIZES = ((0, 10_000, 'under 10 us'), (10_000, 100_000, '10-100 us'), (100_000, 1_000_000, '0.1-1 ms'),
         (1_000_000, None, 'over 1 ms'))


def gaps_by_size(gaps, spans, top: int = 3) -> dict:
    """Every gap, by its length: the count, the idle seconds and the
    labels (as ``label_gaps``, 'none' under no program span) that hold the
    most of them."""
    if not gaps:
        return {}
    g = np.array(gaps, np.int64)
    d = g[:, 1] - g[:, 0]
    labels = np.array(labels_at(innermost(spans), (g[:, 0] + g[:, 1]) // 2), dtype=object)
    out = {}
    for lo, hi, name in SIZES:
        sel = (d >= lo) & (d < hi) if hi is not None else d >= lo
        by: dict[str, float] = {}
        for label, dur in zip(labels[sel].tolist(), d[sel].tolist()):
            by[label or 'none'] = by.get(label or 'none', 0.0) + dur * 1e-9
        out[name] = {'gaps': int(sel.sum()), 'idle_s': float(d[sel].sum()) * 1e-9,
                     'labels': [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]}
    return out


def clock_offsets(spans, events, thread: int) -> dict:
    """Offsets in us between each span of ``thread`` and the profiler's
    event of the same name that starts nearest it: start and end."""
    twins: dict[str, np.ndarray] = {}
    for e in events:
        if e.is_user_annotation() and e.duration_ns() > 0:
            twins.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    twins = {k: np.array(sorted(v), np.int64) for k, v in twins.items()}
    ds, de = [], []
    for s in spans:
        iv = twins.get(s.name)
        if s.thread != thread or iv is None:
            continue
        j = int(np.argmin(np.abs(iv[:, 0] - s.start_ns)))
        ds.append((s.start_ns - iv[j, 0]) * 1e-3)
        de.append((iv[j, 1] - s.end_ns) * 1e-3)
    if not ds:
        return {}
    return {'spans': len(ds), 'start_us_median': statistics.median(ds), 'start_us_max': max(ds, key=abs),
            'end_us_median': statistics.median(de), 'end_us_max': max(de, key=abs)}


def span_table(spans) -> dict:
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {'count': 0, 'host_s': 0.0})
        row['count'] += 1
        row['host_s'] += (s.end_ns - s.start_ns) * 1e-9
    for row in out.values():
        row['host_ms_each'] = 1e3 * row['host_s'] / row['count']
    return out


def report(root: Path, workload: str, seed: int, seconds: float, device: str = 'cuda') -> dict:
    """Set up one run of ``workload``, trace its window and read it."""
    import threading

    from torch.autograd import DeviceType

    from benchmark import harness
    from benchmark.trace import GAPS_EXAMINED, TOP, Profile, Trace, _label_gaps, _union
    from wav2sleep_tpu_torch import tracing

    run = harness.open_run(root, workload, seed, device)
    gen = harness.load_module(run.bench / 'traffic' / f"{run.mix['generator']}.py")
    state = gen.setup(run)
    run.sync()
    with Profile(run.cuda) as prof:
        tw = time.perf_counter()
        out = gen.window(state, seconds)
        run.sync()
        window_s = time.perf_counter() - tw
    run.spans = spans = tracing.collect()
    run.counters = out['counters']
    run.trace = Trace(prof.events, window_s)
    # The gaps as ``Trace`` finds them, for the program spans' labels.
    host = [e for e in prof.events if e.device_type() == DeviceType.CPU and e.duration_ns() > 0]
    span_names = {e.name() for e in host if e.is_user_annotation()}
    dev = [e for e in prof.events if e.device_type() != DeviceType.CPU and not e.is_user_annotation()
           and e.name() not in span_names]
    starts = np.array([e.start_ns() for e in dev], np.int64)
    _, gaps = _union(starts, starts + np.array([e.duration_ns() for e in dev], np.int64))
    examined = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_EXAMINED]

    def kineto_label(gap):
        return 'kineto: ' + _label_gaps([gap], host)[0][0]

    return {
        'workload': workload, 'seed': seed, 'window_s': window_s, 'busy_s': run.trace.busy_s,
        'idle_s': window_s - run.trace.busy_s, 'gaps': len(gaps),
        'examined_idle_s': sum((b - a) * 1e-9 for a, b in examined),
        'idle_gaps_kineto': run.trace.idle_gaps,
        'idle_gaps_spans': label_gaps(gaps, spans, kineto_label, GAPS_EXAMINED, TOP),
        'idle_by_gap_size': gaps_by_size(gaps, spans),
        'spans': span_table(spans),
        'clock_main_thread': clock_offsets(spans, prof.events, threading.get_native_id()),
        'per_layer': harness.per_layer_metrics(run),
        'counters': {k: v for k, v in run.counters.items() if isinstance(v, (int, float))},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    print(json.dumps(report(ROOT, args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
