"""The profiler of the traced window and the reduction of its events: device
busy time, device time by operation and under host spans, and the device's
idle gaps by what the host was doing.

``Profile`` runs torch's kineto profiler and keeps its raw events: torch's
own ``profile`` context builds its tree of events when it stops, which for a
window of hundreds of thousands of kernels takes minutes. A span's device
time is that of the kernels and copies whose launching operation (the host
operation their ``linked_correlation_id`` names) ran on the span's thread
while the span was open, as ``key_averages`` counts it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import DeviceType

TOP = 10
GAPS_EXAMINED = 400


class Profile:
    """``with Profile(cuda) as p: ...`` leaves the window's events in ``p.events``.

    The host operations are those of the thread that opens the profile
    (the window's main thread); the device's kernels and copies are every
    thread's. Recording the host operations of the serving pipeline's
    producer thread, which launches the forward, would slow that thread and
    idle the card: the per-layer metrics would measure the profiler."""

    def __init__(self, cuda: bool):
        from torch._C._profiler import _ExperimentalConfig

        self.acts = {torch.profiler.ProfilerActivity.CPU}
        if cuda:
            self.acts.add(torch.profiler.ProfilerActivity.CUDA)
        self.config = torch.autograd.ProfilerConfig(torch.autograd.ProfilerState.KINETO, False, False, False,
                                                    False, False, _ExperimentalConfig())
        self.events = []

    def __enter__(self):
        torch.autograd._prepare_profiler(self.config, self.acts)
        torch.autograd._enable_profiler(self.config, self.acts)
        return self

    def __exit__(self, *exc):
        self.events = torch.autograd._disable_profiler().events()
        return False


def _is_launch(name: str) -> bool:
    """A CUDA API call (``cuda*``, ``cuLaunch*``): device work links to the
    operation that made the call, not to the call."""
    return name.startswith('cuda') or name.startswith('cuLaunch')


class Trace:
    """What the per-layer metrics read of one traced window."""

    def __init__(self, events, window_s: float):
        self.window_s = window_s
        host = [e for e in events if e.device_type() == DeviceType.CPU and e.duration_ns() > 0]
        span_names = {e.name() for e in host if e.is_user_annotation()}
        dev = [e for e in events if e.device_type() != DeviceType.CPU and not e.is_user_annotation()
               and e.name() not in span_names]
        dur = np.array([e.duration_ns() for e in dev], np.int64)
        starts = np.array([e.start_ns() for e in dev], np.int64)
        self.device_ops: dict[str, float] = {}
        for e, d in zip(dev, dur.tolist()):
            self.device_ops[e.name()] = self.device_ops.get(e.name(), 0.0) + d * 1e-9
        self.busy_s, gaps = _union(starts, starts + dur)
        self.idle_gaps = _label_gaps(gaps, host)
        self.spans, self.unlinked_s = _span_device_seconds(host, dev, dur, span_names)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the operations whose name contains one of ``names``."""
        return sum(s for op, s in self.device_ops.items() if any(n in op for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {'device_ops': [[k, v] for k, v in ops], 'idle_gaps': self.idle_gaps}


def _span_device_seconds(host, dev, dur, span_names) -> tuple[dict, float]:
    """Device seconds under each host span, and the device seconds whose
    launch the trace does not hold."""
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id()) for e in host
                if e.correlation_id() > 0 and not _is_launch(e.name())}
    linked = [launches.get(e.linked_correlation_id()) for e in dev]
    found = np.array([x is not None for x in linked], bool)
    unlinked = float(dur[~found].sum()) * 1e-9 if dur.size else 0.0
    t = np.array([x[0] if x else -1 for x in linked], np.int64)
    tid = np.array([x[1] if x else -1 for x in linked], np.int64)
    out: dict[str, float] = {}
    spans = [e for e in host if e.is_user_annotation() and e.name() in span_names]
    for name in sorted(span_names):
        total = 0
        mine = [e for e in spans if e.name() == name]
        for th in {e.start_thread_id() for e in mine}:
            iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in mine if e.start_thread_id() == th)
            s = np.array([a for a, _ in iv], np.int64)
            f = np.array([b for _, b in iv], np.int64)
            sel = np.flatnonzero(found & (tid == th))
            i = np.searchsorted(s, t[sel], side='right') - 1
            inside = (i >= 0) & (t[sel] <= f[np.maximum(i, 0)])
            total += int(dur[sel[inside]].sum())
        out[name] = total * 1e-9
    return out, unlinked


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[float, list[tuple[int, int]]]:
    """Seconds covered by the intervals, and the gaps between them."""
    if starts.size == 0:
        return 0.0, []
    order = np.argsort(starts, kind='stable')
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    block_start = s[first]
    block_end = np.append(reach[first[1:] - 1], reach[-1])
    busy = float((block_end - block_start).sum()) * 1e-9
    gaps = list(zip(block_end[:-1].tolist(), block_start[1:].tolist()))
    return busy, gaps


def _label_gaps(gaps, host) -> list:
    """Seconds of the longest idle gaps, summed by the innermost host
    operation or span running at each gap's middle."""
    if not gaps or not host:
        return []
    g = np.array(gaps, np.int64)
    longest = np.argsort(g[:, 0] - g[:, 1])[:GAPS_EXAMINED]
    hs = np.array([e.start_ns() for e in host], np.int64)
    he = hs + np.array([e.duration_ns() for e in host], np.int64)
    dur = he - hs
    names = [e.name() for e in host]
    out: dict[str, float] = {}
    for i in longest:
        a, b = g[i]
        mid = (a + b) // 2
        hit = np.flatnonzero((hs <= mid) & (he >= mid))
        label = names[hit[np.argmin(dur[hit])]] if hit.size else 'no host op'
        out[label] = out.get(label, 0.0) + (b - a) * 1e-9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:TOP]]
