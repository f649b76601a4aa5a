"""What the per-layer metric readers share: the K1 kernels' names, the
roofline share of K1 and the device's idle share."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.work import conv_k3

K1_KERNELS = json.loads((Path(__file__).with_name('kernels.json')).read_text())['k1']


def k1_roofline(run):
    """Percent of K1's device time that its bound is: the least time of the
    window's K1 calls (the launches counted by the program, at the
    configuration's shapes) over the device time of the kernels that made
    them."""
    if run.trace is None or not run.cuda:
        return None
    c = run.counters
    per_forward = len(conv_k3.calls(run.cfg, c['batch']))
    spent = run.trace.kernel_seconds(K1_KERNELS)
    if not c['k1_launches'] or not spent:
        return None
    forwards = c['k1_launches'] / per_forward
    return 100.0 * forwards * conv_k3.forward_bound_ms(run.cfg, c['batch'], c['dtype']) * 1e-3 / spent


def idle_share(run):
    if run.trace is None or not run.cuda or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
