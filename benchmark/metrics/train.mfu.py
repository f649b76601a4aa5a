"""Three times the forward's model FLOPs a step (``work.wav2sleep``; the
rematerialised forward not counted) over the window, as a percent of the
card's peak in the training precision."""

from benchmark.work.peaks import PEAK_FLOPS
from benchmark.work.wav2sleep import forward_flops


def read(run):
    c = run.counters
    if run.trace is None or not run.cuda or not c.get('steps'):
        return None
    flops = 3 * forward_flops(run.cfg, c['batch']) * c['steps']
    return 100.0 * flops / c['window_s'] / PEAK_FLOPS[c['dtype']]
