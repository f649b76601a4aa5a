"""The served batches' model FLOPs (``work.wav2sleep``, from the
configuration's shapes) over the window, as a percent of the card's peak
in the serving precision."""

from benchmark.work.peaks import PEAK_FLOPS
from benchmark.work.wav2sleep import forward_flops


def read(run):
    c = run.counters
    if run.trace is None or not run.cuda or not c.get('batches'):
        return None
    flops = forward_flops(run.cfg, c['batch']) * c['batches']
    return 100.0 * flops / c['window_s'] / PEAK_FLOPS[c['dtype']]
