"""Percent of the serving window the pipeline's producer spent filling
slots (``_Pipeline.fill_seconds``): near 100 the host sets the rate."""


def read(run):
    c = run.counters
    return 100.0 * c['fill_seconds'] / c['window_s'] if c.get('window_s') else None
