"""Device busy time a served batch, in ms: the traced window's busy seconds
over its batches."""


def read(run):
    if run.trace is None or not run.cuda or not run.counters.get('batches') or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / run.counters['batches']
