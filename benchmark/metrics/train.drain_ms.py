"""Host ms in ``trainer/drain`` over the window's steps: the metric read
every ``metric_fetch_every`` steps, which waits for the card."""

from benchmark.metrics.program_spans import host_ms


def read(run):
    return host_ms(run, 'trainer/drain', 'trainer/step')
