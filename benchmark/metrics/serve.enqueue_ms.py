"""Host ms a served batch that the producer spends in ``pipeline/enqueue``,
launching the forward: beside ``serve.forward_ms``, the share of a batch's
device time the host needs to keep the card fed."""

from benchmark.metrics.program_spans import host_ms


def read(run):
    return host_ms(run, 'pipeline/enqueue', 'pipeline/launch')
