"""Host ms a served batch that the producer spends in ``pipeline/meta_copy``:
the q8 metadata fields copied to the card from pageable memory, a copy a
field and signal, each of which waits for the stream it is queued on."""

from benchmark.metrics.program_spans import host_ms


def read(run):
    return host_ms(run, 'pipeline/meta_copy', 'pipeline/launch')
