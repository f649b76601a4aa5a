"""Host ms a training step in ``trainer/stage``: the next batch padded,
written into a ring slot (cast or encoded), and copied to the card, after
the claim of a slot whose last copy has ended."""

from benchmark.metrics.program_spans import host_ms


def read(run):
    return host_ms(run, 'trainer/stage', 'trainer/step')
