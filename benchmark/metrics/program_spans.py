"""What the readers of the program's spans share: the spans that the
program recorded in the traced window (``wav2sleep_tpu_torch.tracing``,
on while the profiler records), collected once a run, and a span's host
milliseconds per span of another name. A program without the recorder
reads as no spans."""

from __future__ import annotations


def spans(run):
    """The traced window's program spans, or None."""
    if run.trace is None:
        return None
    if getattr(run, 'spans', None) is None:
        try:
            from wav2sleep_tpu_torch import tracing
        except ImportError:
            return None
        run.spans = tracing.collect()
    return run.spans


def host_ms(run, name: str, per: str):
    """Host ms under the spans ``name`` over the count of the spans ``per``;
    None where there is neither."""
    got = spans(run)
    mine = [s.end_ns - s.start_ns for s in got or () if s.name == name]
    count = sum(1 for s in got or () if s.name == per)
    return 1e-6 * sum(mine) / count if mine and count else None
