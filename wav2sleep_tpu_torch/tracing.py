"""Program spans: named stretches of host time at the serving and training
boundaries, on any thread, stamped on the clock of torch's profiler.

``span(name)`` marks a stretch with a ``with`` statement. Off, the default,
it tests one module-level bool and returns a shared no-op context. On, it
records the span for the calling thread, stamped with ``time.time_ns()``
(kineto stamps its host events in Unix nanoseconds too, so a span lines up
with the device's timeline in a profiler trace), and, on a thread that
torch's profiler records, enters ``torch.profiler.record_function(name)``:
device work launched under it links to it in the trace. Elsewhere the
record_function would cost a dispatcher call and record nothing.

``enable()`` and ``disable()`` turn the recorder on and off; ``collect()``
returns every thread's closed spans and clears them. ``follow_profiler()``
turns it on for a block (a function, as a decorator) run while torch's
profiler records on the calling thread: the serving stream and the training
epoch enter it, so a profiled window holds their spans without a switch of
its own. Spans stay in memory until ``collect()``.

The spans, by layer (one a batch or a step unless stated):

- ``pipeline/slot_wait``, ``pipeline/fill`` (one a night), ``pipeline/launch``
  with ``pipeline/h2d``, ``pipeline/meta_copy`` and ``pipeline/enqueue``
  inside it, and ``pipeline/put``: the serving producer thread;
  ``pipeline/result_wait`` and ``pipeline/fetch``: the consumer;
- ``trainer/load``, ``trainer/stage`` (``trainer/stage/claim``,
  ``trainer/stage/write``, ``trainer/stage/ship``), ``trainer/step`` and
  ``trainer/drain`` (one a metric read): ``Trainer.train_epoch``;
- ``train_step/inputs`` (decode, flip, masker), ``train_step/forward`` and
  ``train_step/optimizer``: the training step.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_threads: list[_Thread] = []
_local = threading.local()


class Span(NamedTuple):
    name: str
    thread: int  # the thread's native id
    parent: int  # index of the enclosing span in ``collect()``'s list, -1 for none
    start_ns: int
    end_ns: int


class _Thread:
    """One thread's open spans and closed ones not yet collected."""

    def __init__(self):
        self.thread = threading.current_thread()
        self.tid = threading.get_native_id()
        self.stack: list[_Open] = []
        self.done: list[tuple[_Open, int]] = []


def _mine() -> _Thread:
    t = getattr(_local, 't', None)
    if t is None:
        t = _local.t = _Thread()
        with _lock:
            _threads.append(t)
    return t


class _Open:
    __slots__ = ('name', 'owner', 'parent', 'fn', 'start')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = self.owner = _mine()
        self.parent = t.stack[-1] if t.stack else None
        t.stack.append(self)
        # Only a thread the profiler records keeps a record_function's event.
        self.fn = torch.profiler.record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self.fn is not None:
            self.fn.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        t = self.owner
        t.stack.pop()
        with _lock:
            t.done.append((self, end))
        return False


def span(name: str):
    """A context that records ``name`` over its block while the recorder is on."""
    if not _on:
        return _NOOP
    return _Open(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextlib.contextmanager
def follow_profiler():
    """The recorder on over the block when torch's profiler records on this
    thread and the recorder is off; as it was otherwise."""
    if _on or not torch.autograd._profiler_enabled():
        yield
        return
    enable()
    try:
        yield
    finally:
        disable()


def collect() -> list[Span]:
    """Every thread's closed spans, in the order of each thread's first
    span collected and then of start, and clears them. A span whose parent
    is still open, or was collected before, has parent -1."""
    with _lock:
        taken = []
        for t in _threads:
            if t.done:
                taken.append((t.tid, t.done))
                t.done = []
        _threads[:] = [t for t in _threads if t.thread.is_alive()]
    out: list[Span] = []
    for tid, done in taken:
        done.sort(key=lambda d: (d[0].start, -d[1]))
        index = {id(o): len(out) + i for i, (o, _) in enumerate(done)}
        out.extend(Span(o.name, tid, index.get(id(o.parent), -1), o.start, end) for o, end in done)
    return out
