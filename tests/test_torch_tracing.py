"""The port's program spans (``wav2sleep_tpu_torch.tracing``) on the CPU: off
they record nothing and cost one bool test; on they nest per thread, are
collected from every thread, and share the clock of the profiler's event
that each opens; the serving stream and the trainer record their spans once
a batch or a step, and turn the recorder on while torch's profiler records."""

import sys
import threading
import timeit

import numpy as np
import pytest
import torch

from benchmark.trace import Profile
from wav2sleep_tpu_torch import tracing
from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config
from wav2sleep_tpu_torch.pipeline import _Pipeline, _Slot
from wav2sleep_tpu_torch.train.loop import Trainer

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def names(spans, thread=None):
    return [s.name for s in spans if thread is None or s.thread == thread]


def test_off_records_nothing_and_returns_the_shared_noop():
    assert tracing.span('a') is tracing.span('b') is tracing._NOOP
    with tracing.span('a'):
        with tracing.span('b'):
            pass
    assert tracing.collect() == []


def test_an_off_span_costs_under_a_microsecond():
    def once():
        with tracing.span('pipeline/fill'):
            pass

    n = 20_000
    best = min(timeit.repeat(once, number=n, repeat=7)) / n
    assert best < 1e-6, f'{best * 1e9:.0f} ns a call'


def test_on_nests_per_thread_and_collects_every_thread():
    tracing.enable()
    with tracing.span('outer'):
        with tracing.span('inner'):
            pass
        with tracing.span('second'):
            pass

    def other():
        with tracing.span('t/outer'):
            with tracing.span('t/inner'):
                pass

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with tracing.span('root'):
        pass
    tracing.disable()
    spans = tracing.collect()
    main = threading.get_native_id()
    assert names(spans, main) == ['outer', 'inner', 'second', 'root']
    assert sorted(names(spans)) == sorted(['outer', 'inner', 'second', 'root', 't/outer', 't/inner'])
    (worker,) = {s.thread for s in spans} - {main}
    assert names(spans, worker) == ['t/outer', 't/inner']
    by = {s.name: s for s in spans}
    assert [by[n].parent for n in ('outer', 'root', 't/outer')] == [-1, -1, -1]
    for child, parent in (('inner', 'outer'), ('second', 'outer'), ('t/inner', 't/outer')):
        p = spans[by[child].parent]
        assert p.name == parent
        assert p.start_ns <= by[child].start_ns <= by[child].end_ns <= p.end_ns
    assert tracing.collect() == []


def test_a_span_still_open_is_kept_for_the_next_collect():
    tracing.enable()
    with tracing.span('open'):
        with tracing.span('closed'):
            pass
        first = tracing.collect()
    second = tracing.collect()
    assert [(s.name, s.parent) for s in first] == [('closed', -1)]
    assert [(s.name, s.parent) for s in second] == [('open', -1)]


def test_threads_recording_while_spans_are_collected_lose_none():
    per, workers = 300, 12
    tracing.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got = []
    try:
        def work():
            for _ in range(per):
                with tracing.span('w/outer'):
                    with tracing.span('w/inner'):
                        pass

        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            got += tracing.collect()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    got += tracing.collect()
    assert names(got).count('w/outer') == names(got).count('w/inner') == per * workers


def test_a_span_enters_a_record_function_only_where_the_profiler_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    tracing.enable()
    with tracing.span('unprofiled'):
        pass
    with Profile(cuda=False):
        with tracing.span('profiled'):
            pass
    tracing.disable()
    assert entered == ['profiled'] and names(tracing.collect()) == ['unprofiled', 'profiled']


def test_a_span_shares_the_clock_of_its_profiler_event():
    with Profile(cuda=False) as prof:
        tracing.enable()
        with tracing.span('clock/probe'):
            torch.ones(64).sum()
        tracing.disable()
    (mine,) = tracing.collect()
    (theirs,) = [e for e in prof.events if e.name() == 'clock/probe' and e.is_user_annotation()]
    start, end = theirs.start_ns(), theirs.start_ns() + theirs.duration_ns()
    assert abs(mine.start_ns - start) < 1e6 and abs(mine.end_ns - end) < 1e6, (mine, start, end)


class FakePipeline(_Pipeline):
    """``_Pipeline``'s stream over slots of one signal: a fill writes the
    night's number, a launch returns the slot's rows."""

    def __init__(self, batch_size: int):
        super().__init__(torch.nn.Identity(), ['ECG'], batch_size, 0.05, 'cpu')
        self._slots = [_Slot({'ECG': 6}, batch_size, torch.float32, False) for _ in range(2)]

    def _fill(self, slot, fp, row):
        slot.rows_np['ECG'][row] = float(fp)
        return 6

    def _launch(self, slot):
        return slot.rows['ECG'].clone()


PRODUCER = ['pipeline/slot_wait', 'pipeline/fill', 'pipeline/fill', 'pipeline/launch', 'pipeline/put']


def check_stream(spans, batches):
    main = threading.get_native_id()
    (producer,) = {s.thread for s in spans} - {main}
    want = PRODUCER * batches
    del want[-3]  # the last batch holds one night
    assert names(spans, producer) == want
    assert names(spans, main) == ['pipeline/result_wait', 'pipeline/fetch'] * batches + ['pipeline/result_wait']


def test_the_stream_records_producer_and_consumer_spans_once_a_batch():
    pipe = FakePipeline(batch_size=2)
    tracing.enable()
    out = list(pipe.run([str(k) for k in range(5)]))
    tracing.disable()
    assert [fp for fp, _ in out] == [str(k) for k in range(5)]
    check_stream(tracing.collect(), batches=3)


def test_the_stream_records_while_the_profiler_does():
    pipe = FakePipeline(batch_size=2)
    list(pipe.run(['0', '1']))
    assert tracing.collect() == []
    with Profile(cuda=False) as prof:
        list(pipe.run([str(k) for k in range(5)]))
    assert not tracing._on
    check_stream(tracing.collect(), batches=3)
    annotations = {e.name() for e in prof.events if e.is_user_annotation()}
    assert {'pipeline/result_wait', 'pipeline/fetch'} <= annotations


class Loader:
    """The data module ``Trainer.train_epoch`` reads: ``steps`` seeded host
    batches of two nights."""

    batch_size = 2
    device = torch.device('cpu')

    def __init__(self, signals, steps: int, epochs: int = 6):
        rng = np.random.default_rng(0)
        self.batches = [({c: rng.normal(size=(2, epochs * (1024 if c in ('ECG', 'PPG') else 256))).astype(np.float32)
                          for c in signals}, rng.integers(0, 4, size=(2, epochs)).astype(np.float32))
                        for _ in range(steps)]

    def train_loader(self, epoch):
        yield from self.batches


@pytest.fixture(scope='module')
def trainer(tmp_path_factory):
    cfg = flagship_config(16, 16, 'cardio')
    model = build_wav2sleep(**cfg)
    return Trainer(model=model, datamodule=Loader(list(cfg['signal_map']), steps=5), input_transport='q8',
                   metric_fetch_every=2, stage_ring=2, device='cpu', progress_bar=False, warmup_steps=0,
                   log_dir=str(tmp_path_factory.mktemp('run')))


def test_the_trainer_records_its_spans_once_a_step(trainer):
    tracing.enable()
    trainer.train_epoch(0)
    tracing.disable()
    spans = tracing.collect()
    count = {n: names(spans).count(n) for n in set(names(spans))}
    for name in ('trainer/stage', 'trainer/stage/claim', 'trainer/stage/write', 'trainer/stage/ship', 'trainer/step',
                 'train_step/inputs', 'train_step/forward', 'train_step/optimizer'):
        assert count[name] == 5, name
    assert count['trainer/load'] == 6
    assert count['trainer/drain'] == 5 // 2 + 1
    by_index = dict(enumerate(spans))
    for i, s in by_index.items():
        if s.name.startswith('trainer/stage/'):
            assert by_index[s.parent].name == 'trainer/stage'
        if s.name.startswith('train_step/'):
            assert by_index[s.parent].name == 'trainer/step'


def test_the_trainer_records_while_the_profiler_does(trainer):
    with Profile(cuda=False) as prof:
        trainer.train_epoch(1)
    assert not tracing._on
    assert names(tracing.collect()).count('trainer/step') == 5
    annotations = {e.name() for e in prof.events if e.is_user_annotation()}
    assert {'trainer/stage/write', 'trainer/drain', 'train_step/inputs', 'train_step/forward'} <= annotations
