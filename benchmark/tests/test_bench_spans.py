"""The readers of the program's spans, the gap labels by program span, and
the accepted readers' values, unmoved by the program spans' events in a
trace."""

import json
import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness
from benchmark.span_gaps import label_gaps, report
from benchmark.tests.bench_tiny import REPO, run, tiny_root
from benchmark.trace import Trace
from wav2sleep_tpu_torch.tracing import Span

MANIFEST = json.loads((REPO / 'BENCHMARK.json').read_text())
NEW = {'serve.meta_copy_ms', 'serve.enqueue_ms', 'train.stage_ms', 'train.drain_ms', 'train_q8.stage_ms',
       'train_q8.drain_ms', 'train_q8.inputs_ms'}
MAIN, PRODUCER = 11, 22
MS = 1_000_000


def reader(name):
    return harness.load_module(REPO / 'benchmark' / 'metrics' / f'{name}.py').read


def spans_run(spans, cuda=True, steps=4):
    return types.SimpleNamespace(trace=object(), cuda=cuda, counters={'steps': steps}, spans=spans)


def s(name, start_ms, end_ms, thread=MAIN, parent=-1):
    return Span(name, thread, parent, start_ms * MS, end_ms * MS)


SERVE = [s('pipeline/launch', 0, 30, PRODUCER), s('pipeline/h2d', 0, 1, PRODUCER, 0),
         s('pipeline/meta_copy', 1, 21, PRODUCER, 0), s('pipeline/enqueue', 21, 30, PRODUCER, 0),
         s('pipeline/launch', 60, 80, PRODUCER), s('pipeline/h2d', 60, 61, PRODUCER, 4),
         s('pipeline/meta_copy', 61, 71, PRODUCER, 4), s('pipeline/enqueue', 71, 80, PRODUCER, 4)]
TRAIN = [s('trainer/stage', 0, 5), s('trainer/step', 5, 20), s('trainer/stage', 20, 23), s('trainer/step', 23, 40),
         s('trainer/drain', 40, 52), s('trainer/stage', 52, 53), s('trainer/step', 53, 60)]


@pytest.mark.parametrize('name, spans, want', [
    ('serve.meta_copy_ms', SERVE, 15.0),
    ('serve.enqueue_ms', SERVE, 9.0),
    ('train.stage_ms', TRAIN, 3.0),
    ('train.drain_ms', TRAIN, 4.0),
    ('train_q8.stage_ms', TRAIN, 3.0),
    ('train_q8.drain_ms', TRAIN, 4.0),
    ('serve.meta_copy_ms', TRAIN, None),
    ('train.drain_ms', SERVE, None),
])
def test_a_reader_of_program_spans(name, spans, want):
    got = reader(name)(spans_run(spans))
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize('name', sorted(NEW - {'train_q8.inputs_ms'}))
def test_a_program_without_the_recorder_reads_nothing(name, monkeypatch):
    monkeypatch.setitem(sys.modules, 'wav2sleep_tpu_torch.tracing', None)
    assert reader(name)(spans_run(None)) is None
    assert reader(name)(types.SimpleNamespace(trace=None)) is None


def test_the_inputs_reader_reads_the_device_time_under_its_span():
    trace = types.SimpleNamespace(spans={'train_step/inputs': 0.012, 'train_step/forward': 0.4})
    got = reader('train_q8.inputs_ms')(types.SimpleNamespace(trace=trace, cuda=True, counters={'steps': 4}))
    assert got == pytest.approx(3.0)
    trace.spans.pop('train_step/inputs')  # a program without the span
    assert reader('train_q8.inputs_ms')(types.SimpleNamespace(trace=trace, cuda=True, counters={'steps': 4})) is None


def test_a_gap_takes_the_innermost_span_of_each_thread():
    spans = [s('pipeline/result_wait', 0, 100), s('pipeline/launch', 0, 50, PRODUCER),
             s('pipeline/meta_copy', 10, 30, PRODUCER, 1), s('pipeline/put', 50, 100, PRODUCER)]
    gaps = [(15 * MS, 25 * MS), (60 * MS, 61 * MS), (200 * MS, 204 * MS)]
    got = dict(label_gaps(gaps, spans, lambda gap: 'no host op', examined=10, top=10))
    assert got == pytest.approx({'pipeline/result_wait + pipeline/meta_copy': 0.010,
                                 'pipeline/result_wait + pipeline/put': 0.001, 'no host op': 0.004})
    # Only the longest gaps are examined.
    assert dict(label_gaps(gaps, spans, lambda gap: 'no host op', examined=1, top=10)) == pytest.approx(
        {'pipeline/result_wait + pipeline/meta_copy': 0.010})


class Event:
    """What ``Trace`` reads of one kineto event."""

    def __init__(self, name, start_ms, dur_ms, device=False, annotation=False, corr=0, linked=0, thread=MAIN):
        self._name, self._start, self._dur = name, int(start_ms * MS), int(dur_ms * MS)
        self._device, self._annotation = device, annotation
        self._corr, self._linked, self._thread = corr, linked, thread

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._thread


def launch(op, at, kernel, kernel_at, kernel_ms, corr, thread=MAIN):
    """A host operation and the device work it launched."""
    return [Event(op, at, 1, corr=corr, thread=thread),
            Event(kernel, kernel_at, kernel_ms, device=True, linked=corr)]


def annotation(name, at, ms, device=False):
    return Event(name, at, ms, device=device, annotation=True)


def events(program_spans: bool) -> list:
    """Two training steps: a decode, a forward span with a K1 launch and an
    add, the backward's launches on their own thread, an optimizer span, a
    copy; idle gaps between. With ``program_spans``, the program's spans
    around them as the recorder leaves them in a trace, one with its
    device-side range."""
    out = []
    for k, t0 in enumerate((0.0, 100.0)):
        c = 10 * (k + 1)
        out += [annotation('train_step/forward', t0 + 10, 30), annotation('train_step/forward', t0 + 12, 18, True),
                annotation('train_step/optimizer', t0 + 80, 10),
                *launch('aten::_to_copy', t0 + 2, 'Memcpy HtoD', t0 + 3, 2, c),
                *launch('aten::mul', t0 + 5, 'elementwise_kernel_mul', t0 + 6, 3, c + 1),
                *launch('_ConvK3', t0 + 11, 'conv_k3_wgmma_kernel<16,1>', t0 + 12, 10, c + 2),
                *launch('aten::add', t0 + 14, 'elementwise_kernel_add', t0 + 22, 8, c + 3),
                *launch('aten::mm', t0 + 45, 'gemm', t0 + 46, 30, c + 4, thread=33),
                *launch('aten::_foreach_add_', t0 + 81, 'multi_tensor_apply', t0 + 82, 5, c + 5)]
        if program_spans:
            out += [annotation('trainer/step', t0 + 1, 92), annotation('train_step/inputs', t0 + 1.5, 8),
                    annotation('train_step/inputs', t0 + 3, 6, True), annotation('trainer/stage', t0 + 93, 5),
                    annotation('trainer/stage/write', t0 + 93.5, 3), annotation('trainer/drain', t0 + 98.5, 1)]
    return out


def accepted_run(cell: str, program_spans: bool) -> harness.Run:
    r = harness.open_run(REPO, cell, 2**31 + 7, 'cpu')
    r.device = torch.device('cuda')
    r.trace = Trace(events(program_spans), window_s=0.2)
    f32 = 'f32' in cell
    r.counters = {'window_s': 0.2, 'batches': 2, 'steps': 2, 'nights': 16, 'fill_seconds': 0.015,
                  'k1_launches': 160, 'batch': 16 if f32 else 4, 'dtype': 'float32' if f32 else 'bfloat16'}
    return r


@pytest.mark.parametrize('metric', [m for m in MANIFEST['per_layer'] if m['name'] not in NEW], ids=lambda m: m['name'])
def test_an_accepted_reader_reads_the_same_with_program_spans(metric):
    cell = metric['workloads'][0]
    plain = reader(metric['name'])(accepted_run(cell, program_spans=False))
    spanned = reader(metric['name'])(accepted_run(cell, program_spans=True))
    assert plain is not None and spanned == plain


def test_the_trace_reads_the_same_device_time_with_program_spans():
    plain, spanned = Trace(events(False), 0.2), Trace(events(True), 0.2)
    assert (spanned.busy_s, spanned.device_ops, spanned.unlinked_s) == (plain.busy_s, plain.device_ops,
                                                                         plain.unlinked_s)
    assert {k: v for k, v in spanned.spans.items() if k in plain.spans} == plain.spans
    assert spanned.spans['train_step/inputs'] == pytest.approx(2 * 0.003 + 2 * 0.002)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp('tiny'), serve_precision='float32')


@pytest.mark.parametrize('cell', [w['name'] for w in MANIFEST['workloads']])
def test_a_traced_run_reads_the_program_spans(root, cell):
    from wav2sleep_tpu_torch import tracing

    got = run(root, cell, seconds=1.0, trace=True)['metrics']
    mine = {m['name'] for m in MANIFEST['per_layer'] if m['source'] == 'program_span' and cell in m['workloads']}
    assert mine and all(got[name]['value'] > 0 for name in mine), got
    assert not tracing._on and tracing.collect() == []


def test_span_gaps_labels_a_tiny_window(root):
    out = report(root, 'wav2sleep.serve-q8', 5, 1.0, device='cpu')
    assert out['spans']['pipeline/launch']['count'] >= 1 and out['spans']['pipeline/meta_copy']['count'] >= 1
    assert out['clock_main_thread']['spans'] >= 2
    assert {'serve.meta_copy_ms', 'serve.enqueue_ms'} <= set(out['per_layer'])
