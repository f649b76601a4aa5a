"""The benchmark's own counts of K1's work reproduce the port's baseline
(a B=8 forward of each released variant) and its FLOP count is whole."""

import json

import pytest

from benchmark.tests.bench_tiny import REPO
from benchmark.work import conv_k3, wav2sleep


def config(name):
    return json.loads((REPO / 'benchmark' / 'configs' / f'{name}.json').read_text())


@pytest.mark.parametrize('name, calls, gflop, gbytes, bound_ms', [
    ('wav2sleep', 80, 447.3, 10.10, 3.014),
    ('wav2sleep-eog', 58, 1623.2, 33.45, 9.984),
])
def test_k1_work_of_a_forward(name, calls, gflop, gbytes, bound_ms):
    cfg = config(name)
    n_bytes, flops = conv_k3.forward_work(cfg, 8, 2)
    assert len(conv_k3.calls(cfg, 8)) == calls
    assert round(flops / 1e9, 1) == gflop
    assert round(n_bytes / 1e9, 2) == gbytes
    assert round(conv_k3.forward_bound_ms(cfg, 8, 'bfloat16'), 3) == bound_ms


@pytest.mark.parametrize('name', ['wav2sleep', 'wav2sleep-eog'])
def test_model_flops_hold_k1s_and_scale_with_the_batch(name):
    cfg = config(name)
    k1 = conv_k3.forward_work(cfg, 8, 2)[1]
    assert wav2sleep.forward_flops(cfg, 8) > k1
    assert wav2sleep.forward_flops(cfg, 16) == 2 * wav2sleep.forward_flops(cfg, 8)
