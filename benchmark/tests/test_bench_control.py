"""The control (the plain reference one precision below the configuration's)
reads far above the program on the numbers a cell compares, at a size a
test run holds. TF32 exists only on the card; that case is marked ``cuda``.
The bf16 step's control, fp8, fails at the cell's size because its unscaled
gradients flush to zero; that holds at a narrow width too, as long as the
batch has the cell's count of labelled epochs."""

import json

import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import model as ref
from benchmark.reference import train as rtrain
from benchmark.tests.bench_tiny import REPO, SEED, tiny_root

EVERY = {k: 1.0 for k in ('loss_gap', 'loss1_gap', 'grad_gap', 'grad_median_gap', 'change_gap', 'change_median_gap',
                          'ema_gap', 'ema_median_gap')}


def calibrate(root, cell, device='cpu', seconds=2.0):
    run = harness.open_run(root, cell, SEED, device)
    gen = harness.load_module(run.bench / 'traffic' / f"{run.mix['generator']}.py")
    return gen.calibrate(gen.setup(run), seconds)


def test_fp8_control_of_bf16_serving(tmp_path):
    got = calibrate(tiny_root(tmp_path), 'wav2sleep.serve-q8')
    assert got['control']['logit_gap'] > 3 * got['program']['logit_gap'], got


def test_fp8_control_of_the_bf16_step(tmp_path):
    # The cell's mix and its batch of 4 ten-hour nights (4,800 epochs), on
    # the narrow configuration at 64 samples an epoch: the flush comes from
    # the count of labelled epochs; the samples an epoch set only the cost.
    root = tiny_root(tmp_path)
    cfg = json.loads((root / 'benchmark' / 'configs' / 'wav2sleep-eog.json').read_text())
    mix = json.loads((REPO / 'benchmark' / 'traffic' / 'train-bf16-q8.json').read_text())
    cfg.update(max_length_hours=10, epochs_per_night=1200, signals={s: 64 for s in cfg['signals']})
    mix.update(pool_nights=mix['batch_size'])
    pool = inputs.training_pool(cfg, mix, SEED, 'cpu')
    x = {s: torch.as_tensor(v) for s, v in pool['x'].items()}
    y = torch.as_tensor(pool['y'])
    seeds = rtrain.step_seeds(rtrain.epoch_seed(SEED, 0), 0)
    applied = {}
    for precision in ('f32', 'fp8'):
        P = ref.make_weights(cfg, SEED, 'cpu')
        opt = rtrain.AdamWRef(mix['optimizer']['lr'], mix['optimizer']['weight_decay'], mix['optimizer']['grad_clip'])
        _, applied[precision] = rtrain.train_step(P, opt, x, y, cfg, seeds, 'q8', torch.bfloat16, precision)
    assert all(float(g.abs().max()) == 0.0 for g in applied['fp8'].values())
    assert sum(float(g.abs().max()) > 0.0 for g in applied['f32'].values()) > len(applied['f32']) // 2


@pytest.mark.cuda
def test_tf32_control_of_the_f32_step(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('TF32 exists only on an NVIDIA card')
    got = calibrate(tiny_root(tmp_path), 'wav2sleep.train-f32', device='cuda')
    assert got['control']['grad_gap'] > 3 * got['program']['grad_gap'], got
