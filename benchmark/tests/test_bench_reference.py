"""The plain reference agrees with the port's plain path on the CPU at a
tiny size: the q8 serving transport's device half and the forward, in f32,
and the training step through the harness."""

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import model as ref
from benchmark.reference.transport import q8_serving_input
from benchmark.tests.bench_tiny import SEED, run, tiny_root


NUMBERS = ('loss_gap', 'loss1_gap', 'grad_gap', 'grad_median_gap', 'change_gap', 'change_median_gap', 'ema_gap',
           'ema_median_gap')


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    every = {k: 1.0 for k in NUMBERS}
    return tiny_root(tmp_path_factory.mktemp('tiny'), serve_precision='float32',
                     limits={'wav2sleep.train-f32': every, 'wav2sleep-eog.train-bf16-q8': every})


@pytest.mark.parametrize('config', ['wav2sleep', 'wav2sleep-eog'])
def test_q8_serving_logits_match_the_port(root, config):
    from wav2sleep_tpu_torch.pipeline import Q8_META_DTYPE, make_streaming_forward_q8

    r = harness.open_run(root, 'wav2sleep.serve-q8', SEED, 'cpu')
    r.cfg = harness.read_json(root / 'benchmark' / 'configs' / f'{config}.json')
    W = ref.make_weights(r.cfg, SEED, 'cpu')
    pool = inputs.serving_pool(r.cfg, r.mix, SEED, 'cpu')
    model = harness.program_model(r, W).eval()
    fwd = make_streaming_forward_q8(model, 'float32', output='logits')
    idx = list(range(r.mix['pool_nights']))
    q = {s: torch.as_tensor(pool['codes'][s][idx]) for s in r.cfg['signals']}
    fields = [{s: torch.as_tensor(pool['meta'][s][f][idx]) for s in r.cfg['signals']} for f in Q8_META_DTYPE.names]
    got = fwd(q, *fields)
    x = {s: q8_serving_input(pool, s, idx, 'cpu') for s in r.cfg['signals']}
    with torch.no_grad():
        want = ref.forward(W, x, r.cfg)
    if 'THX' in r.cfg['signals']:
        assert not pool['meta']['THX']['present'].all()  # the -inf path is exercised
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


# The q8 mix runs at a constant LR of 1e-3: after the first step Adam moves
# the elements whose gradients are rounding noise by up to the LR on either
# side, so its later losses part by more than the warm-up mix's (1e-3 to
# 1.2e-2 over the six checked steps): there the first step's loss is held.
@pytest.mark.parametrize('cell, loss_number, loss, grad, change', [
    ('wav2sleep.train-f32', 'loss_gap', 1e-5, 1e-4, 1e-2),
    ('wav2sleep-eog.train-bf16-q8', 'loss1_gap', 1e-5, 1e-4, 5e-2),
])
def test_training_step_matches_the_port_in_f32(root, cell, loss_number, loss, grad, change):
    import json

    f = root / 'benchmark' / 'traffic' / f"{harness.open_run(root, cell, SEED, 'cpu').workload['traffic']}.json"
    mix = json.loads(f.read_text())
    mix['precision'] = 'float32'
    f.write_text(json.dumps(mix))
    c = run(root, cell)['checked']
    assert c[loss_number]['value'] < loss and c['grad_gap']['value'] < grad and c['change_gap']['value'] < change, c
    if mix['ema_decay'] is None:
        assert c['ema_gap']['value'] is None, c  # no EMA to compare
    else:
        assert c['ema_gap']['value'] < change, c
