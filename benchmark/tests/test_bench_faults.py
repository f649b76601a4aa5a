"""With the timed path broken underneath, a run comes out not correct: an
answer altered where it is produced, half of a batch left out, a step that
returns its state unchanged, a step that leaves the EMA where it was. The
same limits pass a sound run."""

import json

import pytest
import torch

from benchmark.tests.bench_tiny import run, tiny_root

SERVE, TRAIN = 'wav2sleep.serve-q8', 'wav2sleep.train-f32'
LIMITS = {SERVE: {'logit_gap': 1e-3, 'bad_hypnograms': 0},
          TRAIN: {'loss_gap': 1e-4, 'grad_gap': 1e-3, 'change_gap': 1e-2}}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp('tiny'), serve_precision='float32', limits=LIMITS)


def altered_answer(out):
    out[0] = (out[0] + 1) % 4
    return out


def half_batch_dropped(out):
    out[out.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize('fault', [None, altered_answer, half_batch_dropped])
def test_serving(root, fault, monkeypatch):
    from wav2sleep_tpu_torch import pipeline

    if fault is not None:
        real = pipeline._model_output
        monkeypatch.setattr(pipeline, '_model_output', lambda logits, output: fault(real(logits, output)))
    assert run(root, SERVE)['correct'] is (fault is None)


def unchanged(step):
    """The step runs, then its parameters and optimizer state are put back."""

    def broken(state, batch, seed):
        saved = ({n: p.detach().clone() for n, p in state.params.items()},
                 [m.clone() for m in state.opt_state.mu], [v.clone() for v in state.opt_state.nu],
                 state.opt_state.count)
        state, metrics = step(state, batch, seed)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(saved[0][n])
        for dst, src in zip(state.opt_state.mu, saved[1]):
            dst.copy_(src)
        for dst, src in zip(state.opt_state.nu, saved[2]):
            dst.copy_(src)
        state.opt_state.count = saved[3]
        return state, metrics
    return broken


def half_batch(make):
    def wrapped(*a, **k):
        step = make(*a, **k)

        def broken(state, batch, seed):
            x, y = batch
            h = y.shape[0] // 2
            return step(state, ({n: v[:h] for n, v in x.items()}, y[:h]), seed)
        return broken
    return wrapped


@pytest.mark.parametrize('fault', [None, lambda make: lambda *a, **k: unchanged(make(*a, **k)), half_batch])
def test_training(root, fault, monkeypatch):
    from wav2sleep_tpu_torch.train import loop

    if fault is not None:
        monkeypatch.setattr(loop, 'make_train_step', fault(loop.make_train_step))
    assert run(root, TRAIN)['correct'] is (fault is None)


EOG_TRAIN = 'wav2sleep-eog.train-bf16-q8'


@pytest.fixture(scope='module')
def eog_root(tmp_path_factory):
    # In f32, so that a sound run's EMA sits far under the limit at this size.
    root = tiny_root(tmp_path_factory.mktemp('tiny_eog'), limits={EOG_TRAIN: {'ema_gap': 0.5}})
    f = root / 'benchmark' / 'traffic' / 'train-bf16-q8.json'
    mix = json.loads(f.read_text())
    mix['precision'] = 'float32'
    f.write_text(json.dumps(mix))
    return root


def ema_unchanged(make):
    def wrapped(*a, **k):
        step = make(*a, **k)

        def broken(state, batch, seed):
            saved = {n: e.clone() for n, e in state.ema_params.items()}
            state, metrics = step(state, batch, seed)
            for n, e in state.ema_params.items():
                e.copy_(saved[n])
            return state, metrics
        return broken
    return wrapped


@pytest.mark.parametrize('fault', [None, ema_unchanged])
def test_training_ema(eog_root, fault, monkeypatch):
    from wav2sleep_tpu_torch.train import loop

    if fault is not None:
        monkeypatch.setattr(loop, 'make_train_step', fault(loop.make_train_step))
    assert run(eog_root, EOG_TRAIN)['correct'] is (fault is None)
