"""The port's ``q8_quality`` against the JAX package's
``scripts/q8_quality.py`` on the CPU: ``zscore_host`` and ``compare`` on
seeded arrays, the arguments, and a tiny run that prints the JAX script's
rows with its keys and finite values."""

import importlib.util
import json
import os

import numpy as np
import pytest

from wav2sleep_tpu_torch import q8_quality

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location('jax_q8_quality', os.path.join(REPO, 'scripts', 'q8_quality.py'))
jq8q = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jq8q)


def test_zscore_host_is_the_jax_scripts():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(3, 1000)).astype(np.float32) * 40 + 7, np.zeros((2, 64), np.float32),
              rng.normal(size=(4, 17))):
        got, want = q8_quality.zscore_host(x), jq8q.zscore_host(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('noise', [0.0, 0.05, 3.0])
def test_compare_is_the_jax_scripts(noise):
    rng = np.random.default_rng(1)
    ref = rng.normal(size=(4, 50, 4)).astype(np.float32)
    test = ref + noise * rng.normal(size=ref.shape).astype(np.float32)
    got, want = q8_quality.compare(ref, test), jq8q.compare(ref, test)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


def test_arguments_are_the_jax_scripts():
    ours = {a.dest: a.default for a in q8_quality.build_parser()._actions if a.dest != 'help'}
    theirs = {a.dest: a.default for a in jq8q.build_parser()._actions if a.dest != 'help'}
    assert ours.pop('device') is None  # the card unless --device cpu
    assert ours == theirs


def test_a_tiny_run_prints_the_jax_scripts_rows(capsys):
    rows = q8_quality.main(['--train-nights', '3', '--eval-nights', '3', '--hours', '0.1', '--train-steps', '6',
                            '--feature-dim', '16', '--device', 'cpu'])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith('{')]
    assert printed == json.loads(json.dumps(rows))
    # The JAX script's rows and keys (scripts/q8_quality.py, main()).
    compare_keys = list(jq8q.compare(np.eye(4)[None], np.eye(4)[None]))
    base = ['nights', 'epochs', 'label_noise', 'overlap', 'train_transport', 'train_steps', 'selected_step',
            'eval_loss', 'train_acc', 'f32_eval_acc']
    want = [
        ('trained model: q8+float32 vs f32 lossless', base + ['q8_eval_acc', 'acc_delta'] + compare_keys),
        ('trained model: q8+bfloat16 vs f32 lossless', base + ['q8_eval_acc', 'acc_delta'] + compare_keys),
        ('trained model: q4+float32 vs f32 lossless', base + ['q4_eval_acc', 'acc_delta'] + compare_keys),
        ('trained model: q4+bfloat16 vs f32 lossless', base + ['q4_eval_acc', 'acc_delta'] + compare_keys),
        ('random-init bias-centered (pessimistic): q8+bfloat16 vs f32 lossless', ['nights', 'epochs'] + compare_keys),
    ]
    assert [(r['config'], list(r)[1:]) for r in rows] == want
    for r in rows:
        assert r['nights'] == 3 and r['epochs'] == 36
        values = [v for k, v in r.items() if isinstance(v, (int, float))]
        assert np.isfinite(values).all(), r
        assert 0.0 <= r['agreement'] <= 1.0
    assert rows[0]['train_steps'] == 6 and 0 <= rows[0]['selected_step'] <= 5
