"""The port's ``pipeline_scale_bench`` and ``eval_matrix_bench`` against the
JAX package's scripts on the CPU: the loader evidence distilled from a
written ``metrics.jsonl`` (``distil`` and ``--distil-only``), and the
eval-matrix A/B on a tiny corpus with the JAX script's output keys."""

import importlib.util
import json
import os

import numpy as np
import pytest

from wav2sleep_tpu_torch import convergence_drive, eval_matrix_bench, pipeline_scale_bench
from wav2sleep_tpu_torch.data import parquet

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f'jax_{name}', os.path.join(REPO, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jpsb = _script('pipeline_scale_bench')

# The JAX script's output keys (scripts/eval_matrix_bench.py, main()).
EVAL_MATRIX_KEYS = [
    'metric', 'val_nights', 'val_batch_size', 'precision', 'per_batch_fetch_s', 'deferred_drain_s',
    'q16_transport_s', 'q8_transport_s', 'speedup_drain', 'speedup_q16', 'speedup_q8', 'max_abs_loss_delta_q16',
    'max_abs_loss_delta_q8', 'per_batch_all_s', 'deferred_all_s', 'q16_all_s', 'q8_all_s',
]


def _metrics(fp, epochs=4):
    rows = []
    for e in range(epochs):
        rows.append({'step': e, 'train_loss': 1.0 / (e + 1), 'train_steps_per_sec': 0.5 + 0.75 * e,
                     'lr_step': 10 * e, 'lr': 1e-3, 'host_loader_frac': round(0.1 + 0.07 * e, 4)})
        rows.append({'step': e, 'val_loss': 0.9 - 0.01 * e})
    with open(fp, 'w') as f:
        for r in rows:
            f.write(json.dumps(r) + '\n')


@pytest.mark.parametrize('epochs,meta', [(4, {'steps_per_epoch': 100}), (1, {'steps_per_epoch': 7, 'x': 1}), (3, {})])
def test_distil_is_the_jax_scripts(tmp_path, epochs, meta):
    fp = str(tmp_path / 'metrics.jsonl')
    _metrics(fp, epochs)
    assert pipeline_scale_bench.distil(fp, meta) == jpsb.distil(fp, meta)
    (tmp_path / 'empty.jsonl').write_text(json.dumps({'step': 0, 'val_loss': 1.0}) + '\n')
    for mod in (pipeline_scale_bench, jpsb):
        with pytest.raises(RuntimeError, match='no train rows'):
            mod.distil(str(tmp_path / 'empty.jsonl'), meta)


def test_distil_only_writes_the_jax_scripts_artifact(tmp_path):
    run = tmp_path / 'run'
    run.mkdir()
    _metrics(str(run / 'metrics.jsonl'))
    root = tmp_path / 'root'
    (root / 'data' / 'mesa' / 'train').mkdir(parents=True)
    for i in range(5):
        (root / 'data' / 'mesa' / 'train' / f'night{i:04d}.parquet').write_bytes(b'x' * (1000 + i))
    outs = {}
    for name, mod in (('port', pipeline_scale_bench), ('jax', jpsb)):
        out = str(tmp_path / f'{name}.json')
        mod.main(['--distil-only', str(run), '--root', str(root), '--out', out])
        with open(out) as f:
            outs[name] = json.load(f)
    got, want = outs['port'], outs['jax']
    assert list(got) == list(want)
    assert got['steps_per_epoch'] == 2 and got['train_nights'] == 5
    for k in want:
        if k != 'cache_caveat':  # the text names the port's epoch-0 costs
            assert got[k] == want[k], k


def test_eval_matrix_bench_runs_on_a_tiny_corpus(tmp_path, monkeypatch):
    """The bench on 2 nights a split of 6 epochs, laid out as ingest lays
    them out but unpadded, with 4 unscored epochs after one night's last
    scored one (the scored span, 0.05 h, sets the padding); the flagship
    narrowed to 16 features and channels, and no confusion-matrix figures
    (matplotlib's text layout would take most of the test)."""
    from wav2sleep_tpu_torch import log
    from wav2sleep_tpu_torch.models import wav2sleep

    flagship_config = wav2sleep.flagship_config
    monkeypatch.setattr(wav2sleep, 'flagship_config', lambda: flagship_config(16, 16))
    monkeypatch.setattr(log, 'save_confusion_figure', lambda *a: None)
    rng = np.random.default_rng(0)
    data = tmp_path / 'data'
    for split in ('train', 'val', 'test'):
        (data / 'mesa' / split).mkdir(parents=True)
        for n in range(2):
            stage = np.concatenate([rng.integers(0, 5, 6), np.full(4 * (split == 'val' and n == 1), -1)])
            night = {k: rng.normal(size=len(stage) * spe).astype(np.float32)
                     for k, spe in (('ECG', 1024), ('PPG', 1024), ('ABD', 256), ('THX', 256))}
            parquet.write_night(str(data / 'mesa' / split / f'night{n}.parquet'),
                                {**night, 'Stage': stage.astype(np.float32)})
    assert eval_matrix_bench.night_hours(str(data)) == 0.05
    out = eval_matrix_bench.main(['--data', str(data), '--reps', '1', '--device', 'cpu',
                                  '--log-dir', str(tmp_path / 'log')])
    assert [k for k in out if k != 'device'] == EVAL_MATRIX_KEYS and out['device'] == 'cpu'
    assert out['val_nights'] == 2 and out['val_batch_size'] == 8 and out['precision'] == 'bfloat16'
    for arm in ('per_batch', 'deferred', 'q16', 'q8'):
        assert len(out[f'{arm}_all_s']) == 1 and out[f'{arm}_all_s'][0] > 0
    # q16 is near-lossless; q8 is the mu-law train rung.
    assert 0 < out['max_abs_loss_delta_q16'] < 1e-3 and out['max_abs_loss_delta_q16'] < out['max_abs_loss_delta_q8']


def test_the_drivers_run_on_the_card_unless_told(tmp_path):
    """Without ``--device cpu`` each driver asks for the card and raises
    here, where there is none: nothing falls back to the CPU."""
    from wav2sleep_tpu_torch import q8_quality
    from wav2sleep_tpu_torch.train.supervise import SupervisedRunFailed

    with pytest.raises(RuntimeError, match='no CUDA device'):
        q8_quality.main(['--train-nights', '1', '--eval-nights', '1', '--hours', '0.05', '--train-steps', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        eval_matrix_bench.main(['--data', str(tmp_path), '--reps', '1'])
    root = str(tmp_path / 'root')
    with pytest.raises(SupervisedRunFailed, match='no CUDA device'):
        convergence_drive.main(['--root', root, '--epochs', '1'])
    with pytest.raises(SupervisedRunFailed, match='no CUDA device'):
        pipeline_scale_bench.main(['--root', root, '--epochs', '1'])
