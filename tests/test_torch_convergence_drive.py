"""The port's convergence drive (``wav2sleep_tpu_torch.convergence_drive``)
against the JAX package's ``scripts/convergence_drive.py`` on the CPU: the
NSRR annotation XML byte for byte, the prepared parquet corpus frame for
frame for both signal sets, the selection evidence on hand-written logs,
and a narrow drive of 2 epochs end to end with the JAX script's summary
keys (on the port's prepared cardio corpus)."""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

from wav2sleep_tpu_torch import convergence_drive as cd

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location('jax_convergence_drive',
                                               os.path.join(REPO, 'scripts', 'convergence_drive.py'))
jcd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jcd)

NARROW = ['feature_dim=16', 'model.signal_encoders.max_channels=16', 'max_length_hours=0.05']
# The train CLI without its confusion-matrix figures, whose text layout in
# matplotlib would take a third of the drive test.
TRAIN_NO_FIGURES = """
import runpy, sys
from wav2sleep_tpu_torch import log
log.save_confusion_figure = lambda *a: None
sys.argv = ['wav2sleep_tpu_torch.train', *sys.argv[1:]]
runpy.run_module('wav2sleep_tpu_torch.train', run_name='__main__', alter_sys=True)
"""


@pytest.mark.parametrize('five_class', [False, True])
def test_write_nsrr_xml_is_the_jax_scripts(tmp_path, five_class):
    rng = np.random.default_rng(1)
    stages = rng.integers(0, 5 if five_class else 4, size=97)
    stages[10:30] = stages[10]  # a long run
    kw = [cd.SYNTH_TO_NSRR_5 if five_class else None], [jcd.SYNTH_TO_NSRR_5 if five_class else None]
    cd.write_nsrr_xml(str(tmp_path / 'port.xml'), stages, *kw[0])
    jcd.write_nsrr_xml(str(tmp_path / 'jax.xml'), stages, *kw[1])
    assert (tmp_path / 'port.xml').read_bytes() == (tmp_path / 'jax.xml').read_bytes()
    assert cd.SYNTH_TO_NSRR == jcd.SYNTH_TO_NSRR and cd.SYNTH_TO_NSRR_5 == jcd.SYNTH_TO_NSRR_5


@pytest.fixture(scope='module')
def corpora(tmp_path_factory):
    """``corpora(signals)``: the roots of 6 nights of 0.05 h prepared by each
    package (the port's through its CLI), made once a signal set."""
    made = {}

    def get(signals):
        if signals not in made:
            root = tmp_path_factory.mktemp(signals)
            cd.main(['--prepare', '--root', str(root / 'port'), '--nights', '6', '--hours', '0.05',
                     '--signals', signals])
            jcd.prepare(str(root / 'jax'), 6, 0.05, 0,
                        argparse.Namespace(signals=signals, overlap=0.0, label_noise=0.12))
            made[signals] = root
        return made[signals]

    return get


@pytest.mark.parametrize('signals', ['cardio', 'eog'])
def test_prepare_writes_the_jax_scripts_corpus(corpora, signals):
    """6 nights of 0.05 h through each package's prepare: the same files in
    the same splits, equal frames (pandas' reading of both) and equal signal
    metadata. These nights have one grid a signal set, so the row-order
    departure of ROADMAP §C.19 does not arise."""
    tmp_path = corpora(signals)
    files = {}
    for side in ('port', 'jax'):
        root = tmp_path / side / 'data' / 'mesa'
        files[side] = sorted(str(p.relative_to(root)) for p in root.rglob('*.parquet'))
        assert not list((tmp_path / side / 'edfs').iterdir())  # the scaffolding is removed
    # A night too short to hold N1, N3 or REM is quarantined (.issues) by both.
    assert files['port'] == files['jax']
    assert sorted(f.replace('.issues', '') for f in files['port']) == sorted(
        f'{s}/night{i:04d}.parquet' for i, s in enumerate(['train', 'train', 'val', 'val', 'test', 'test']))
    for name in files['port']:
        got = pd.read_parquet(tmp_path / 'port' / 'data' / 'mesa' / name)
        want = pd.read_parquet(tmp_path / 'jax' / 'data' / 'mesa' / name)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        meta = [pq.read_schema(tmp_path / side / 'data' / 'mesa' / name).metadata[b'signal_metadata']
                for side in ('port', 'jax')]
        assert json.loads(meta[0]) == json.loads(meta[1])
    stages = pd.concat(pd.read_parquet(tmp_path / 'port' / 'data' / 'mesa' / name)['Stage'] for name in files['port'])
    # Ingest keeps the 5-stage scheme (the dataset maps it to 4 classes).
    assert set(stages.dropna().unique()) <= set(range(-1, 5)) and stages.nunique() >= 3


def _write(fp, rows):
    with open(fp, 'w') as f:
        for r in rows:
            f.write(json.dumps(r) + '\n')


def _logs():
    """Hand-written metrics.jsonl rows: an early-stopped run with a plateau
    cut and a shadow q16 series whose best epoch differs, the same without
    the shadow series, and a run that hits its cap."""
    val = [1.0, 0.8, 0.7, 0.65, 0.66, 0.67, 0.68, 0.69]
    q16 = [1.0001, 0.8002, 0.7001, 0.6502, 0.6499, 0.67, 0.6801, 0.69]
    lr = [1e-3] * 6 + [1e-4] * 2
    stopped = []
    for e in range(8):
        stopped.append({'step': e, 'train_loss': 1.0, 'lr': lr[e], 'lr_step': 5 * e})
        stopped.append({'step': e, 'val_loss': val[e], 'val_loss_q16': q16[e]})
    no_shadow = [{k: v for k, v in r.items() if k != 'val_loss_q16'} for r in stopped]
    capped = [{'step': e, 'val_loss': 1.0 - 0.1 * e, 'lr': 1e-3} for e in range(5)]
    return {'stopped': (stopped, 60), 'no_shadow': (no_shadow, 60), 'capped': (capped, 5)}


@pytest.mark.parametrize('case', ['stopped', 'no_shadow', 'capped'])
def test_selection_evidence_is_the_jax_scripts(tmp_path, case):
    rows, cap = _logs()[case]
    fp = str(tmp_path / 'metrics.jsonl')
    _write(fp, rows)
    got, want = cd.selection_evidence(fp, cap), jcd.selection_evidence(fp, cap)
    assert got == want
    assert (got['eval_transport_ab'] is None) == (case != 'stopped')
    if case == 'stopped':
        assert got['early_stopped'] and got['plateau_lr_reduced'] and not got['best_is_last']
        assert not got['eval_transport_ab']['selection_agrees']


def test_selection_evidence_without_val_loss_raises_as_the_jax_scripts(tmp_path):
    fp = str(tmp_path / 'metrics.jsonl')
    _write(fp, [{'step': 0, 'train_loss': 1.0, 'lr': 1e-3}])
    for mod in (cd, jcd):
        with pytest.raises(RuntimeError, match='no val_loss rows'):
            mod.selection_evidence(fp, 60)


def test_the_drive_runs_end_to_end_on_the_cpu(corpora, tmp_path, monkeypatch):
    """A narrow drive of 2 epochs on the 6 prepared cardio nights: the train
    CLI supervised in a child process, the test pass, the export re-scored
    through the inference API; summary.json with the JAX script's keys."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    # The re-score pads each night to the API's 10 h by default: at 0.05 h
    # nights the CPU would spend most of the test on padding.
    from wav2sleep_tpu_torch import api

    predict_on_folder = api.predict_on_folder
    monkeypatch.setattr(api, 'predict_on_folder', lambda *a, **k: predict_on_folder(*a, **k, max_length_hours=1))
    root, out = tmp_path / 'root', str(tmp_path / 'out')
    root.mkdir()
    (root / 'data').symlink_to(corpora('cardio') / 'port' / 'data')
    summary = cd.main(['--root', str(root), '--nights', '6', '--hours', '0.05', '--epochs', '2', '--device', 'cpu',
                       '--out', out, *NARROW], train_command=[sys.executable, '-c', TRAIN_NO_FIGURES])
    with open(os.path.join(out, 'summary.json')) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(summary))
    # The JAX script's keys (scripts/convergence_drive.py, collect()).
    assert set(summary) == {'signals', 'num_classes', 'corpus', 'selection', 'final_metrics',
                            'exported_checkpoint_test', 'run_dir'}
    assert set(summary['exported_checkpoint_test']) == {'nights', 'scored_epochs', 'accuracy', 'kappa',
                                                        'confusion_matrix'}
    rows, cap = _logs()['stopped']
    _write(str(tmp_path / 'any.jsonl'), rows)
    assert set(summary['selection']) == set(jcd.selection_evidence(str(tmp_path / 'any.jsonl'), cap))
    ev = summary['selection']
    assert ev['epochs_run'] == 2 and ev['epoch_cap'] == 2 and ev['eval_transport_ab']['epochs_compared'] == 2
    assert summary['exported_checkpoint_test']['nights'] == 2
    assert summary['exported_checkpoint_test']['scored_epochs'] == 12
    assert np.isfinite(summary['final_metrics']['test_loss_mesa'])
    assert os.path.exists(os.path.join(out, 'metrics.jsonl'))
    log = open(os.path.join(summary['run_dir'], 'supervised_attempt0.log')).read()
    assert 'Restored best (lowest val_loss) checkpoint.' in log
