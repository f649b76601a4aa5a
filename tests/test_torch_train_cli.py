"""The port's training CLI (``python -m wav2sleep_tpu_torch.train``), its
config composition and its supervisor on the CPU: ``compose`` against the
JAX package's on the same configs and overrides, the sweep expansion, a
2-variant ``-m`` sweep end to end with ``device=cpu``, a resume, the tuned
batch's accumulation, the profile trace, the refusals, and
``run_supervised`` (stall, clean run, real error) with a stand-in script."""

import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from wav2sleep_tpu import config as jconfig
from wav2sleep_tpu.checkpoint import reference_compatible_config as jax_reference_config
from wav2sleep_tpu_torch import api, config, instantiate
from wav2sleep_tpu_torch.checkpoint import yaml_load, yaml_scalar
from wav2sleep_tpu_torch.parallel import mesh as pmesh
from wav2sleep_tpu_torch.train import __main__ as cli
from wav2sleep_tpu_torch.train import tuning
from wav2sleep_tpu_torch.train.masker import SignalMasker
from wav2sleep_tpu_torch.train.supervise import SupervisedRunFailed, run_supervised

from .test_torch_trainer import write_corpus
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

CONFIG_DIR = str(cli.CONFIG_DIR)

OVERRIDES = [
    [],
    ['model=ppgnet', 'datasets=mesa', 'inputs=cardiorespiratory/ecg'],
    ['feature_dim=64', 'num_classes=5', 'causal=true'],
    ['training/scheduler=decay'],
    ['debug=medium'],
    ['datasets.train=[mesa,shhs]', 'datasets.val=[mesa]', 'epochs=3', 'training.optimizer.lr=1e-3',
     'training.ema.enabled=true', 'run_dir=/tmp/x', '+extra=[1, 2.5, null]', 'inputs=neural/eog', 'name=a,b'],
]


@pytest.mark.parametrize('overrides', OVERRIDES, ids=lambda o: ' '.join(o) or 'defaults')
def test_compose_equals_jax(overrides, monkeypatch):
    for env in ('/data/x', None):
        if env is None:
            monkeypatch.delenv('WAV2SLEEP_DATA', raising=False)
        else:
            monkeypatch.setenv('WAV2SLEEP_DATA', env)
        assert config.compose(CONFIG_DIR, 'main', overrides) == jconfig.compose(CONFIG_DIR, 'main', overrides)


def test_compose_refusals_match_jax():
    for bad in (['not-an-override'], ['epcohs=5'], ['model=nope']):
        for mod in (config, jconfig):
            with pytest.raises(mod.ConfigError):
                mod.compose(CONFIG_DIR, 'main', bad)


def test_yaml_subset_reads_what_pyyaml_reads():
    for text in ('[mesa,shhs]', '[ a , "b,c" ]', '[]', '[1, 2.5, null, true]', '[a,]', 'x', '1e-3', '1.0e-3', '',
                 '~', '-7', 'mesa,shhs', '/a/b:c'):
        assert yaml_scalar(text) == yaml.safe_load(text), text
    for bad in ('[a,,b]', '[[a]]', '[a: b]', '{a: 1}'):
        with pytest.raises(ValueError):
            yaml_scalar(bad)
    doc = 'a: [x, y]  # c\nb:\n  - 1\n  - [2, 3]\n'
    assert yaml_load(doc) == yaml.safe_load(doc)
    for root, _, files in os.walk(CONFIG_DIR):
        for f in files:
            with open(os.path.join(root, f)) as fh:
                text = fh.read()
            assert yaml_load(text) == yaml.safe_load(text), f


def test_instantiate_the_masker_and_the_export_config():
    cfg = config.compose(CONFIG_DIR, 'main', [])
    masker = instantiate.instantiate(cfg['inputs']['masker'])
    assert isinstance(masker, SignalMasker) and masker.backup_channels == ['ECG', 'PPG']
    for overrides in ([], ['model=ppgnet']):
        model_cfg = config.compose(CONFIG_DIR, 'main', overrides)['model']
        assert instantiate.reference_compatible_config(model_cfg) == jax_reference_config(model_cfg)


def _jax_train_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location('jax_train_cli', os.path.join(cli.REPO_ROOT, 'scripts', 'train.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_expand_multirun_equals_jax():
    jax_cli = _jax_train_script()
    for argv in (['a=1'], ['-m', 'a=1,2', 'b=x', 'c=[p,q]', 'name=n'], ['--multirun', 'x.y=1,2', 'z=a/b,c']):
        assert cli.expand_multirun(argv) == jax_cli.expand_multirun(argv)


# ---------------------------------------------------------------- the CLI end to end


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('corpus')
    write_corpus(root)
    return root


NARROW = ['inputs=cardiorespiratory/ecg', 'feature_dim=16', 'model.signal_encoders.initial_channels=4',
          'model.signal_encoders.max_channels=8', 'max_length_hours=0.05', 'pad_to_epochs=6', 'num_cpus=0',
          'datasets=mesa', 'training.val_batch_size=2', 'training.test_batch_size=2']


def test_cli_sweep_on_the_cpu(corpus, tmp_path, monkeypatch, caplog):
    """A -m sweep of two LRs: each run trains, tests, exports a folder that
    load_model reads and writes its final metrics."""
    monkeypatch.setenv('WAV2SLEEP_DATA', str(corpus))
    monkeypatch.setenv('WAV2SLEEP_STORAGE', str(tmp_path))
    caplog.set_level('INFO', logger='train')
    results = cli.run(['-m', 'device=cpu', 'name=cli_sweep', *NARROW, 'batch_size=2', 'target_batch_size=2',
                       'epochs=1', 'test=true', 'restore_best=false', 'training.optimizer.lr=1e-3,5e-4'])
    assert len(results) == 2 and all('test_loss_mesa' in r for r in results.values())
    folders = sorted(os.path.join(root, 'model') for root, dirs, _ in os.walk(tmp_path / 'logs') if 'model' in dirs)
    assert len(folders) == 2 and 'cli_sweep_lr-1e-3' in folders[0] and 'cli_sweep_lr-5e-4' in folders[1]
    for folder in folders:
        model = api.load_model(folder, device='cpu')
        assert model.valid_signals == ['ECG']
        with open(os.path.join(os.path.dirname(folder), 'final_metrics.json')) as f:
            assert set(json.load(f)) == {'test_loss_mesa'}  # one encoder: no subsets
    assert sum('Job wall time' in r.message for r in caplog.records) == 2


def test_cli_resume_tuned_accumulation_and_profile(corpus, tmp_path, monkeypatch):
    """A tuned batch of 2 under target 4 accumulates 2 micro-steps; a second
    run with ckpt_path=last resumes in the same run_dir for one more epoch;
    profile=true leaves a trace of epoch 0."""
    monkeypatch.setenv('WAV2SLEEP_DATA', str(corpus))
    seen = {}

    def fake_tune(model, **kw):
        seen.update(kw)
        return 2

    monkeypatch.setattr(tuning, 'tune_batch_size', fake_tune)
    run_dir = str(tmp_path / 'run')
    args = ['device=cpu', *NARROW, 'tune_batch_size=true', 'target_batch_size=4', f'run_dir={run_dir}',
            'training.ema.enabled=true', 'training.ema.start_step=0']
    first = cli.main([*args, 'epochs=1', 'profile=true'])
    assert seen['ema'] and seen['grad_accum'] and seen['epochs_per_night'] == 6
    rows = [json.loads(line) for line in open(os.path.join(run_dir, 'metrics.jsonl'))]
    assert [r['lr_step'] for r in rows if 'lr_step' in r] == [2]  # 4 mesa nights, batch 2
    assert os.path.exists(os.path.join(run_dir, 'profile', 'trace.json'))
    second = cli.main([*args, 'epochs=2', 'ckpt_path=last'])
    rows = [json.loads(line) for line in open(os.path.join(run_dir, 'metrics.jsonl'))]
    assert [(r['step'], r['lr_step']) for r in rows if 'lr_step' in r] == [(0, 2), (1, 4)]
    assert set(first) == set(second) and 'val_loss' in second
    state = torch.load(os.path.join(run_dir, 'checkpoints', 'last', 'state.pt'), weights_only=True)
    assert state['state']['opt_state']['count'] == 2 and state['state']['ema_params'] is not None


def test_cli_refusals(corpus, monkeypatch):
    monkeypatch.setenv('WAV2SLEEP_DATA', str(corpus))
    # More devices than cards raises and names the count, before any rank
    # starts (a machine with one card, here faked).
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'is_available', lambda: True)
        m.setattr(torch.cuda, 'device_count', lambda: 1)
        with pytest.raises(ValueError, match='num_devices=2 but 1 CUDA device is visible'):
            cli.main([*NARROW, 'num_devices=2'])
        assert pmesh.devices_for(0, torch.device('cuda'), 'num_devices=0') == ['cuda:0']  # 0: every card
    assert pmesh.devices_for(0, torch.device('cpu'), 'num_devices=0') == ['cpu']
    assert pmesh.devices_for(3, torch.device('cpu'), 'num_devices=3') == ['cpu'] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cli.main(NARROW)
    assert cli.warn_if_dirty_git(debug=True) is False


# ---------------------------------------------------------------- supervision

FAKE = textwrap.dedent(
    """
    import json, os, sys, time
    args = dict(a.split('=', 1) for a in sys.argv[1:])
    run_dir = args['run_dir']
    marker = os.path.join(run_dir, 'attempt_count')
    n = int(open(marker).read()) if os.path.exists(marker) else 0
    open(marker, 'w').write(str(n + 1))
    mode = args['mode']
    if mode == 'stall_then_ok' and n == 0:
        os.makedirs(os.path.join(run_dir, 'checkpoints', 'last'), exist_ok=True)
        print('epoch 0 done', flush=True)
        time.sleep(3600)
    if mode == 'stall_then_ok':
        assert args.get('ckpt_path') == 'last', sys.argv
    if mode == 'crash':
        print('boom', flush=True)
        sys.exit(3)
    with open(os.path.join(run_dir, 'final_metrics.json'), 'w') as f:
        json.dump({'attempt': float(n)}, f)
    """
)


@pytest.fixture()
def fake_command(tmp_path):
    fp = tmp_path / 'fake_train.py'
    fp.write_text(FAKE)
    return [sys.executable, str(fp)]


def _final(run_dir):
    with open(os.path.join(run_dir, 'final_metrics.json')) as f:
        return json.load(f)


def test_supervised_stall_is_killed_and_resumed(fake_command, tmp_path):
    run_dir = str(tmp_path / 'run')
    log_fp = run_supervised(['mode=stall_then_ok'], run_dir, stall_timeout=3.0, poll=0.5, max_attempts=3,
                            train_command=fake_command, post_kill_grace=0.1)
    assert _final(run_dir) == {'attempt': 1.0} and 'attempt1' in log_fp
    with open(os.path.join(run_dir, 'supervised_attempt0.log')) as f:
        assert 'epoch 0 done' in f.read()


def test_supervised_clean_run_is_one_attempt(fake_command, tmp_path):
    run_dir = str(tmp_path / 'run')
    log_fp = run_supervised(['mode=ok'], run_dir, stall_timeout=30.0, poll=0.2, train_command=fake_command)
    assert 'attempt0' in log_fp and _final(run_dir) == {'attempt': 0.0}


def test_supervised_real_error_is_not_retried(fake_command, tmp_path):
    run_dir = str(tmp_path / 'run')
    with pytest.raises(SupervisedRunFailed, match='rc=3'):
        run_supervised(['mode=crash'], run_dir, stall_timeout=30.0, poll=0.2, train_command=fake_command)
    with open(os.path.join(run_dir, 'attempt_count')) as f:
        assert f.read() == '1'


def test_supervised_runs_the_port_cli_by_default(corpus, tmp_path, monkeypatch):
    """The default command is the port's CLI in a child process."""
    monkeypatch.setenv('WAV2SLEEP_DATA', str(corpus))
    run_dir = str(tmp_path / 'run')
    run_supervised(['device=cpu', *NARROW, 'batch_size=4', 'target_batch_size=4', 'epochs=1', 'test=false'],
                   run_dir, stall_timeout=300.0, poll=0.5)
    assert np.isfinite(_final(run_dir)['val_loss'])
