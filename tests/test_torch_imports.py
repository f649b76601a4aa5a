"""The torch port imports nothing of the JAX package ``wav2sleep_tpu``, and
neither JAX, flax, optax, pandas, pyarrow, yaml nor matplotlib: the port and
chip_smoke.py import, and drive their host paths (the native library, the
EDF reader and writer, every extractor, weight conversion, a checkpoint
folder, the serving CLI and the training bench on the CPU), with all of
those unavailable. No file of the port names them in an import, at module
level or inside a function, with two exceptions: the parquet module
(``data/parquet.py``) imports pyarrow and the plotting module
(``plotting.py``) matplotlib inside their functions. With pyarrow available
(the rest still blocked) the dataset, the data module, a one-epoch fit
(its confusion figures skipped), the inference API (``prepare`` ->
``predict_on_folder`` over an EDF and a CSV night) and the corpus path (an
XML and a stg parse, ``process_night``, the ingest and split command lines
on synthetic nights) run on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'wav2sleep_tpu_torch'
BLOCKED = ('wav2sleep_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'pandas', 'pyarrow', 'yaml', 'matplotlib', 'seaborn')

# The one file of the port that may name pyarrow, and the one that may name
# matplotlib (and seaborn), inside their functions.
PYARROW_MODULE = PORT / 'data' / 'parquet.py'
PLOTTING_MODULE = PORT / 'plotting.py'

_BLOCKER = '''
import importlib, importlib.machinery, pkgutil, sys, tempfile
import numpy as np
BLOCKED = %r
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]

class Blocker:
    # A blocked name is found, and its loading fails: torch._dynamo (which
    # torch.utils.checkpoint imports) probes importlib.util.find_spec for
    # optional modules, pandas among them, and takes a finder's exception
    # for a fault.
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ImportError('blocked: ' + spec.name)

    def exec_module(self, module):
        raise ImportError('blocked: ' + module.__name__)

sys.meta_path.insert(0, Blocker())
'''

_PROBE = _BLOCKER % (BLOCKED,) + f'''
import wav2sleep_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(wav2sleep_tpu_torch.__path__, 'wav2sleep_tpu_torch.'))
for m in mods:
    importlib.import_module(m)
import chip_smoke
chip_smoke.SyntheticQ8Nights(1, 0.05)  # builds and encodes its nights
from wav2sleep_tpu_torch import api, checkpoint, convert, instantiate, pipeline, serve
from wav2sleep_tpu_torch.models import wav2sleep
from wav2sleep_tpu_torch.data.edf import write_edf
convert.from_jax_variables({{'params': {{'classifier': {{'kernel': np.zeros((2, 3), np.float32)}}}}}})
with tempfile.TemporaryDirectory() as d:
    fp = d + '/n.edf'
    write_edf(fp, {{'ECG': np.sin(np.arange(3840) / 5.0), 'Thor': np.cos(np.arange(960) / 5.0)}},
              {{'ECG': 128.0, 'Thor': 32.0}}, record_duration=30.0)
    signals = ['ECG', 'THX']
    dec = pipeline.NightDecoder(signals, 0.01)
    assert dec._lib is not None  # the native library built without the JAX package
    assert dec.decode_into(fp, {{c: np.zeros(pipeline.grid_length(c, 0.01), np.float32) for c in signals}}) == 1
    q = {{c: np.zeros((1, pipeline.grid_length(c, 0.01)), np.int8) for c in signals}}
    meta = {{c: np.zeros(1, pipeline.Q8_META_DTYPE) for c in signals}}
    assert pipeline.Q8NightExtractor(signals, 0.01).extract_into(fp, q, meta, 0) == 1
    n_grid = {{c: pipeline.grid_length(c, 0.01) for c in signals}}
    q16 = {{c: np.zeros((1, n), np.int16) for c, n in n_grid.items()}}
    assert pipeline.Q16NightExtractor(signals, 0.01).extract_into(
        fp, q16, {{c: np.zeros(1, pipeline.Q16_META_DTYPE) for c in signals}}, 0) == 1
    q4 = {{c: np.zeros((1, pipeline.q4_row_len(n)), np.uint8) for c, n in n_grid.items()}}
    assert pipeline.Q4NightExtractor(signals, n_grid, 0.01).extract_into(fp, q4, meta, 0) == 1
    raw_ext = pipeline.RawNightExtractor(signals)
    raw = {{c: np.zeros((1, n), np.int16) for c, n in raw_ext.probe_bucket(fp).items()}}
    assert raw_ext.extract_into(fp, raw, {{c: np.zeros(1, pipeline.META_DTYPE) for c in signals}}, 0) == 1
    # A checkpoint folder round trip (the YAML subset, state_dict.pth) and
    # the serving CLI on the CPU.
    cfg = instantiate.target_config(**wav2sleep.flagship_config(feature_dim=16, max_channels=16))
    cfg['signal_encoders']['signal_map'] = {{'ECG': 'ECG', 'THX': 'THX'}}
    model = instantiate.build_model(cfg)
    checkpoint.save_checkpoint_folder(d + '/ckpt', cfg, model.state_dict())
    assert api.load_model(d + '/ckpt', device='cpu').valid_signals == signals
    serve.main(['--input-folder', d, '--output-folder', d + '/out', '--model-folder', d + '/ckpt',
                '--device', 'cpu', '--max-length-hours', str(1 / 120), '--batch-size', '1'])
    with open(d + '/out/n.preds.csv') as f:
        assert f.read().startswith('Timestamp,Pred\\n2000-01-01 22:00:30,')
# The profiling entry point on the CPU (the ladder's plain versions and K1's).
from wav2sleep_tpu_torch import profile_variants
assert profile_variants.run(B=1, nb=16, tb=8, k=2, reps=1, device='cpu')['device'] == 'cpu'
# The training entry point on the CPU: the step, the masker, AdamW and the
# q8 transport, with optax and the JAX package unavailable.
from wav2sleep_tpu_torch import train_bench
line = train_bench.run(batch=1, epochs_per_night=1, feature_dim=16, precision='float32', transport='q8', k=2,
                       reps=1, device='cpu', e2e=False)
assert line['device'] == 'cpu' and np.isfinite(line['loss'])
# The data-parallel layer without a group, and the version.
from wav2sleep_tpu_torch.parallel import mesh
assert mesh.make_mesh(['cpu', 'cpu']).shape == {{'data': 2, 'model': 1}}
assert not mesh.maybe_initialize_distributed() and wav2sleep_tpu_torch.__version__
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
print('IMPORTED', len(mods), 'LEAKED', leaked)
'''


def test_port_imports_without_jax_pandas_yaml():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get('PYTHONPATH', ''),
               OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-c', _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert 'LEAKED []' in proc.stdout, proc.stdout
    n = int(proc.stdout.split('IMPORTED')[1].split()[0])
    assert n >= 75, proc.stdout  # every module of the package was reached


_FIT_PROBE = _BLOCKER % (tuple(b for b in BLOCKED if b != 'pyarrow'),) + '''
import pyarrow  # available here
from wav2sleep_tpu_torch import instantiate
from wav2sleep_tpu_torch.data import parquet
from wav2sleep_tpu_torch.data.dataset import ParquetDataset
from wav2sleep_tpu_torch.train.datamodule import SleepDataModule
from wav2sleep_tpu_torch.train.loop import Trainer
from wav2sleep_tpu_torch.models.wav2sleep import flagship_config

rng = np.random.default_rng(0)
with tempfile.TemporaryDirectory() as d:
    for split in ('train', 'val'):
        for n in range(2):
            folder = f'{d}/mesa/{split}'
            import os
            os.makedirs(folder, exist_ok=True)
            labels = rng.integers(0, 4, size=2).astype(np.float32)
            parquet.write_night(f'{folder}/n{n}.parquet', {'ECG': rng.normal(size=2048).astype(np.float32),
                                                           'THX': rng.normal(size=512).astype(np.float32),
                                                           'Stage': labels})
    x, y = ParquetDataset([f'{d}/mesa/train/n0.parquet'], ['ECG', 'THX'])[0]
    assert x['ECG'].shape == (2048,) and y.shape == (2,)
    dm = SleepDataModule(columns=['ECG', 'THX'], data_location=d, train_datasets=['mesa'], val_datasets=['mesa'],
                         batch_size=2, val_batch_size=2, num_workers=1, pad_to_epochs=2, device='cpu')
    assert [name for name, _ in dm.val_loaders()] == ['all', 'mesa']
    cfg = instantiate.target_config(**flagship_config(feature_dim=16, max_channels=16))
    cfg['signal_encoders']['signal_map'] = {'ECG': 'ECG', 'THX': 'THX'}
    trainer = Trainer(model=instantiate.build_model(cfg), datamodule=dm, epochs=1, log_dir=d + '/run', flip_polarity=False,
                      progress_bar=False)
    out = trainer.fit()
    assert np.isfinite(out['val_loss']), out
    # The inference API: an EDF and a CSV night, prepared, predicted and
    # saved on the CPU.
    from wav2sleep_tpu_torch import api, checkpoint
    from wav2sleep_tpu_torch.data.edf import write_edf

    os.makedirs(d + '/in')
    write_edf(d + '/in/n.edf', {'ECG': np.sin(np.arange(7680) / 5.0), 'Thor': np.cos(np.arange(1920) / 5.0)},
              {'ECG': 128.0, 'Thor': 32.0}, record_duration=30.0)
    with open(d + '/in/c.csv', 'w') as f:
        f.write('Timestamp,ECG\\n' + ''.join(f'{t / 100!r},{float(np.sin(t / 7.0))!r}\\n' for t in range(6000)))
    checkpoint.save_checkpoint_folder(d + '/ckpt', cfg, trainer.model.state_dict())
    preds, _ = api.predict_on_folder(d + '/in', d + '/preds', model_folder=d + '/ckpt', device='cpu',
                                     max_length_hours=1 / 120, batch_size=2, tmp_root_folder=d + '/cache',
                                     return_tensors=True)
    assert [len(p) for p in preds] == [1, 1], preds
    with open(d + f'/preds/{d[1:]}/in/n.preds.csv'.replace('//', '/')) as f:
        assert f.read().startswith('Timestamp,Pred\\n2000-01-01 22:00:30.029296875,')
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
print('FIT', out['val_loss'], 'LEAKED', leaked)
'''


def test_parquet_path_and_a_fit_with_pyarrow_only():
    """pyarrow available, the JAX package, JAX, pandas and yaml blocked: the
    dataset, the data module, a one-epoch CPU fit and the inference API run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get('PYTHONPATH', ''),
               OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-c', _FIT_PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert 'LEAKED []' in proc.stdout, proc.stdout


_CORPUS_PROBE = _BLOCKER % (tuple(b for b in BLOCKED if b != 'pyarrow'),) + '''
import os
import pyarrow  # available here
from wav2sleep_tpu_torch import ingest
from wav2sleep_tpu_torch.data import get_split, parse_txt_annotations, parse_xml_annotations, synth
from wav2sleep_tpu_torch.data.edf import write_edf
from wav2sleep_tpu_torch.data.parquet import read_frame
from wav2sleep_tpu_torch.preprocessing import create_splits, ingest as ingest_cli

with tempfile.TemporaryDirectory() as d:
    sid = get_split('mesa', 'train')[0]
    raw = d + '/mesa/polysomnography'
    os.makedirs(raw + '/edfs')
    os.makedirs(raw + '/annotations-events-nsrr')
    fps, stages = synth.write_nights(raw + '/edfs', 1, 0.1, seed=0)
    os.rename(fps[0], f'{raw}/edfs/{sid}.edf')
    events = ''.join('<ScoredEvent>\\n<EventType>Stages.Stages</EventType>\\n'
                     f'<EventConcept>x|{[0, 2, 3, 5][s]}</EventConcept>\\n<Start>{30 * i}</Start>\\n'
                     '<Duration>30</Duration>\\n</ScoredEvent>' for i, s in enumerate(stages[0]))
    with open(f'{raw}/annotations-events-nsrr/{sid}-nsrr.xml', 'w') as f:
        f.write('<EventConcept>Recording Start Time</EventConcept>\\n<Start>0</Start>' + events)
    seconds, labels = parse_xml_annotations(f'{raw}/annotations-events-nsrr/{sid}-nsrr.xml')
    assert len(seconds) == 12 and seconds[0] == 30.0
    write_edf(d + '/w.edf', {'ECG': np.zeros(5 * 3600)}, {'ECG': 1.0})
    with open(d + '/w.stg.txt', 'w') as f:
        f.write('Epoch\\tUser-Defined Stage\\n' + ''.join(f'{i}\\t{i % 6}\\n' for i in range(1, 601)))
    with open(d + '/w.log.txt', 'w') as f:
        f.write('22:00:00 1\\tRecording Started\\n')
    assert parse_txt_annotations(d + '/w.stg.txt')[1][:6].tolist() == [1.0, 2.0, 3.0, 3.0, 4.0, 0.0]
    args = ingest.prepare_dataset(d + '/mesa', d + '/out', 'mesa')[sid]
    assert ingest.process_night(columns=['ECG', 'PPG', 'ABD', 'THX'], **args)
    assert sorted(read_frame(args['output_fp']).columns) == ['ABD', 'ECG', 'PPG', 'Stage', 'THX']
    assert ingest.read_signal_metadata(args['output_fp'])['ECG']['unit'] == 'uV'
    ingest_cli.main(['--folder', d + '/mesa', '--output-folder', d + '/out2', '--max-parallel', '2'])
    create_splits.main(['--folder', d + '/out2/mesa'])
    assert os.listdir(d + '/out2/mesa/train') == [sid + '.parquet']
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
print('CORPUS LEAKED', leaked)
'''


def test_corpus_path_with_pyarrow_only():
    """pyarrow available, the JAX package, JAX, pandas, yaml and matplotlib
    blocked: every corpus module imports, an XML and a stg file parse, a
    synthetic night is ingested (``process_night``, then the ingest command
    line over two spawned processes) and split."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get('PYTHONPATH', ''),
               OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-c', _CORPUS_PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert 'CORPUS LEAKED []' in proc.stdout, proc.stdout


def test_only_the_parquet_module_names_pyarrow_and_none_pandas_or_yaml():
    """No import of pandas or yaml anywhere in the port or chip_smoke.py;
    pyarrow only in ``data/parquet.py`` and matplotlib (with seaborn) only in
    ``plotting.py``, and there only inside functions (indented), so the
    modules import without them."""
    any_import = re.compile(r'^(\s*)(?:import|from)\s+(pandas|pyarrow|yaml|matplotlib|seaborn)\b', re.M)
    allowed = {PYARROW_MODULE: ('pyarrow',), PLOTTING_MODULE: ('matplotlib', 'seaborn')}
    offenders = []
    for p in _port_files():
        for m in any_import.finditer(p.read_text()):
            if m.group(2) in allowed.get(p, ()) and m.group(1):
                continue
            offenders.append(f'{p.relative_to(ROOT)}:{m.group(0).strip()!r}')
    assert not offenders, offenders
    assert any_import.search(PYARROW_MODULE.read_text())  # the exceptions are used
    assert any_import.search(PLOTTING_MODULE.read_text())


def _port_files():
    files = [p for p in PORT.rglob('*') if p.suffix in ('.py', '.cu', '.cpp')] + [ROOT / 'chip_smoke.py']
    assert len(files) >= 20
    for name in ('csrc/conv_variants.cu', 'ops/conv_variants.py', 'profile_variants.py', 'ops/q8_transport.py',
                 'train/step.py', 'train/masker.py', 'train/metrics.py', 'train/scheduler.py', 'train_bench.py',
                 'profile_train.py', 'data/parquet.py', 'data/dataset.py', 'train/datamodule.py', 'train/loop.py',
                 'train/checkpointing.py', 'train/tuning.py', 'train/supervise.py', 'train/__main__.py', 'config.py',
                 'stats.py', 'log.py', 'native/src/mulaw8.cpp', 'api.py', 'hub.py', 'data/frame.py',
                 'cli/__init__.py', 'cli/predict.py', 'cli/main.py', 'cli/data_utils.py', 'cli/model_utils.py',
                 'ingest.py', 'plotting.py', 'data/utils.py', 'data/xml.py', 'data/txt.py', 'data/nsrr.py',
                 'data/synth.py', 'parallel/map.py', 'preprocessing/fix_edfs.py', 'preprocessing/ingest.py',
                 'preprocessing/create_splits.py', 'preprocessing/census_split.py'):
        assert PORT / name in files, name
    return files


def test_no_port_file_imports_jax_or_flax():
    pattern = re.compile(r'^\s*(import jax|from jax)\b|\bflax\b', re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_files() if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_no_port_file_imports_the_jax_package():
    """``import wav2sleep_tpu...`` / ``from wav2sleep_tpu... import``
    anywhere in a file of the port or in chip_smoke.py (``wav2sleep_tpu_torch``
    is the port itself)."""
    pattern = re.compile(r'(import|from)\s+wav2sleep_tpu(\.|\s|$)', re.M)
    offenders = [
        f'{p.relative_to(ROOT)}:{m.group(0)!r}' for p in _port_files() for m in pattern.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_port_settings_are_the_jax_packages():
    from wav2sleep_tpu import settings as jax_settings
    from wav2sleep_tpu_torch import settings

    names = [n for n in vars(settings) if n.isupper()]
    assert len(names) >= 15
    for name in names:
        assert getattr(settings, name) == getattr(jax_settings, name), name
