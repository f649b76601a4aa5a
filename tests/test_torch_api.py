"""The port's inference API (``wav2sleep_tpu_torch.api`` and ``cli.predict``)
against the JAX package's (``wav2sleep_tpu.api``, ``wav2sleep_tpu.cli.predict``)
on the same inputs, made from a seed with numpy, on the CPU:

- ``prepare``'s cache: ``pd.read_parquet`` of the port's file equals the JAX
  package's frame exactly (index, columns, dtypes, NaN positions) for EDF
  nights (125/10 Hz, a night without THX, 77 Hz ECG, EOG), CSV nights (a
  datetime and a seconds index) and parquet nights; each package's
  ``load_dataset`` reads the other's cache to the same bits;
- the forward: f32 logits within 5e-4 of the JAX package's ``W2SModel``,
  bf16 within twice the JAX package's own bf16-vs-f32 error, predictions
  equal off near-ties (top-two margin 1e-3), also for a causal model;
  SleepPPG-Net's padded item against the port's own module;
- ``.preds.csv`` bytes and the CLI's kappa and accuracy equal to the JAX
  package's, and the JAX package's faults the port does not repeat (an EDF
  with none of the signals, a CSV's microsecond stamps).
"""

import datetime
import logging
import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from wav2sleep_tpu import api as japi
from wav2sleep_tpu import hub as jhub
from wav2sleep_tpu.checkpoint import save_checkpoint_folder as jax_save_folder
from wav2sleep_tpu.cli import predict as jcli
from wav2sleep_tpu.data.edf import load_edf_arrays, load_edf_data, write_edf
from wav2sleep_tpu.data.preprocessing import process_waveform_arrays
from wav2sleep_tpu.instantiate import instantiate as jax_instantiate
from wav2sleep_tpu_torch import api, hub
from wav2sleep_tpu_torch.cli import predict as cli
from wav2sleep_tpu_torch.data import edf as tedf
from wav2sleep_tpu_torch.data import frame, parquet, preprocessing
from wav2sleep_tpu_torch.instantiate import build_model

from .test_api import MODEL_CFG
from .test_torch_model import jax_random_variables

TOL = 5e-4
HOURS = 1
BATCH = 2
START = datetime.datetime(2002, 3, 1, 23, 0, 0)
N_SEC = 45 * 60  # 45-minute nights


def _cfg(signals, num_classes=4, causal=False) -> dict:
    """``test_api.MODEL_CFG`` (feature_dim 32, channels 8 -> 32) over
    ``signals``, optionally causal."""
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in MODEL_CFG.items()}
    cfg['num_classes'] = num_classes
    cfg['signal_encoders']['signal_map'] = {s: s for s in signals}
    cfg['signal_encoders']['causal'] = causal
    cfg['sequence_mixer']['causal'] = causal
    return cfg


MODELS = {'main': _cfg(('ECG', 'THX')), 'eog': _cfg(('EOG-L', 'EOG-R'), num_classes=5),
          'causal': _cfg(('ECG', 'THX'), causal=True)}


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """Per model: its checkpoint folder (written by the JAX package as
    ``state_dict.pth``, the reference's format), the JAX package's loaded
    model (f32; bf16 for 'main' too) and the port's ``W2SModel`` on the
    CPU."""
    out = {}
    for seed, (name, cfg) in enumerate(MODELS.items()):
        signals = list(cfg['signal_encoders']['signal_map'])
        jmodel = jax_instantiate(cfg)
        x0 = {s: np.zeros((1, 2 * (4096 if s.startswith('EOG') else 1024 if s == 'ECG' else 256)), np.float32)
              for s in signals}
        folder = str(tmp_path_factory.mktemp(f'ckpt_{name}'))
        jax_save_folder(folder, cfg, jax_random_variables(jmodel, x0, seed=seed + 5), torch_compat=True)
        assert os.path.exists(os.path.join(folder, 'state_dict.pth'))
        out[name] = dict(folder=folder, jax=japi.load_model(folder), port=api.W2SModel.load(folder, device='cpu'))
    out['main']['jax_bf16'] = japi.load_model(out['main']['folder'], precision='bfloat16')
    return out


def _edf_night(fp, rng, ecg_fs=125.0, thx=True):
    n = int(ecg_fs * N_SEC)
    signals = {'EKG': (np.sin(np.arange(n) / 40 * 125 / ecg_fs) + rng.normal(size=n) * 0.1) * 800}
    rates, units, ranges = {'EKG': ecg_fs}, {'EKG': 'uV', 'THOR RES': ''}, {'EKG': (-2000, 2000), 'THOR RES': (-1, 1)}
    if thx:
        signals['THOR RES'] = np.sin(np.arange(10 * N_SEC) / 100) * 0.5 + rng.normal(size=10 * N_SEC) * 0.01
        rates['THOR RES'] = 10.0
    write_edf(fp, signals=signals, sampling_freqs=rates, units=units, physical_ranges=ranges, start=START)


def _labeled_night(rng, n_epochs):
    """An ingest-layout night: ECG, THX and 5-class stages (some unscored)."""
    stages = rng.integers(0, 5, size=n_epochs).astype(np.float32)
    stages[rng.random(n_epochs) < 0.05] = 9.0  # outside the label map: ignored
    return {'ECG': rng.normal(size=n_epochs * 1024).astype(np.float32) + np.repeat(stages, 1024),
            'THX': rng.normal(size=n_epochs * 256).astype(np.float32), 'Stage': stages}


def _csv_ns_stamps(src: Path, dst: Path) -> None:
    """``src`` with each stamp's fraction written to 9 digits: the same
    instants, which pandas then parses at nanoseconds."""
    lines = src.read_text().splitlines()
    out = [lines[0]] + [f'{s}{"000000" if "." in s else ".000000000"},{rest}'
                        for s, rest in (line.split(',', 1) for line in lines[1:])]
    dst.write_text('\n'.join(out) + '\n')


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """Input folders by case, each with its signals."""
    root = tmp_path_factory.mktemp('inputs')
    rng = np.random.default_rng(0)
    for name in ('edf', 'edf_77hz', 'eog', 'csv_datetime', 'csv_ms', 'csv_ms_as_ns', 'csv_seconds',
                 'parquet_datetime', 'parquet_seconds', 'labeled'):
        (root / name).mkdir()
    for i in range(2):
        _edf_night(str(root / 'edf' / f'night{i}.edf'), rng)
    _edf_night(str(root / 'edf' / 'night2.edf'), rng, thx=False)  # no THX channel
    _edf_night(str(root / 'edf_77hz' / 'night.edf'), rng, ecg_fs=77.0)
    n = 128 * N_SEC
    write_edf(str(root / 'eog' / 'night.edf'), signals={'EOG(L)': rng.normal(size=n) * 50, 'E2': rng.normal(size=n) * 50},
              sampling_freqs={'EOG(L)': 128.0, 'E2': 128.0}, units={'EOG(L)': 'uV', 'E2': 'uV'},
              physical_ranges={'EOG(L)': (-500, 500), 'E2': (-500, 500)}, start=START)
    # CSV and parquet nights: the JAX package's frame of an EDF night (its
    # raw channels over the union of their sample times).
    df77, _ = load_edf_data(str(root / 'edf_77hz' / 'night.edf'), ['ECG', 'THX'], convert_time=True)
    df77.to_csv(root / 'csv_datetime' / 'night.csv')  # sub-microsecond stamps: 9 digits
    df125, _ = load_edf_data(str(root / 'edf' / 'night0.edf'), ['ECG', 'THX'], convert_time=True)
    df125.to_csv(root / 'csv_ms' / 'night.csv')  # millisecond stamps: 3 digits
    _csv_ns_stamps(root / 'csv_ms' / 'night.csv', root / 'csv_ms_as_ns' / 'night.csv')
    secs, _ = load_edf_data(str(root / 'edf' / 'night1.edf'), ['ECG', 'THX'])
    secs.to_csv(root / 'csv_seconds' / 'night.csv')
    df125.to_parquet(root / 'parquet_datetime' / 'night.parquet')
    secs.to_parquet(root / 'parquet_seconds' / 'night.parquet')
    # Labeled nights as ingest writes them (no index), read without
    # preprocessing: one short of the hour, one over it (truncated).
    for i, n_epochs in enumerate((100, 130)):
        parquet.write_night(str(root / 'labeled' / f'night{i}.parquet'), _labeled_night(rng, n_epochs))
    return root


SIGNALS = {'eog': ['EOG-L', 'EOG-R']}
CACHE_CASES = ['edf', 'edf_77hz', 'eog', 'csv_datetime', 'csv_seconds', 'parquet_datetime', 'parquet_seconds']


@pytest.fixture(scope='module')
def caches(inputs, tmp_path_factory):
    """Per case: the JAX package's and the port's ``prepare`` folders."""
    root = tmp_path_factory.mktemp('caches')
    out = {}
    for case in CACHE_CASES + ['csv_ms', 'csv_ms_as_ns']:
        signals = SIGNALS.get(case, ['ECG', 'THX'])
        kw = dict(signals=signals, max_length_hours=HOURS)
        out[case] = (japi.prepare(str(inputs / case), tmp_root_folder=str(root / 'jax' / case), **kw),
                     api.prepare(str(inputs / case), tmp_root_folder=str(root / 'port' / case), **kw))
    return out


def _files(folder):
    return sorted(str(p.relative_to(folder)) for p in Path(folder).rglob('*.parquet'))


@pytest.mark.parametrize('case', CACHE_CASES)
def test_cache_is_the_jax_packages_frame(caches, case):
    jax_folder, port_folder = caches[case]
    names = _files(jax_folder)
    assert names and _files(port_folder) == names
    for name in names:
        want = pd.read_parquet(os.path.join(jax_folder, name))
        got = pd.read_parquet(os.path.join(port_folder, name))
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        assert want.index.dtype == ('float64' if case.endswith('seconds') else 'datetime64[ns]')
        assert len(want) == 122_880 * (4 if case == 'eog' else 1) and want.notna().any().all()


def test_cache_path_embeds_the_input_path(caches, inputs):
    _, port_folder = caches['edf']
    rel = (inputs / 'edf').relative_to(Path(inputs).anchor)
    assert _files(port_folder) == [str(rel / f'night{i}.parquet') for i in range(3)]


@pytest.mark.parametrize('night', ['edf/night0.edf', 'edf/night2.edf', 'edf_77hz/night.edf'])
def test_edf_arrays_and_their_frame_are_the_jax_packages(inputs, night):
    """``load_edf_arrays`` (values, rates, metadata, start) and
    ``process_waveform_arrays`` (the ingest path's frame: samples at
    arange(n) / fs, a seconds index) equal the JAX package's."""
    fp = str(inputs / night)
    want, want_meta, want_start = load_edf_arrays(fp, ['ECG', 'THX'], raise_on_missing=False)
    got, got_meta, got_start = tedf.load_edf_arrays(fp, ['ECG', 'THX'])
    assert list(got) == list(want) and got_meta == want_meta and got_start == want_start
    for c in want:
        np.testing.assert_array_equal(got[c][0], want[c][0])
        assert got[c][1] == want[c][1]
    df = process_waveform_arrays(want, ['ECG', 'THX'], max_length_hours=HOURS)
    out = preprocessing.process_waveform_arrays(got, ['ECG', 'THX'], max_length_hours=HOURS)
    assert not out.datetime and list(out.columns) == list(df.columns)
    np.testing.assert_array_equal(out.index, df.index.to_numpy())
    for c in df.columns:
        np.testing.assert_array_equal(out.columns[c], df[c].to_numpy())


def test_a_night_without_thx_has_no_thx_column(caches, inputs):
    _, port_folder = caches['edf']
    night2 = [f for f in _files(port_folder) if f.endswith('night2.parquet')][0]
    assert list(pd.read_parquet(os.path.join(port_folder, night2)).columns) == ['ECG']


def test_microsecond_csv_stamps(caches):
    """pandas 3 parses stamps of up to 6 fractional digits at microseconds,
    and the JAX package's preprocessing takes the index's integers for
    nanoseconds: its cache of such a CSV squeezes the night 1000-fold (a
    fault of the JAX package, ROADMAP §C.15). The port's cache of it equals
    the JAX package's cache of the same instants written to 9 digits."""
    jax_ms, port_ms = caches['csv_ms']
    jax_ns, _ = caches['csv_ms_as_ns']
    (name,) = _files(port_ms)
    (name_ns,) = _files(jax_ns)
    got = pd.read_parquet(os.path.join(port_ms, name))
    pd.testing.assert_frame_equal(got, pd.read_parquet(os.path.join(jax_ns, name_ns)), check_exact=True)
    jax_bad = pd.read_parquet(os.path.join(jax_ms, name))
    assert 100 * (jax_bad['ECG'] != 0).sum() < (got['ECG'] != 0).sum()


@pytest.mark.parametrize('case', ['edf', 'eog', 'csv_seconds'])
def test_each_package_reads_the_others_cache(caches, case):
    """Items of each package's ``load_dataset`` over either package's cache
    are equal bit for bit."""
    signals = SIGNALS.get(case, ['ECG', 'THX'])
    items = {}
    for reader, mod in (('jax', japi), ('port', api)):
        for writer, folder in zip(('jax', 'port'), caches[case]):
            ds = mod.load_dataset(folder, signals, num_classes=4, max_length_hours=HOURS)
            items[reader, writer] = [ds[i] for i in range(len(ds))]
    want = items['jax', 'jax']
    for key, got in items.items():
        assert len(got) == len(want), key
        for (gx, gy), (wx, wy) in zip(got, want):
            assert sorted(gx) == sorted(wx), key
            for c in wx:
                np.testing.assert_array_equal(gx[c], wx[c], err_msg=str(key))
            np.testing.assert_array_equal(gy, wy)


@pytest.fixture(scope='module')
def batch(caches):
    """The first padded batch ``predict`` forms over the EDF cache (nights 0
    and 1, 120 epochs), as the JAX package's dataset gives it."""
    ds = japi.load_dataset(caches['edf'][0], ['ECG', 'THX'], num_classes=4, max_length_hours=HOURS)
    x, _ = japi.collate([japi.pad_or_truncate_item(ds[i], 120) for i in range(BATCH)])
    return x


def _clear(logits, margin):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


def test_f32_logits_match_jax(models, batch):
    want = models['main']['jax'].logits(batch)
    got = models['main']['port'].logits(batch)
    assert got.shape == want.shape == (BATCH, 120, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    clear = _clear(want, 1e-3)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_bf16_logits_within_twice_jaxs_own_bf16_error(models, batch):
    want32 = models['main']['jax'].logits(batch)
    bound = 2 * float(np.abs(models['main']['jax_bf16'].logits(batch) - want32).max())
    port = models['main']['port']
    bf16 = api.W2SModel(build_model(port.config), port.family, port.config, 'bfloat16', 'cpu')
    bf16.module.load_state_dict(port.module.state_dict())
    assert {p.dtype for p in bf16.module.parameters()} == {torch.bfloat16}
    got = bf16.logits(batch)
    assert 0 < bound and np.isfinite(got).all() and np.abs(got - want32).max() <= bound


def _recording(model):
    """``model`` with its logits kept, call by call."""
    calls = []
    logits = model.logits

    def kept(x):
        out = logits(x)
        calls.append(out)
        return out

    model.logits = kept
    return calls


@pytest.mark.parametrize('name', ['main', 'causal'])
def test_predict_matches_jax(models, caches, name):
    """``predict`` over the EDF cache (3 nights, batch 2: the second batch
    filled with a copy of its night): each padded batch's logits within
    5e-4 of the JAX package's, the predictions equal off near-ties. The
    causal model normalizes on the host (``ParquetDataset(causal=True)``)."""
    jmodel, port = models[name]['jax'], models[name]['port']
    assert port.causal == jmodel.causal == (name == 'causal')
    jds = japi.load_dataset(caches['edf'][0], ['ECG', 'THX'], max_length_hours=HOURS, causal=jmodel.causal)
    tds = api.load_dataset(caches['edf'][0], ['ECG', 'THX'], max_length_hours=HOURS, causal=port.causal)
    want_calls, got_calls = _recording(jmodel), _recording(port)
    try:
        want, want_labels = japi.predict(jmodel, jds, batch_size=BATCH)
        got, got_labels = api.predict(port, tds, device='cpu', batch_size=BATCH)
    finally:
        del jmodel.logits, port.logits
    assert want_labels is None and got_labels is None
    assert [len(p) for p in got] == [len(p) for p in want] == [120] * 3
    assert len(got_calls) == len(want_calls) == 2
    for g, w in zip(got_calls, want_calls):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    clear = np.concatenate([_clear(w, 1e-3) for w in want_calls])[:3]
    for i in range(3):
        assert got[i].dtype == np.int64
        np.testing.assert_array_equal(got[i][clear[i]], want[i][clear[i]])


def _csv_bytes(folder):
    return {str(p.relative_to(folder)): p.read_bytes() for p in sorted(Path(folder).rglob('*.preds.csv'))}


@pytest.mark.parametrize('case', ['edf', 'eog', 'csv_datetime', 'csv_seconds', 'labeled'])
def test_predict_on_folder_writes_the_jax_packages_bytes(models, inputs, tmp_path, case):
    """``predict_on_folder`` over each input folder (preprocessed into
    fresh caches; the labeled parquet nights without preprocessing) writes
    the JAX package's CSV bytes: stamps from the cache's first grid point,
    seconds for a seconds index, a Stage column with labels."""
    name = 'eog' if case == 'eog' else 'main'
    kw = dict(batch_size=BATCH, max_length_hours=HOURS, return_tensors=True, preprocess=case != 'labeled')
    want = japi.predict_on_folder(str(inputs / case), str(tmp_path / 'jax'), model=models[name]['jax'],
                                  tmp_root_folder=str(tmp_path / 'jax_cache'), **kw)
    got = api.predict_on_folder(str(inputs / case), str(tmp_path / 'port'), model=models[name]['port'].module,
                                device='cpu', tmp_root_folder=str(tmp_path / 'port_cache'), **kw)
    want_csv, got_csv = _csv_bytes(tmp_path / 'jax'), _csv_bytes(tmp_path / 'port')
    assert want_csv and list(got_csv) == list(want_csv)
    for k in want_csv:
        assert got_csv[k] == want_csv[k], k
    first = next(iter(got_csv.values())).decode().splitlines()
    assert first[0] == ('Timestamp,Pred,Stage' if case == 'labeled' else 'Timestamp,Pred')
    stamp = {'edf': '2002-03-01 23:00:30.029296875', 'eog': '2002-03-01 23:00:30.007324219',
             'csv_datetime': '2002-03-01 23:00:30.029296875', 'csv_seconds': '30.0', 'labeled': '30.0'}[case]
    assert first[1].startswith(stamp + ',')
    if case == 'labeled':
        assert got[1] is not None and [len(y) for y in got[1]] == [100, 120]
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w)


def test_save_predictions_skips_existing_files_unless_told(caches, tmp_path, caplog):
    parquet_folder = caches['edf'][1]
    ds = api.load_dataset(parquet_folder, ['ECG', 'THX'], max_length_hours=HOURS)
    preds = [np.full(120, i, np.int64) for i in range(len(ds))]
    for mod, out in ((japi, tmp_path / 'jax'), (api, tmp_path / 'port')):
        mod.save_predictions(preds, parquet_folder, str(out), ds)
        csv = sorted(out.rglob('*.preds.csv'))[0]
        csv.write_text('kept')
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            mod.save_predictions(preds, parquet_folder, str(out), ds)
        assert csv.read_text() == 'kept' and 'exists. Skipping.' in caplog.text
        mod.save_predictions(preds, parquet_folder, str(out), ds, overwrite=True)
        assert csv.read_text().startswith('Timestamp,Pred\n')
    assert _csv_bytes(tmp_path / 'jax') == _csv_bytes(tmp_path / 'port')


def test_signal_subset_error_is_the_jax_packages(models, inputs, tmp_path):
    errors = []
    for mod, model, kw in ((japi, models['main']['jax'], {}), (api, models['main']['port'], {'device': 'cpu'})):
        with pytest.raises(ValueError, match='Invalid signal subset') as e:
            mod.predict_on_folder(str(inputs / 'edf'), str(tmp_path), model=model, signals=['PPG'], **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_hub_uris_raise(tmp_path):
    with pytest.raises(hub.HubUnavailable, match='not ported'):
        api.predict_on_folder(str(tmp_path), str(tmp_path), model_folder='hf://joncarter/wav2sleep', device='cpu')
    with pytest.raises(ValueError, match='not ported'):
        cli.main(['--input-folder', str(tmp_path), '--output-folder', str(tmp_path), '--device', 'cpu'])
    with pytest.raises(hub.HubUnavailable):
        hub.upload_to_hub(str(tmp_path), 'user/repo')
    assert hub.MODEL_VARIANTS == jhub.MODEL_VARIANTS and hub.is_hf_repo_id('hf://a/b') and not hub.is_hf_repo_id('a')


@pytest.mark.parametrize('variant', sorted(jhub.MODEL_VARIANTS))
def test_model_card_is_the_jax_packages_but_for_the_implementation(variant):
    """The same frontmatter, headings, specification table and citation;
    the description and usage name the port."""
    got, want = hub.generate_model_card(variant), jhub.generate_model_card(variant)
    assert 'from wav2sleep_tpu_torch import load_model, predict_on_folder' in got

    def fixed(card):
        return [line for line in card.splitlines() if line == f'# {variant}'
                or line.startswith(('## ', '|', '- **', 'license', 'library_', '    title', '    author'))]

    assert len(fixed(want)) > 15 and fixed(got) == fixed(want)


def test_edf_with_none_of_the_signals(inputs, tmp_path, caplog):
    """The JAX package's ``prepare`` raises IndexError on an EDF with none of
    the requested signals (ROADMAP §C.14); the port logs and skips it."""
    with pytest.raises(IndexError):
        japi.prepare(str(inputs / 'eog'), ['ECG', 'THX'], max_length_hours=HOURS, tmp_root_folder=str(tmp_path / 'j'))
    with caplog.at_level(logging.ERROR):
        folder = api.prepare(str(inputs / 'eog'), ['ECG', 'THX'], max_length_hours=HOURS,
                             tmp_root_folder=str(tmp_path / 'p'))
    assert 'Failed to process' in caplog.text and 'night.edf' in caplog.text
    assert not os.path.exists(folder) or not _files(folder)


def test_cli_matches_the_jax_packages(models, inputs, tmp_path, monkeypatch, capsys):
    """``cli.predict.main`` without preprocessing over the labeled nights
    writes the JAX package's CLI's CSV bytes and prints its kappa and
    accuracy lines (the JAX CLI is handed the loaded model, not a second
    compile of it)."""
    folder = models['main']['folder']
    args = ['--input-folder', str(inputs / 'labeled'), '--model-folder', folder, '--no-preprocess',
            '--max-length-hours', str(HOURS), '--batch-size', str(BATCH)]
    monkeypatch.setattr(japi, 'load_model', lambda *a, **k: models['main']['jax'])
    jcli.main(args + ['--output-folder', str(tmp_path / 'jax')])
    want = capsys.readouterr().out
    cli.main(args + ['--output-folder', str(tmp_path / 'port'), '--device', 'cpu'])
    got = capsys.readouterr().out
    lines = [line for line in got.splitlines() if line.startswith(("Cohen's kappa: ", 'Accuracy: '))]
    assert len(lines) == 2 and got == want
    assert _csv_bytes(tmp_path / 'port') == _csv_bytes(tmp_path / 'jax')


def test_ppgnet_predict_pads_to_its_input_length(tmp_path):
    """SleepPPG-Net's ``predict`` pads a night to the model's 1,200 epochs
    and keeps the night's own: the port's module on the padded item."""
    cfg = {'_target_': 'wav2sleep_tpu.models.ppgnet.SleepPPGNet', 'n_classes': 4, 'norm': 'batch',
           'feature_dim': 32, 'activation': 'leaky', 'dropout': 0.0, 'remat': False}
    module = build_model(cfg, generator=torch.Generator().manual_seed(1)).eval()
    rng = np.random.default_rng(4)
    parquet.write_night(str(tmp_path / 'n.parquet'), {'PPG': rng.normal(size=90 * 1024).astype(np.float32)})
    ds = api.load_dataset(str(tmp_path), ['PPG'], max_length_hours=10)
    model = api.W2SModel.wrap(module, 'cpu')
    assert (model.family, model.valid_signals, model.num_classes, model.causal) == ('ppgnet', ['PPG'], 4, False)
    preds, labels = api.predict(module, ds, device='cpu', batch_size=1)
    assert labels is None and preds[0].shape == (90,)
    x, _ = api.collate([api.pad_or_truncate_item(ds[0], 1200)])
    with torch.no_grad():
        want = module(torch.from_numpy(x['PPG'])).argmax(-1).numpy()[0, :90]
    np.testing.assert_array_equal(preds[0], want)


def test_w2s_model_answers_as_the_jax_packages(models):
    for name in MODELS:
        j, p = models[name]['jax'], models[name]['port']
        assert (p.num_classes, p.valid_signals, p.causal, p.family, p.precision) == (
            j.num_classes, j.valid_signals, j.causal, j.family, j.precision)
        assert p.config == j.config and p.device == torch.device('cpu')
    module = models['main']['port'].module
    assert api.W2SModel.wrap(models['main']['port'], 'cpu') is models['main']['port']
    assert api.W2SModel.wrap(module, 'cpu').precision == 'float32'


def test_lazy_exports():
    import wav2sleep_tpu_torch
    from wav2sleep_tpu_torch.cli import data_utils, model_utils

    for name in ('load_model', 'prepare', 'load_dataset', 'predict', 'save_predictions', 'predict_on_folder'):
        assert getattr(wav2sleep_tpu_torch, name) is getattr(api, name)
    assert data_utils.prepare_dataset is api.prepare and model_utils.apply_model is api.predict
    with pytest.raises(AttributeError):
        wav2sleep_tpu_torch.not_there  # noqa: B018


# ---------- the pandas conversions of data/frame.py ----------


@pytest.mark.parametrize('fs', [77.0, 100.3, 125.0, 4096 / 30, 33.3])
def test_seconds_to_ns_is_pandas(fs):
    t = np.arange(int(fs * 600)) / fs
    np.testing.assert_array_equal(frame.seconds_to_ns(t), pd.to_timedelta(t, unit='s').to_numpy().view(np.int64))


@pytest.mark.parametrize('step_ns', [86_400 * 10**9, 30 * 10**9, 8 * 10**6, 125_000, 7_324_219, 29_296_875])
def test_format_stamps_is_to_csv(step_ns, tmp_path):
    ns = frame.datetime_to_ns(START) + np.arange(1, 5, dtype=np.int64) * step_ns
    if step_ns == 86_400 * 10**9:
        ns -= 23 * 3600 * 10**9  # at midnight: dates alone
    pd.DataFrame({'x': np.arange(4)}, index=pd.DatetimeIndex(ns.view('datetime64[ns]'))).to_csv(tmp_path / 'w.csv')
    stamps = [line.split(',')[0] for line in (tmp_path / 'w.csv').read_text().splitlines()[1:]]
    assert frame.format_stamps(ns) == stamps


@pytest.mark.parametrize('chunk_rows', [frame.CSV_CHUNK_ROWS, 7])
@pytest.mark.parametrize('kind', ['seconds', 'datetime_ns', 'datetime_ms', 'blanks'])
def test_read_csv_is_pandas(tmp_path, monkeypatch, kind, chunk_rows):
    monkeypatch.setattr(frame, 'CSV_CHUNK_ROWS', chunk_rows)  # 7: the rows arrive in 8 chunks
    rng = np.random.default_rng(1)
    n = 50
    values = {'A': rng.normal(size=n), 'B': rng.normal(size=n) * 1e-7}
    if kind == 'seconds':
        index = pd.Index(np.cumsum(rng.uniform(0.001, 0.1, size=n)))
    else:
        step = 7_324_219 if kind == 'datetime_ns' else 8_000_000
        index = pd.DatetimeIndex((frame.datetime_to_ns(START) + np.arange(n) * step).view('datetime64[ns]'))
    df = pd.DataFrame(values, index=index)
    if kind == 'blanks':
        df.iloc[::3, 0] = np.nan
        df.iloc[1::3, 1] = np.nan
    df.to_csv(tmp_path / 'x.csv')
    got = frame.read_csv(str(tmp_path / 'x.csv'))
    assert got.datetime == (kind != 'seconds') and list(got.columns) == ['A', 'B']
    # Numbers are read correctly rounded: the columns as pandas' round-trip
    # converter reads them, a seconds index as Python's float(). pandas'
    # default converter, which also reads a seconds index, is off by
    # ulps on 17-digit numbers (ROADMAP §C.16).
    kw = dict(index_col=0, parse_dates=True)
    want = pd.read_csv(tmp_path / 'x.csv', float_precision='round_trip', **kw)
    default = pd.read_csv(tmp_path / 'x.csv', **kw)
    if got.datetime:
        np.testing.assert_array_equal(got.index, want.index.as_unit('ns').asi8)
    else:
        stamps = [line.split(',')[0] for line in (tmp_path / 'x.csv').read_text().splitlines()[1:]]
        np.testing.assert_array_equal(got.index, [float(v) for v in stamps])
        np.testing.assert_allclose(got.index, default.index.to_numpy(), rtol=1e-14, atol=0)
    for c in ('A', 'B'):
        np.testing.assert_array_equal(got.columns[c], want[c].to_numpy())
        np.testing.assert_allclose(got.columns[c], default[c].to_numpy(), rtol=1e-14, atol=0)


def test_read_csv_refuses_what_pandas_would_not_frame(tmp_path):
    for text in ('t,A\nabc,1\n', 't,A\n2002-03-01 23:00:00+01:00,1\n', 't,A\n0.0,x\n'):
        (tmp_path / 'x.csv').write_text(text)
        with pytest.raises(ValueError):
            frame.read_csv(str(tmp_path / 'x.csv'), ['A'])
