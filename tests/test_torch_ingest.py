"""The port's corpus path against the JAX package's: ingest, its work
lists and fan-out, the split lists and the preprocessing command lines.

One raw corpus (NSRR-layout MESA nights with XML labels, one with EOG, a
sleep/wake-only night, a flat-PPG night, bad-unit nights, a night whose XML
does not parse; WSC nights with ``.stg.txt`` and ``.allscore.txt``; a CHAT
night with a physical maximum of 0.0, repaired by ``fix_edfs``) is ingested
once by ``wav2sleep_tpu.ingest`` and by ``wav2sleep_tpu_torch.ingest`` (one
process and two). Tolerance everywhere is exact: the same file names, the
same frames (index, column order, values, NaN positions, dtypes; the port's
rows are the JAX package's sorted by time, ROADMAP §C.19), the same
``pandas`` metadata columns and ``signal_metadata`` bytes, the same trees,
bytes and printed lines of the command lines.
"""

import datetime
import filecmp
import functools
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from wav2sleep_tpu import ingest as jax_ingest
from wav2sleep_tpu.data import dataset as jax_dataset
from wav2sleep_tpu.data import nsrr as jax_nsrr
from wav2sleep_tpu.data.edf import write_edf
from wav2sleep_tpu_torch import ingest
from wav2sleep_tpu_torch.data import dataset, nsrr
from wav2sleep_tpu_torch.parallel.map import parallelise, shard_across_hosts
from wav2sleep_tpu_torch.preprocessing import census_split, create_splits, fix_edfs

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = datetime.datetime(2000, 1, 1, 21, 58, 0)
CARDIO = ['ECG', 'PPG', 'ABD', 'THX']

# (session, stages of 2-epoch XML events, EDF options) of the MESA folder.
MESA_NIGHTS = {
    'mesa-sleep-0000': ((0, 1, 2, 3, 5, 0), {}),
    'mesa-sleep-0001': ((0, 2, 5, 4, 1, 9), {'eog': True}),  # EOG only
    'mesa-sleep-0002': ((0, 2, 0, 2, 0, 2), {}),  # sleep/wake only: quarantined
    'mesa-sleep-0003': ((0, 1, 2, 3, 5, 0), {'flat_ppg': True}),  # PPG dropped
    'mesa-sleep-0004': ((0, 1, 2, 3, 5, 0), {'ecg_unit': 'X'}),  # bad unit: quarantined
    'mesa-sleep-0005': ((0, 2, 0, 2, 0, 2), {'ecg_unit': 'X'}),  # both: still one '.issues'
    'mesa-sleep-0006': ((0, 1, 2, 3, 5, 0), {'no_start': True}),  # labels do not parse: no file
}
# Every file the ingest writes, relative to the output folder.
OUTPUTS = [
    'chat/ingest/chat-baseline-300001.parquet',
    'mesa/ingest/mesa-sleep-0000.parquet',
    'mesa/ingest/mesa-sleep-0001.parquet',
    'mesa/ingest/mesa-sleep-0002.issues.parquet',
    'mesa/ingest/mesa-sleep-0003.parquet',
    'mesa/ingest/mesa-sleep-0004.issues.parquet',
    'mesa/ingest/mesa-sleep-0005.issues.parquet',
    'wsc/ingest/wsc-allscore-1.parquet',
    'wsc/ingest/wsc-stg-1.parquet',
]


def _xml(fp, stages, no_start=False):
    parts = ['<Events>', '<ScoredEvent>']
    if not no_start:
        parts.append('<EventConcept>Recording Start Time</EventConcept>\n<Start>0</Start>')
    parts.append('</ScoredEvent>')
    t = 0.0
    for s in stages:
        parts.append('<ScoredEvent>\n<EventType>Stages.Stages</EventType>\n'
                     f'<EventConcept>Stage|{s}</EventConcept>\n<Start>{t:g}</Start>\n'
                     '<Duration>60</Duration>\n</ScoredEvent>')
        t += 60.0
    parts.append('</Events>')
    os.makedirs(os.path.dirname(fp), exist_ok=True)
    with open(fp, 'w') as f:
        f.write('\n'.join(parts))


def _edf(fp, seconds, rng, eog=False, cardio=True, flat_ppg=False, ecg_unit='uV', ecg_range=(-1500, 1500)):
    """A night at low rates (the model grids are 10 h whatever its length)."""
    signals, rates, ranges, units = {}, {}, {}, {}
    if cardio:
        t = np.arange(int(32 * seconds)) / 32
        signals = {'EKG': np.sin(t * 7.0) * 600 + rng.normal(size=t.size) * 20,
                   'Pleth': np.zeros(t.size) if flat_ppg else np.cos(t * 6.0) * 0.5,
                   'ABDO RES': np.sin(np.arange(int(4 * seconds)) / 9) * 0.4,
                   'THOR RES': np.sin(np.arange(int(4 * seconds)) / 11) * 0.3}
        rates = {'EKG': 32.0, 'Pleth': 32.0, 'ABDO RES': 4.0, 'THOR RES': 4.0}
        ranges = {'EKG': ecg_range, 'Pleth': (-1, 1), 'ABDO RES': (-1, 1), 'THOR RES': (-1, 1)}
        units = {'EKG': ecg_unit}
    if eog:
        for name, phase in (('EOG(L)', 0.0), ('EOG(R)', 1.0)):
            signals[name] = np.sin(np.arange(int(64 * seconds)) / 13 + phase) * 80
            rates[name], ranges[name], units[name] = 64.0, (-500, 500), 'uV'
    os.makedirs(os.path.dirname(fp), exist_ok=True)
    write_edf(fp, signals, rates, units=units, physical_ranges=ranges, start=START)


def _raw_corpus(root):
    rng = np.random.default_rng(0)
    mesa = os.path.join(root, 'mesa', 'polysomnography')
    for sid, (stages, opts) in MESA_NIGHTS.items():
        _xml(os.path.join(mesa, 'annotations-events-nsrr', f'{sid}-nsrr.xml'), stages, opts.get('no_start', False))
        _edf(os.path.join(mesa, 'edfs', f'{sid}.edf'), 720, rng, eog=opts.get('eog', False),
             cardio=not opts.get('eog', False), flat_ppg=opts.get('flat_ppg', False),
             ecg_unit=opts.get('ecg_unit', 'uV'))
    _xml(os.path.join(mesa, 'annotations-events-nsrr', 'mesa-sleep-0099-nsrr.xml'), (0, 1))  # no EDF: skipped

    wsc = os.path.join(root, 'wsc', 'visit1')
    _edf(os.path.join(wsc, 'wsc-stg-1.edf'), 4.5 * 3600, rng)
    with open(os.path.join(wsc, 'wsc-stg-1.stg.txt'), 'w') as f:
        f.write('Epoch\tUser-Defined Stage\n' + ''.join(
            f'{i}\t{v}\n' for i, v in enumerate([0, 1, 2, 3, 4, 5, 0, 7] * 50, start=1)))
    with open(os.path.join(wsc, 'wsc-stg-1.log.txt'), 'w') as f:
        f.write('21:58:00 1\tRecording Started\n')
    _edf(os.path.join(wsc, 'wsc-allscore-1.edf'), 4.5 * 3600, rng)
    with open(os.path.join(wsc, 'wsc-allscore-1.allscore.txt'), 'w') as f:
        f.write('21:58:00.00\tSTART RECORDING\n22:00:00.00\tSTAGE - W\n22:10:10.00\tSTAGE - N1\n'
                '23:00:00.00\tSTAGE - N2\n00:30:00.00\tSTAGE - N3\n01:10:00.00\tSTAGE - NO STAGE\n'
                '01:20:00.00\tSTAGE - R\n02:30:00.00\tSTAGE - W\n')
    _edf(os.path.join(wsc, 'wsc-unlabelled.edf'), 600, rng)  # no annotations: skipped

    chat = os.path.join(root, 'chat', 'polysomnography')
    _xml(os.path.join(chat, 'annotations-events-nsrr', 'baseline', 'chat-baseline-300001-nsrr.xml'),
         (0, 1, 2, 3, 5, 0))
    _edf(os.path.join(chat, 'edfs', 'baseline', 'chat-baseline-300001.edf'), 720, rng, ecg_range=(-1500, 0.0))
    fix_edfs.main(['--folder', os.path.join(root, 'chat')])


def _run(package, root, out, max_parallel=1, datasets=('mesa', 'wsc', 'chat')):
    written = {}
    for ds in datasets:
        fp_dict = package.prepare_dataset(os.path.join(root, ds), out, ds)
        written[ds] = package.process_files(fp_dict, max_parallel=max_parallel)
    return written


def _tree(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder) for d, _, fs in os.walk(folder) for f in fs)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The raw corpus and its ingest by JAX, by the port, and by the port
    over two processes (the WSC and CHAT nights)."""
    root = str(tmp_path_factory.mktemp('raw'))
    _raw_corpus(root)
    base = tmp_path_factory.mktemp('out')
    outs = {name: str(base / name) for name in ('jax', 'port', 'port2')}
    written = {'jax': _run(jax_ingest, root, outs['jax']), 'port': _run(ingest, root, outs['port']),
               'port2': _run(ingest, root, outs['port2'], max_parallel=2, datasets=('wsc', 'chat'))}
    return root, outs, written


def test_ingest_writes_the_same_files(corpus):
    """Exact: the same counts and file names, at one process and two."""
    _, outs, written = corpus
    assert written['jax'] == written['port'] == {'mesa': 6, 'wsc': 2, 'chat': 1}
    assert written['port2'] == {'wsc': 2, 'chat': 1}
    assert _tree(outs['jax']) == _tree(outs['port']) == OUTPUTS
    assert _tree(outs['port2']) == [n for n in OUTPUTS if not n.startswith('mesa')]


def _schema_metadata(fp):
    import pyarrow.parquet as pq

    return pq.read_schema(fp).metadata


@pytest.mark.parametrize('name', OUTPUTS)
def test_ingest_frames_match_jax(corpus, name):
    """Exact: ``pd.read_parquet`` frames (index, column order, values with
    NaN positions, dtypes; the JAX package's rows sorted by time, which is
    their order in these nights), the ``pandas`` metadata's columns and the
    ``signal_metadata`` bytes, at one process and two."""
    _, outs, _ = corpus
    expected = pd.read_parquet(os.path.join(outs['jax'], name)).sort_index(kind='stable')
    meta = _schema_metadata(os.path.join(outs['jax'], name))
    for run in ('port', 'port2') if not name.startswith('mesa') else ('port',):
        fp = os.path.join(outs[run], name)
        pd.testing.assert_frame_equal(pd.read_parquet(fp), expected, check_exact=True)
        got = _schema_metadata(fp)
        assert json.loads(got[b'pandas'])['columns'] == json.loads(meta[b'pandas'])['columns']
        assert got[b'signal_metadata'] == meta[b'signal_metadata']
        assert ingest.read_signal_metadata(fp) == jax_ingest.read_signal_metadata(fp)


def test_ingest_quality_checks(corpus):
    """The QC outcomes themselves: a flat PPG dropped, the repaired CHAT
    ECG skipped as BROKEN, EOG kept, labels -1 past the night, N4 -> 3."""
    _, outs, _ = corpus
    cols = {n: list(pd.read_parquet(os.path.join(outs['port'], n)).columns) for n in OUTPUTS}
    assert cols['mesa/ingest/mesa-sleep-0003.parquet'] == ['ECG', 'ABD', 'THX', 'Stage']
    assert cols['chat/ingest/chat-baseline-300001.parquet'] == ['PPG', 'ABD', 'THX', 'Stage']
    assert cols['mesa/ingest/mesa-sleep-0001.parquet'] == ['EOG-L', 'EOG-R', 'Stage']
    stage = pd.read_parquet(os.path.join(outs['port'], 'mesa/ingest/mesa-sleep-0001.parquet'))['Stage'].dropna()
    np.testing.assert_array_equal(stage.to_numpy()[:14], [0, 0, 2, 2, 4, 4, 3, 3, 1, 1, -1, -1, -1, -1])


@pytest.mark.parametrize('columns', [CARDIO + ['EOG-L', 'EOG-R'], ['THX', 'ECG', 'EOG-R']])
def test_mixed_grids_keep_pandas_row_order(columns, monkeypatch, tmp_path):
    """Exact, on a cardio + EOG night at 0.05 h grids (the label grid and
    the resampling cut to match in both packages): ``pd.concat(axis=1)``
    puts the first signal's grid first and appends the points of later,
    finer grids after it, out of time order; the port's frame holds the same
    (time, row) pairs, values and NaN positions, in time order (ROADMAP
    §C.19)."""
    from wav2sleep_tpu.data import preprocessing as jax_pre
    from wav2sleep_tpu_torch.data import preprocessing as pre

    hours = 0.05
    labels = np.arange(0, hours * 3600 + 1, 30.0)[1:]
    monkeypatch.setattr(jax_ingest, 'TARGET_LABEL_INDEX', pd.Index(labels))
    monkeypatch.setattr(ingest, 'TARGET_LABEL_INDEX', labels)
    monkeypatch.setattr(jax_ingest, 'process_waveform_arrays', functools.partial(
        jax_pre.process_waveform_arrays, max_length_hours=hours))
    monkeypatch.setattr(ingest, 'process_waveform_arrays', functools.partial(
        pre.process_waveform_arrays, max_length_hours=hours))
    edf_fp, xml_fp = str(tmp_path / 'n.edf'), str(tmp_path / 'n-nsrr.xml')
    _edf(edf_fp, 200, np.random.default_rng(1), eog=True)
    _xml(xml_fp, (0, 1, 3))
    for mod in (jax_ingest, ingest):
        assert mod.process_night(edf_fp, xml_fp, str(tmp_path / mod.__name__ / 'n.parquet'), columns)
    want, got = (pd.read_parquet(tmp_path / mod.__name__ / 'n.parquet') for mod in (jax_ingest, ingest))
    assert not want.index.is_monotonic_increasing
    assert got.index.is_monotonic_increasing
    pd.testing.assert_frame_equal(got, want.sort_index(kind='stable'), check_exact=True)


def test_eog_beside_cardio_reads_in_time_order(tmp_path):
    """Exact, on a ten-hour cardio + EOG night ingested at the default
    columns (``EDF_COLS``: the cardio channels, then the finer EOG grid):
    each package's ``ParquetDataset`` reads from the port's file the EOG
    resampled onto its grid in time order and z-scored, and the cardio
    channels as they read from a cardio-only ingest of the same night."""
    from wav2sleep_tpu_torch.data.edf import load_edf_arrays
    from wav2sleep_tpu_torch.data.preprocessing import EDF_COLS, interp_to_grid, signal_target_grid

    edf_fp, xml_fp = str(tmp_path / 'n.edf'), str(tmp_path / 'n-nsrr.xml')
    _edf(edf_fp, 200, np.random.default_rng(3), eog=True)
    _xml(xml_fp, (0, 1, 3))
    for name, columns in (('mixed', EDF_COLS), ('cardio', CARDIO)):
        assert ingest.process_night(edf_fp, xml_fp, str(tmp_path / name / 'n.parquet'), columns)
    arrays, _, _ = load_edf_arrays(edf_fp, columns=['EOG-L', 'EOG-R'])
    eog = {}
    for col, (sig, fs) in arrays.items():
        grid = signal_target_grid(col, 10.0)
        eog[col] = interp_to_grid(np.arange(len(sig)) / fs, sig, grid, interior_only=True,
                                  fill_value=0.0).astype(np.float32)
    mixed = str(tmp_path / 'mixed' / 'n.parquet')
    for mod in (dataset, jax_dataset):
        want = mod.zscore_normalize(eog)
        x, y = mod.ParquetDataset([mixed], ['EOG-L', 'EOG-R'])[0]
        for col in want:
            np.testing.assert_array_equal(x[col], want[col])
        xc, yc = mod.ParquetDataset([str(tmp_path / 'cardio' / 'n.parquet')], CARDIO)[0]
        xm, ym = mod.ParquetDataset([mixed], CARDIO)[0]
        for col in CARDIO:
            np.testing.assert_array_equal(xm[col], xc[col])
        np.testing.assert_array_equal(y, yc)
        np.testing.assert_array_equal(ym, yc)


def _eog_in_time_order(edf_fp):
    from wav2sleep_tpu_torch.data.edf import load_edf_arrays
    from wav2sleep_tpu_torch.data.preprocessing import interp_to_grid, signal_target_grid

    arrays, _, _ = load_edf_arrays(edf_fp, columns=['EOG-L', 'EOG-R'])
    return {col: interp_to_grid(np.arange(len(sig)) / fs, sig, signal_target_grid(col, 10.0), interior_only=True,
                                fill_value=0.0).astype(np.float32) for col, (sig, fs) in arrays.items()}


def _reads(monkeypatch):
    """Record the ``time_order`` of every parquet read the port's dataset makes."""
    from wav2sleep_tpu_torch.data import parquet

    seen, read = [], parquet._read

    def spy(fp, columns, time_order):
        seen.append(time_order)
        return read(fp, columns, time_order)

    monkeypatch.setattr(parquet, '_read', spy)
    return seen


def test_jax_mixed_night_reads_in_time_order(monkeypatch, tmp_path):
    """Exact (ROADMAP §C.21): a cardio + EOG night that the JAX package
    ingested at its default columns holds the EOG rows out of time order.
    The port's ``ParquetDataset`` reads its EOG as the signal resampled in
    time order and z-scored, and its cardio channels as from JAX's
    cardio-only file, with the stored index read for that file only; JAX's
    own dataset still reads the EOG scrambled."""
    from wav2sleep_tpu_torch.data import parquet
    from wav2sleep_tpu_torch.data.preprocessing import EDF_COLS

    edf_fp, xml_fp = str(tmp_path / 'n.edf'), str(tmp_path / 'n-nsrr.xml')
    _edf(edf_fp, 200, np.random.default_rng(3), eog=True)
    _xml(xml_fp, (0, 1, 3))
    mixed, cardio = str(tmp_path / 'mixed.parquet'), str(tmp_path / 'cardio.parquet')
    assert jax_ingest.process_night(edf_fp, xml_fp, mixed, EDF_COLS)
    assert jax_ingest.process_night(edf_fp, xml_fp, cardio, CARDIO)
    assert parquet.read_layout(mixed)[1] and not parquet.read_layout(cardio)[1]
    want = dataset.zscore_normalize(_eog_in_time_order(edf_fp))
    seen = _reads(monkeypatch)
    x, y = dataset.ParquetDataset([mixed], ['EOG-L', 'EOG-R'])[0]
    for col in want:
        np.testing.assert_array_equal(x[col], want[col])
    jx, jy = jax_dataset.ParquetDataset([mixed], ['EOG-L', 'EOG-R'])[0]
    assert not np.array_equal(jx['EOG-L'], want['EOG-L'])  # the JAX package's reading, §C.19
    np.testing.assert_array_equal(y, jy)
    xm, ym = dataset.ParquetDataset([mixed], CARDIO)[0]
    xc, yc = dataset.ParquetDataset([cardio], CARDIO)[0]
    assert seen == [True, True, False]
    for col in CARDIO:
        np.testing.assert_array_equal(xm[col], xc[col])
    np.testing.assert_array_equal(ym, yc)


def test_jax_folder_model_cache_reads_in_time_order(monkeypatch, tmp_path):
    """Exact (ROADMAP §C.21): the cache that the JAX API's ``prepare`` writes
    for a model loaded from a folder (ABD's grid first) reads in the port as
    the port's own cache of the same night, which is in time order and marked
    so: the index is read for JAX's file and not for the port's."""
    from wav2sleep_tpu import api as jax_api
    from wav2sleep_tpu_torch import api
    from wav2sleep_tpu_torch.data import parquet

    folder = tmp_path / 'edfs'
    _edf(str(folder / 'n.edf'), 200, np.random.default_rng(4))
    signals = ['ABD', 'ECG', 'PPG', 'THX']
    theirs = jax_api.prepare(str(folder), signals, tmp_root_folder=str(tmp_path / 'jax'))
    ours = api.prepare(str(folder), signals, tmp_root_folder=str(tmp_path / 'port'))
    (jfp,), (tfp,) = (sorted(str(p) for p in Path(d).rglob('*.parquet')) for d in (theirs, ours))
    assert parquet.read_layout(jfp)[1] and not parquet.read_layout(tfp)[1]
    assert parquet.schema_metadata(tfp)[parquet.TIME_ORDER_KEY] == b'time-order'
    seen = _reads(monkeypatch)
    kw = dict(columns=signals, require_labels=False)
    got, _ = dataset.ParquetDataset([jfp], **kw)[0]
    want, _ = dataset.ParquetDataset([tfp], **kw)[0]
    assert seen == [True, False]
    for col in signals:
        np.testing.assert_array_equal(got[col], want[col])
    scrambled, _ = jax_dataset.ParquetDataset([jfp], **kw)[0]
    assert not np.array_equal(scrambled['ECG'], want['ECG'])


def test_other_files_read_as_before(corpus, monkeypatch, tmp_path):
    """Bit for bit as the column read without the index, with no index read:
    the port's own files, a mixed cardio + EOG night that the port ingested
    among them, and the JAX package's cardio-only files."""
    from wav2sleep_tpu_torch.data import parquet
    from wav2sleep_tpu_torch.data.preprocessing import EDF_COLS

    _, outs, _ = corpus
    edf_fp, xml_fp = str(tmp_path / 'n.edf'), str(tmp_path / 'n-nsrr.xml')
    _edf(edf_fp, 200, np.random.default_rng(3), eog=True)
    _xml(xml_fp, (0, 1, 3))
    mixed = str(tmp_path / 'mixed.parquet')
    assert ingest.process_night(edf_fp, xml_fp, mixed, EDF_COLS)
    names = [n for n in OUTPUTS if not n.endswith('.issues.parquet')]
    fps = [os.path.join(outs[run], n) for run in ('jax', 'port') for n in names if run == 'port' or 'sleep-0001' not in n]
    seen = _reads(monkeypatch)
    for fp in fps + [mixed]:
        cols = [c for c in EDF_COLS if c in parquet.get_parquet_cols(fp)]
        got, _ = dataset.ParquetDataset([fp], cols)[0]
        n_reads = len(seen)
        raw = parquet.read_columns(fp, cols)
        del seen[n_reads:]
        for col in cols:
            x = raw[col][~np.isnan(raw[col])].astype(np.float32)
            np.testing.assert_array_equal(got[col], dataset.zscore_normalize({col: x})[col])
    assert len(seen) == len(fps) + 1 and not any(seen)


def test_api_frames_keep_time_order_where_jax_does_not():
    """Exact: the frame the port's API path builds (``process_waveform_arrays``
    with its default time order) is the JAX package's frame sorted by time,
    where JAX's own rows are out of time order (ABD's grid first, as in a
    model loaded from a checkpoint folder; ROADMAP §C.19)."""
    from wav2sleep_tpu.data import preprocessing as jax_pre
    from wav2sleep_tpu_torch.data import preprocessing as pre

    rng = np.random.default_rng(2)
    arrays = {'ABD': (rng.normal(size=800), 4.0), 'ECG': (rng.normal(size=6400), 32.0)}
    got = pre.process_waveform_arrays(arrays, ['ABD', 'ECG'], max_length_hours=0.05)
    want = jax_pre.process_waveform_arrays(arrays, ['ABD', 'ECG'], max_length_hours=0.05)
    assert not want.index.is_monotonic_increasing
    want = want.sort_index()
    np.testing.assert_array_equal(got.index, want.index)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(got.columns[col], want[col].to_numpy())


def test_ingest_rerun_skips_as_jax(corpus):
    """Exact: a rerun writes nothing, for written and quarantined nights."""
    root, outs, _ = corpus
    assert _run(jax_ingest, root, outs['jax']) == _run(ingest, root, outs['port']) == {'mesa': 0, 'wsc': 0, 'chat': 0}
    args = ingest.prepare_dataset(os.path.join(root, 'mesa'), outs['port'], 'mesa')['mesa-sleep-0002']
    assert not ingest.process_night(columns=CARDIO, **args)
    assert ingest.process_night(columns=CARDIO, overwrite=True, **args)


@pytest.mark.parametrize('ds', ['mesa', 'wsc', 'chat', 'shhs'])
def test_prepare_dataset_matches_jax(corpus, ds):
    """Exact: the same {session: {edf_fp, label_fp, output_fp}} (an unknown
    dataset's folder takes every EDF, without labels)."""
    root, _, _ = corpus
    folder = os.path.join(root, 'mesa' if ds == 'shhs' else ds)
    name = 'other' if ds == 'shhs' else ds
    assert ingest.prepare_dataset(folder, '/out', name) == jax_ingest.prepare_dataset(folder, '/out', name)


@pytest.mark.parametrize('session,dataset', [('shhs1-200001', 'shhs'), ('mros-visit1-aa0001', 'mros'),
                                             ('chat-baseline-300001', 'chat'), ('chat-nonrandomized-1', 'chat'),
                                             ('cfs-visit5-800002', 'cfs'), ('mesa-sleep-0001', 'mesa')])
def test_get_edf_path_matches_jax(corpus, session, dataset):
    """Exact: the same layout, the ``_fixed.edf`` preferred where it exists."""
    root, _, _ = corpus
    folder = os.path.join(root, dataset)
    assert ingest.get_edf_path(session, dataset, folder) == jax_ingest.get_edf_path(session, dataset, folder)


def test_each_package_reads_the_others_ingest(corpus):
    """Exact: each ``ParquetDataset`` gives bit-equal items from the other
    package's files as from its own package's (nights whose JAX rows are in
    time order; ``test_eog_beside_cardio_reads_in_time_order`` reads the
    others)."""
    _, outs, _ = corpus
    names = [n for n in OUTPUTS if 'issues' not in n and 'chat' not in n and '0001' not in n]
    for cols, names in ((CARDIO, names), (['EOG-L', 'EOG-R'], [OUTPUTS[2]])):
        for mod in (dataset, jax_dataset):
            a = mod.ParquetDataset([os.path.join(outs['jax'], n) for n in names], cols)
            b = mod.ParquetDataset([os.path.join(outs['port'], n) for n in names], cols)
            for i in range(len(names)):
                (xa, ya), (xb, yb) = a[i], b[i]
                assert list(xa) == list(xb)
                for k in xa:
                    assert xa[k].dtype == xb[k].dtype
                    np.testing.assert_array_equal(xa[k], xb[k])
                np.testing.assert_array_equal(ya, yb)


def test_parallelise_ordered_and_bounded():
    """Exact: ordered results over spawned processes (a function of a light
    module, which each worker imports), more items than processes."""
    import math

    assert parallelise(math.factorial, range(12), max_parallel=3) == [math.factorial(i) for i in range(12)]


@pytest.mark.parametrize('count', [1, 2, 3, 7])
def test_shard_across_hosts_covers_each_item_once(count):
    """Exact: the shards of every rank cover each item once, as JAX's."""
    from wav2sleep_tpu.parallel.map import shard_across_hosts as jax_shard

    items = [f'night{i}' for i in range(10)]
    shards = [shard_across_hosts(items, i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == sorted(items)
    assert shards == [jax_shard(items, i, count) for i in range(count)]


def test_shard_across_hosts_reads_the_process_group():
    """Rank 0 of 1 without a group, and the group's rank and size with one."""
    import torch.distributed as dist

    items = list(range(5))
    assert shard_across_hosts(items) == items
    dist.init_process_group('gloo', init_method='tcp://localhost:29517', world_size=1, rank=0)
    try:
        assert shard_across_hosts(items) == items
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Split lists and the preprocessing command lines
# ---------------------------------------------------------------------------

JAX_SPLITS = os.path.join(REPO, 'wav2sleep_tpu', 'data', 'splits')
PORT_SPLITS = os.path.join(REPO, 'wav2sleep_tpu_torch', 'data', 'splits')


def _lists(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
                  if f.endswith('.txt'))


def test_splits_copy_is_byte_equal():
    """Exact: the port's 21 lists are the JAX package's, byte for byte."""
    names = _lists(PORT_SPLITS)
    assert names == _lists(JAX_SPLITS) and len(names) == 21
    _, mismatch, errors = filecmp.cmpfiles(JAX_SPLITS, PORT_SPLITS, names, shallow=False)
    assert mismatch == errors == []


def test_split_lists_match_jax(monkeypatch, tmp_path):
    """Exact: ``get_split`` of every list (16,368 IDs), the env override,
    ``get_dataset`` and its failure."""
    monkeypatch.delenv('WAV2SLEEP_SPLITS', raising=False)
    total = 0
    for ds in ('shhs', 'mesa', 'cfs', 'chat', 'ccshs', 'mros', 'wsc', 'census', 'nope'):
        for split in ('train', 'val', 'test'):
            ids = nsrr.get_split(ds, split)
            assert ids == jax_nsrr.get_split(ds, split)
            total += len(ids)
    assert total == 16368
    (tmp_path / 'mesa').mkdir()
    (tmp_path / 'mesa' / 'train.txt').write_text('a\n\nb\n')
    monkeypatch.setenv('WAV2SLEEP_SPLITS', str(tmp_path))
    assert nsrr.get_split('mesa', 'train') == jax_nsrr.get_split('mesa', 'train') == ['a', 'b']
    for fp in ('/d/shhs/x.parquet', '/d/census/val/mesa-1.parquet', '/d/chat/ingest/y.parquet'):
        assert nsrr.get_dataset(fp) == jax_nsrr.get_dataset(fp)
    with pytest.raises(ValueError):
        nsrr.get_dataset('/d/other/x.parquet')


def test_import_splits_copies_into_the_port(monkeypatch, tmp_path):
    """``import_splits`` copies new lists, keeps existing ones unless told."""
    monkeypatch.setattr(nsrr, '_LOCAL_SPLITS', str(tmp_path / 'local'))
    src = tmp_path / 'src'
    (src / 'mesa').mkdir(parents=True)
    (src / 'mesa' / 'train.txt').write_text('x\n')
    (src / 'mesa' / 'notes.md').write_text('-')
    assert nsrr.import_splits(str(src)) == 1
    assert nsrr.import_splits(str(src)) == 0
    assert nsrr.import_splits(str(src), overwrite=True) == 1
    assert (tmp_path / 'local' / 'mesa' / 'train.txt').read_text() == 'x\n'


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(name.replace('.py', ''), os.path.join(REPO, 'preprocessing', name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(main, argv, monkeypatch, capsys, port):
    """Run a command line's main; (printed lines, the exception class)."""
    error = None
    try:
        if port:
            main(argv)
        else:
            monkeypatch.setattr(sys, 'argv', ['script', *argv])
            main()
    except Exception as e:  # noqa: BLE001 - the class is compared
        error = type(e).__name__
    return capsys.readouterr().out, error


def _snapshot(folder):
    """Each file of a tree: its symlink target relative to ``folder`` or
    its bytes."""
    out = {}
    for rel in _tree(folder):
        fp = os.path.join(folder, rel)
        out[rel] = ('link', os.path.relpath(os.readlink(fp), folder)) if os.path.islink(fp) else open(fp, 'rb').read()
    return out


def _toy_ingest(folder, dataset, names):
    for name in names:
        fp = os.path.join(folder, dataset, 'ingest', name)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        with open(fp, 'wb') as f:
            f.write(name.encode())


@pytest.mark.parametrize('copy', [False, True], ids=['symlink', 'copy'])
def test_create_splits_matches_jax(copy, monkeypatch, capsys, tmp_path):
    """Exact: the same printed lines and trees (symlinks or copies) as
    ``preprocessing/2a_create_splits_paper.py``, on a first run, a rerun and
    after a dangling link."""
    monkeypatch.delenv('WAV2SLEEP_SPLITS', raising=False)
    ids = nsrr.get_split('mesa', 'train')[:2] + nsrr.get_split('mesa', 'val')[:1] + nsrr.get_split('mesa', 'test')[:1]
    names = [f'{ids[0]}.parquet', f'{ids[1]}.issues.parquet', f'{ids[2]}.parquet', f'{ids[3]}.parquet',
             'mesa-sleep-9999999.parquet']
    jax_main = _jax_script('2a_create_splits_paper.py').main
    for run in ('first', 'rerun', 'dangling'):
        outputs = {}
        for port in (False, True):
            root = str(tmp_path / ('port' if port else 'jax'))
            if run == 'first':
                _toy_ingest(root, 'mesa', names)
            if run == 'dangling':
                os.rename(os.path.join(root, 'mesa', 'ingest'), os.path.join(root, 'mesa', 'moved'))
                _toy_ingest(root, 'mesa', names[:1])
            argv = ['--folder', os.path.join(root, 'mesa')] + (['--copy'] if copy else [])
            printed, error = _call(create_splits.main if port else jax_main, argv, monkeypatch, capsys, port)
            outputs[port] = (printed.replace(root, 'ROOT'), error, _snapshot(os.path.join(root, 'mesa')))
        assert outputs[True] == outputs[False], run


def test_census_split_matches_jax(monkeypatch, capsys, tmp_path):
    """Exact: the same trees and lines as
    ``preprocessing/2b_create_census_split.py``, ``.issues`` taken out of
    the names, and the same failure when a census session is missing."""
    val_ids = nsrr.get_split('census', 'val')[:2]
    test_ids = nsrr.get_split('census', 'test')[:1]
    custom = tmp_path / 'splits' / 'census'
    custom.mkdir(parents=True)
    (custom / 'val.txt').write_text('\n'.join(val_ids) + '\n')
    (custom / 'test.txt').write_text('\n'.join(test_ids) + '\n')
    monkeypatch.setenv('WAV2SLEEP_SPLITS', str(tmp_path / 'splits'))
    jax_main = _jax_script('2b_create_census_split.py').main
    for run in ('complete', 'missing'):
        outputs = {}
        for port in (False, True):
            root = str(tmp_path / ('port' if port else 'jax'))
            if run == 'complete':
                _toy_ingest(root, 'ccshs', [f'{s}.parquet' for s in val_ids])
                _toy_ingest(root, 'cfs', [f'{test_ids[0]}.issues.parquet', 'cfs-visit5-1.parquet'])
            else:
                os.remove(os.path.join(root, 'ccshs', 'ingest', f'{val_ids[0]}.parquet'))
                os.remove(os.path.join(root, 'census', 'val', f'{val_ids[0]}.parquet'))
            printed, error = _call(census_split.main if port else jax_main, ['--folder', root], monkeypatch, capsys,
                                   port)
            outputs[port] = (printed.replace(root, 'ROOT'), error, _snapshot(root))
        assert outputs[True] == outputs[False], run
    assert outputs[True][1] == 'ValueError'


def test_fix_edfs_bytes_match_jax(monkeypatch, capsys, tmp_path):
    """Exact: the same ``_fixed.edf`` bytes, the same lines printed, and
    the skip of a fixed file, as ``preprocessing/0_fix_edfs.py``."""
    jax_main = _jax_script('0_fix_edfs.py').main
    outputs = {}
    for port in (False, True):
        folder = tmp_path / ('port' if port else 'jax')
        for name, ranges in (('a/broken', {'CHIN': (0.0, 0.0), 'ECG': (-1, 1)}),
                             ('b/fine', {'CHIN': (-1, 1), 'ECG': (-1, 1)}),
                             ('b/two', {'CHIN': (-3, 0.0), 'ECG': (-2.0, 0)})):
            os.makedirs(folder / os.path.dirname(name), exist_ok=True)
            write_edf(str(folder / f'{name}.edf'), {'CHIN': np.zeros(300), 'ECG': np.sin(np.arange(300.0))},
                      {'CHIN': 10.0, 'ECG': 10.0}, physical_ranges=ranges)
        runs = [_call(fix_edfs.main if port else jax_main, ['--folder', str(folder)], monkeypatch, capsys, port)
                for _ in range(2)]
        outputs[port] = (runs, _snapshot(str(folder)))
    assert outputs[True] == outputs[False]
    assert sorted(outputs[True][1]) == ['a/broken.edf', 'a/broken_fixed.edf', 'b/fine.edf', 'b/two.edf',
                                        'b/two_fixed.edf']
    assert outputs[True][0][0][0] == 'Found 3 EDF files.\nFixed 2 EDF files.\n'
