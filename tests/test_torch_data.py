"""The port's parquet data path (``data.parquet``, ``data.dataset``,
``train.datamodule``), its q8 (native) and q16 encoders and f64 causal
normalization, and its stats, against the JAX package on the same files:
items and batches bit for bit, the same file lists and loader names, the
same codes."""

import numpy as np
import pandas as pd
import pytest

from wav2sleep_tpu import stats as jstats
from wav2sleep_tpu.data import dataset as jds
from wav2sleep_tpu.data import utils as jutils
from wav2sleep_tpu.ops import ema_norm as jema
from wav2sleep_tpu.ops import q8_transport as jq8
from wav2sleep_tpu.train import datamodule as jdm
from wav2sleep_tpu_torch import stats
from wav2sleep_tpu_torch.data import dataset as ds
from wav2sleep_tpu_torch.data import parquet
from wav2sleep_tpu_torch.ops import ema_norm
from wav2sleep_tpu_torch.ops import q8_transport as q8
from wav2sleep_tpu_torch.train import datamodule as dm

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

EPOCHS = 6  # sleep epochs a night
SPE = {'ECG': 1024, 'PPG': 1024, 'ABD': 256, 'THX': 256}


def night(rng, labels, signals=('ECG', 'THX'), scale=1.0):
    """Class-separable signals as tests/train/test_trainer_smoke.py writes
    them (stage k has its own amplitude), plus PPG and ABD."""
    out = {}
    for s in signals:
        n = SPE[s]
        base = np.sin(np.arange(n) / 3.0) if n == 1024 else np.ones(n)
        out[s] = np.concatenate([(lab + 1.0) * scale * base + 0.05 * rng.normal(size=n) for lab in labels])
    return {k: v.astype(np.float32) for k, v in out.items()}


def write_port_night(fp, signals, stage):
    """One night through the port's writer: shorter columns null-padded."""
    parquet.write_night(str(fp), {**signals, 'Stage': np.asarray(stage, np.float32)}, metadata={'ECG': {'fs': 256}})


def write_pandas_night(fp, signals, stage, index=True):
    """One night as pandas writes it (the JAX tests' and ingest's way), with
    a stored non-range index."""
    total = max(len(v) for v in signals.values())
    cols = {}
    for k, v in {**signals, 'Stage': np.asarray(stage, np.float32)}.items():
        col = np.full(total, np.nan, np.float32)
        col[: len(v)] = v
        cols[k] = col
    frame = pd.DataFrame(cols, index=np.arange(total) / 32.0 if index else None)
    frame.to_parquet(fp)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """mesa and shhs, 4 nights a split; every other night written by pandas;
    one mesa train night without THX, one with PPG; an .issues night; a
    census val split."""
    root = tmp_path_factory.mktemp('corpus')
    rng = np.random.default_rng(0)
    for d in ('mesa', 'shhs', 'census'):
        for split in ('train', 'val', 'test'):
            if d == 'census' and split != 'val':
                continue
            folder = root / d / split
            folder.mkdir(parents=True)
            for n in range(4):
                labels = rng.integers(0, 5, size=EPOCHS).astype(np.float32)
                signals = ('ECG',) if (d, split, n) == ('mesa', 'train', 1) else ('ECG', 'THX')
                if (d, split, n) == ('mesa', 'train', 2):
                    signals = ('ECG', 'THX', 'PPG')
                sig = night(rng, labels, signals, scale=1.0 + n)
                writer = write_pandas_night if n % 2 else write_port_night
                writer(folder / f'{d}-night{n}.parquet', sig, labels)
    write_pandas_night(root / 'mesa' / 'train' / 'bad.issues.parquet', {'ECG': np.zeros(1024, np.float32)},
                       np.zeros(1, np.float32))
    return root


def _nights(root):
    return sorted(str(p) for p in root.rglob('*.parquet') if '.issues' not in p.name)


def _items_equal(a, b):
    (xa, ya), (xb, yb) = a, b
    assert list(xa) == list(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype, k
        np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
    assert ya.dtype == yb.dtype
    np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------- parquet


def test_read_columns_matches_pandas(corpus):
    """Every night, both writers: the port's columns are pandas' columns
    (nulls as NaN, the stored index left out), and the schema probe gives
    pandas' column names."""
    for fp in _nights(corpus):
        frame = pd.read_parquet(fp)
        cols = parquet.read_columns(fp)
        assert list(cols) == list(frame.columns) == parquet.get_parquet_cols(fp) == jutils.get_parquet_cols(fp)
        for k, v in cols.items():
            np.testing.assert_array_equal(v, frame[k].to_numpy(), err_msg=f'{fp}:{k}')
            assert v.dtype == frame[k].dtype
        assert parquet.read_columns(fp, ['Stage']).keys() == {'Stage'}


def test_write_night_round_trip(tmp_path):
    fp = str(tmp_path / 'n.parquet')
    parquet.write_night(fp, {'ECG': np.arange(8, dtype=np.float32), 'THX': np.array([1.0, np.nan], np.float32)},
                        metadata={'ECG': {'units': 'mV'}})
    frame = pd.read_parquet(fp)
    assert list(frame.columns) == ['ECG', 'THX'] and len(frame) == 8
    assert frame['THX'].isna().sum() == 7  # NaN and padding both read as missing
    from wav2sleep_tpu.ingest import read_signal_metadata

    assert read_signal_metadata(fp) == {'ECG': {'units': 'mV'}}


def test_read_columns_retries_then_raises(tmp_path):
    with pytest.raises(ValueError, match='Failed to read parquet'):
        parquet.read_columns(str(tmp_path / 'missing.parquet'), max_retries=1)
    with pytest.raises(FileNotFoundError):
        parquet.get_parquet_fps(str(tmp_path / 'nowhere'))


# ---------------------------------------------------------------- dataset


@pytest.mark.parametrize('causal', [False, True], ids=['zscore', 'causal'])
@pytest.mark.parametrize('num_classes', [4, 5])
def test_items_bit_equal_jax(corpus, causal, num_classes):
    """All columns requested (PPG and ABD missing from most nights: -inf at
    their length), both label maps, both normalizations, and a truncation
    to 4 of the 6 epochs."""
    fps = _nights(corpus)
    cols = ['ECG', 'THX', 'PPG', 'ABD']
    for hours in (None, 4 / 120):
        ours = ds.ParquetDataset(fps, cols, num_classes=num_classes, max_length_hours=hours, causal=causal)
        theirs = jds.ParquetDataset(fps, cols, num_classes=num_classes, max_length_hours=hours, causal=causal)
        for i in range(len(fps)):
            _items_equal(ours[i], theirs[i])
        x, y = ours[0]
        assert y.shape == (EPOCHS if hours is None else 4,) and np.isinf(x['ABD']).all()


def test_unscored_and_other_stages_label_minus_one(tmp_path):
    rng = np.random.default_rng(3)
    stage = np.array([0, -1, 4, 9, 2.5, 3], np.float32)  # -1 unscored, 9 and 2.5 outside the map
    sig = night(rng, np.zeros(6))
    fp = str(tmp_path / 'n.parquet')
    write_port_night(fp, sig, stage)
    for n in (4, 5):
        got = ds.ParquetDataset([fp], ['ECG', 'THX'], num_classes=n)[0]
        _items_equal(got, jds.ParquetDataset([fp], ['ECG', 'THX'], num_classes=n)[0])
    np.testing.assert_array_equal(got[1], [0, -1, 4, -1, -1, 3])


def _bad_nights(tmp_path):
    rng = np.random.default_rng(4)
    sig = night(rng, np.zeros(EPOCHS))
    cases = {}
    inf = {**sig, 'ECG': sig['ECG'].copy()}
    inf['ECG'][5] = np.inf
    cases['has inf'] = (inf, np.zeros(EPOCHS))
    cases['disagree on recording length'] = ({**sig, 'THX': sig['THX'][:-256]}, np.zeros(EPOCHS))
    cases['No relevant columns'] = ({'ABD': night(rng, np.zeros(EPOCHS), ('ABD',))['ABD']}, np.zeros(EPOCHS))
    cases['!= recording_epochs'] = (sig, np.zeros(EPOCHS - 1))
    out = {}
    for i, (match, (signals, stage)) in enumerate(cases.items()):
        fp = str(tmp_path / f'bad{i}.parquet')
        write_port_night(fp, signals, stage)
        out[match] = fp
    return out


def test_the_same_value_errors(tmp_path):
    for match, fp in _bad_nights(tmp_path).items():
        for mod in (ds, jds):
            with pytest.raises(ValueError, match=match):
                mod.ParquetDataset([fp], ['ECG', 'THX'])[0]
    for mod in (ds, jds):
        with pytest.raises(ValueError, match='unrecognised'):
            mod.ParquetDataset([], ['ECG', 'EEG'])


def test_labels_optional_without_require_labels(tmp_path):
    rng = np.random.default_rng(5)
    fp = str(tmp_path / 'nolabels.parquet')
    parquet.write_night(fp, night(rng, np.zeros(EPOCHS)))
    got = ds.ParquetDataset([fp], ['ECG', 'THX'], require_labels=False)[0]
    _items_equal(got, jds.ParquetDataset([fp], ['ECG', 'THX'], require_labels=False)[0])
    assert (got[1] == -1).all()
    with pytest.raises(KeyError):
        ds.ParquetDataset([fp], ['ECG', 'THX'])[0]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_causal_normalize_matches_jax(dtype):
    """f32 through the native fused entry, f64 through the f64
    normalization (native and Python loop): the JAX package's bits."""
    rng = np.random.default_rng(6)
    sig = {'ECG': (rng.normal(size=30_000) * 2 + 1).astype(dtype), 'THX': rng.normal(size=4000).astype(dtype),
           'EEG': rng.normal(size=10).astype(dtype), 'ABD': np.full(10, -np.inf, dtype)}
    sig['ECG'][100] = 40.0  # an outlier the clip catches
    ours, theirs = ds.causal_normalize(sig), jds.causal_normalize(sig)
    for k in sig:
        assert ours[k].dtype == theirs[k].dtype == dtype
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    x = sig['THX'].astype(np.float64)
    for backend in ('cpp', 'numpy'):
        got, mask = ema_norm.causal_rolling_normalize(x, 34.1, return_outlier_mask=True, backend=backend)
        want, want_mask = jema.causal_rolling_normalize(x, 34.1, return_outlier_mask=True, backend=backend)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mask, want_mask)


# ---------------------------------------------------------------- batches


@pytest.mark.parametrize('threads', [1, 3])
def test_batch_iterator_same_batches(corpus, threads):
    fps = _nights(corpus)
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=7), dict(shuffle=True, seed=8, drop_last=True)):
        for pad in (None, 8, 4):
            args = dict(batch_size=3, num_threads=threads, pad_to_epochs=pad, **kw)
            ours = list(ds.batch_iterator(ds.ParquetDataset(fps, ['ECG', 'THX']), **args))
            theirs = list(jds.batch_iterator(jds.ParquetDataset(fps, ['ECG', 'THX']), **args))
            assert len(ours) == len(theirs) > 0
            for a, b in zip(ours, theirs):
                _items_equal(a, b)


def test_batch_iterator_raises_a_loader_error_and_can_be_abandoned(tmp_path, corpus):
    bad = _bad_nights(tmp_path)['has inf']
    fps = _nights(corpus)[:4] + [bad]
    with pytest.raises(ValueError, match='has inf'):
        list(ds.batch_iterator(ds.ParquetDataset(fps, ['ECG', 'THX']), batch_size=2, num_threads=2))
    it = ds.batch_iterator(ds.ParquetDataset(_nights(corpus), ['ECG', 'THX']), batch_size=1, num_threads=2,
                           prefetch=1)
    next(it)
    it.close()  # the producer gives up its blocked put


def test_pad_or_truncate_item_matches_jax():
    item = ({'ECG': np.ones(2048, np.float32), 'THX': np.full(512, -np.inf, np.float32),
             'ABD': np.zeros(0, np.float32)}, np.array([1, 2], np.float32))
    for target in (1, 2, 3):
        _items_equal(ds.pad_or_truncate_item(item, target), jds.pad_or_truncate_item(item, target))


# ---------------------------------------------------------------- data module


def _dms(corpus, **kw):
    args = dict(columns=['ECG', 'THX'], data_location=str(corpus), train_datasets=['mesa', 'shhs'],
                val_datasets=['mesa', 'shhs', 'census'], test_datasets=['mesa'], test=True, batch_size=3,
                val_batch_size=2, num_workers=1, pad_to_epochs=EPOCHS, max_length_hours=1, seed=3)
    args.update(kw)
    return dm.SleepDataModule(**args, device='cpu'), jdm.SleepDataModule(**args)


def test_datamodule_same_files_and_loaders(corpus):
    ours, theirs = _dms(corpus)
    assert ours._train_fps == theirs._train_fps and ours.num_train_nights == 8  # .issues left out
    assert ours._val_fps_combined == theirs._val_fps_combined  # census left out of 'all'
    assert not any('census' in fp for fp in ours._val_fps_combined)
    for loaders in (lambda m: m.val_loaders(), lambda m: m.test_loaders()):
        a, b = loaders(ours), loaders(theirs)
        assert [n for n, _ in a] == [n for n, _ in b]
        for (_, la), (_, lb) in zip(a, b):
            for x, y in zip(la, lb):
                _items_equal(x, y)
    assert [n for n, _ in ours.val_loaders()] == ['all', 'mesa', 'shhs', 'census']
    for epoch in (0, 1):  # shuffled by seed + epoch
        for x, y in zip(ours.train_loader(epoch), theirs.train_loader(epoch)):
            _items_equal(x, y)
    ppg_ours, ppg_theirs = _dms(corpus, columns=['PPG'])
    assert ppg_ours._train_fps == ppg_theirs._train_fps and len(ppg_ours._train_fps) == 1
    capped, _ = _dms(corpus, max_nights=1)
    assert capped.num_train_nights == 2


def test_datamodule_needs_a_card_unless_told_cpu(corpus):
    import torch

    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dm.SleepDataModule(columns=['ECG'], data_location=str(corpus))


@pytest.mark.parametrize('n_hosts', [1, 2, 3])
def test_shard_train_files_matches_jax(n_hosts):
    fps = [f'n{i}.parquet' for i in range(10)]
    for seed in (0, 5):
        for host in range(n_hosts):
            assert dm.shard_train_files(fps, seed, n_hosts, host) == jdm.shard_train_files(fps, seed, n_hosts, host)
    assert dm.shard_train_files(fps, 0, 1, 0) == [fps[i] for i in np.random.default_rng(0).permutation(10)]


@pytest.mark.parametrize('columns', [['ECG', 'THX'], ['PPG']])
def test_parquet_fps_for_dataset_match_jax(corpus, columns):
    """Per (dataset, split): ``.issues`` nights always skipped, the PPG-only
    schema filter, the night cap and a missing folder, as JAX's."""
    for ds in ('mesa', 'shhs', 'census', 'nope'):
        for split in ('train', 'val', 'test'):
            for cap in (None, 1):
                ours = dm.get_parquet_fps_for_dataset(str(corpus), ds, split, columns, max_nights=cap)
                assert ours == jdm.get_parquet_fps_for_dataset(str(corpus), ds, split, columns, max_nights=cap)
                assert not any(fp.endswith('.issues.parquet') for fp in ours)
    assert dm.get_parquet_fps_for_dataset(str(corpus), 'nope', 'train', columns) == []


# ---------------------------------------------------------------- encoders, stats


def test_native_encoders_bit_equal_numpy_and_jax():
    rng = np.random.default_rng(9)
    x = {'ECG': (rng.normal(size=(3, 5000)) * 3).astype(np.float32), 'THX': rng.normal(size=(3, 700)).astype(np.float32)}
    x['THX'][1] = -np.inf
    x['ECG'][2] = 0.0
    x['ECG'][0, :4] = [1e-30, -7.5, 7.5, 3.75]
    assert q8.native.get_lib() is not None
    numpy_q8 = {k: tuple(np.stack(a) for a in zip(*(q8.encode_row_numpy(r) for r in v))) for k, v in x.items()}
    for ours, refs in ((q8.encode_batch, (jq8.encode_batch(x), numpy_q8)), (q8.encode_batch_q16, (jq8.encode_batch_q16(x),))):
        got = ours(x)
        for ref in refs:
            for k in x:
                for a, b in zip(got[k], ref[k]):
                    np.testing.assert_array_equal(a, b)
    mixed = {'ECG': np.array([[1.0, np.nan]], np.float32)}
    for enc in (q8.encode_batch, q8.encode_batch_q16):
        with pytest.raises(ValueError, match='mixes finite'):
            enc(mixed)


def test_stats_match_jax():
    rng = np.random.default_rng(10)
    for cmat in (rng.integers(0, 50, size=(4, 4)), np.zeros((4, 4)), np.diag([3, 0, 0, 0]), np.eye(5) * 7):
        for fn in ('confusion_accuracy', 'cohens_kappa'):
            a, b = getattr(stats, fn)(cmat), getattr(jstats, fn)(cmat)
            assert (np.isnan(a) and np.isnan(b)) or a == b
