"""The port's annotation parsers against the JAX package's.

``wav2sleep_tpu_torch.data.{xml,txt,utils}`` on the fixtures of
``tests/data/test_annotations.py``, on every rejection case, and on a seeded
mutation fuzz of each format, against ``wav2sleep_tpu.data.{xml,txt,utils}``
on the same files. Tolerance everywhere is exact: the same seconds and
stages (NaN at the same places), ``None`` where JAX returns ``None``, and an
exception of the same class where JAX raises (pandas' ``ParserError`` and
``EmptyDataError`` against the port's classes of those names).
"""

import datetime
import os

import numpy as np
import pandas as pd
import pytest

from tests.data.test_annotations import ALLSCORE_ROWS, _stage_event, _write_night_edf, _xml_doc
from wav2sleep_tpu.data import txt as jax_txt
from wav2sleep_tpu.data import utils as jax_utils
from wav2sleep_tpu.data import xml as jax_xml
from wav2sleep_tpu_torch.data import txt, utils, xml

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse


def _jax_arrays(series):
    """A JAX parser's series as (seconds, stages) float64 arrays."""
    return (np.asarray(series.index, dtype=np.float64), series.to_numpy(dtype=np.float64, na_value=np.nan))


def _outcome(fn, fp, convert=lambda r: r):
    try:
        result = fn(fp)
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return 'raises', type(e).__name__
    return None if result is None else convert(result)


def assert_same(fp, jax_fn, port_fn):
    """Exactly the same outcome of the JAX and the port parser on ``fp``;
    returns it."""
    expected = _outcome(jax_fn, fp, _jax_arrays)
    got = _outcome(port_fn, fp)
    if expected is None or got is None or isinstance(expected[0], str) or isinstance(got[0], str):
        assert got == expected, (fp, open(fp, 'rb').read()[:400])
    else:
        np.testing.assert_array_equal(got[0], expected[0])
        np.testing.assert_array_equal(got[1], expected[1])
    return expected


# ---------------------------------------------------------------------------
# Stage codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('code', [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, '5', ' 2', '10', 'x', -1, 2.7])
def test_convert_int_stage_is_jaxs(code):
    """Exact: the same label, NaN or exception class for each code."""
    assert _outcome(utils.convert_int_stage, code, repr) == _outcome(jax_utils.convert_int_stage, code, repr)


@pytest.mark.parametrize('text', ['STAGE - W', 'STAGE - N1', 'STAGE - N2', 'STAGE - N3', 'STAGE - R', 'STAGE - MVT',
                                  'STAGE - NO STAGE', 'STAGE - X', 'START RECORDING', 'LIGHTS OFF', ''])
def test_convert_str_stage_is_jaxs(text):
    """Exact: the same label, None or exception class for each text."""
    assert _outcome(utils.convert_str_stage, text, repr) == _outcome(jax_utils.convert_str_stage, text, repr)


# ---------------------------------------------------------------------------
# NSRR XML
# ---------------------------------------------------------------------------

XML_EVENTS = (_stage_event('Wake|0', 0, 60) + _stage_event('Stage 2 sleep|2', 60, 90)
              + _stage_event('REM sleep|5', 150, 30) + _stage_event('Unscored|9', 180, 30))

XML_CASES = {
    'fixture': _xml_doc(XML_EVENTS),
    'no_start_time': _xml_doc(_stage_event('Wake|0', 0, 30), n_start_blocks=0),
    'several_start_times': _xml_doc(_stage_event('Wake|0', 0, 30), n_start_blocks=2),
    'first_stage_not_at_0': _xml_doc(_stage_event('Wake|0', 30, 30)),
    'duration_not_30s': _xml_doc(_stage_event('Wake|0', 0, 45)),
    'invalid_code': _xml_doc(_stage_event('Mystery|8', 0, 30)),
    'no_stages': _xml_doc(''),
    'n4_and_movement': _xml_doc(_stage_event('Stage 4 sleep|4', 0, 60) + _stage_event('Movement|6', 60, 30)),
}


@pytest.mark.parametrize('case', sorted(XML_CASES))
def test_xml_cases_match_jax(case, tmp_path):
    """Exact: seconds, stages (NaN where unscored) or the ValueError."""
    fp = str(tmp_path / 'rec-nsrr.xml')
    with open(fp, 'w') as f:
        f.write(XML_CASES[case])
    assert_same(fp, jax_xml.parse_xml_annotations, xml.parse_xml_annotations)


def test_xml_mutation_fuzz_matches_jax(tmp_path):
    """Exact over 200 character mutations of the fixture (printable bytes
    and newlines, 1-5 a variant, seed 7): the same arrays or the same
    exception class, case by case."""
    original = XML_CASES['fixture'].encode()
    rng = np.random.default_rng(7)
    printable = np.frombuffer(bytes(range(32, 127)) + b'\n', dtype=np.uint8)
    fp = str(tmp_path / 'fuzz-nsrr.xml')
    kinds = set()
    for _ in range(200):
        chars = np.frombuffer(original, dtype=np.uint8).copy()
        for _ in range(int(rng.integers(1, 6))):
            chars[int(rng.integers(0, len(chars)))] = printable[int(rng.integers(0, len(printable)))]
        with open(fp, 'wb') as f:
            f.write(chars.tobytes())
        kinds.add(str(assert_same(fp, jax_xml.parse_xml_annotations, xml.parse_xml_annotations))[:8])
    assert len(kinds) > 1


# ---------------------------------------------------------------------------
# The tab-separated reader
# ---------------------------------------------------------------------------

_VOCAB = ['1', '2', ' 3', '2.5', 'x', '', 'NA', 'nan', 'STAGE - W', '21:58:00.00', '-0', '1e0', 'inf', ' ',
          'User-Defined Stage', 'Epoch']


def _plain(v):
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return 'NaN'
    return v.item() if isinstance(v, np.generic) else v


def test_read_table_is_pandas_read_csv(tmp_path):
    """Exact over 400 seeded random tables (0-4 rows of 1-3 fields from a
    vocabulary of numbers, text, missing-value strings and blank lines, LF
    or CRLF) in the three ways the parsers read them: the same index, the
    same columns by name, the same values and int columns where pandas has
    int64, or the same exception class."""
    rng = np.random.default_rng(3)
    fp = str(tmp_path / 't.txt')
    modes = {
        'allscore': (lambda: pd.read_csv(fp, encoding='unicode_escape', delimiter='\t', index_col=0, header=None),
                     lambda: txt.read_table(fp, encoding='unicode_escape', header=False)),
        'stg': (lambda: pd.read_csv(fp, delimiter='\t', index_col=0), lambda: txt.read_table(fp)),
        'stg_names': (lambda: pd.read_csv(fp, delimiter='\t', index_col=0, names=['User-Defined Stage', 'X']),
                      lambda: txt.read_table(fp, names=['User-Defined Stage', 'X'])),
    }
    for _ in range(400):
        lines = []
        for _ in range(int(rng.integers(0, 5))):
            if rng.random() < 0.1:
                lines.append(str(rng.choice(['', '  ', '\t'])))
            else:
                lines.append('\t'.join(str(rng.choice(_VOCAB)) for _ in range(int(rng.integers(1, 4)))))
        text = str(rng.choice(['\n', '\r\n'])).join(lines) + ('\n' if rng.random() < 0.5 else '')
        with open(fp, 'w', newline='') as f:
            f.write(text)
        for mode, (jax_read, port_read) in modes.items():
            try:
                df = jax_read()
                expected = ([_plain(v) for v in df.index],
                            {k: ([_plain(v) for v in df[k]], df[k].dtype.kind == 'i') for k in df.columns})
            except Exception as e:  # noqa: BLE001
                expected = type(e).__name__
            try:
                index, cols = port_read()
                got = ([_plain(v) for v in index],
                       {k: ([_plain(v) for v in vs], bool(vs) and all(isinstance(v, int) for v in vs))
                        for k, vs in cols.items()})
                if not isinstance(expected, str):  # an empty column has no int-ness to compare
                    got[1].update({k: (v[0], expected[1][k][1]) for k, v in got[1].items()
                                   if not v[0] and k in expected[1]})
            except Exception as e:  # noqa: BLE001
                got = type(e).__name__
            assert got == expected, (mode, text)


# ---------------------------------------------------------------------------
# WSC .allscore.txt
# ---------------------------------------------------------------------------

# A longer night than the fixture's, so that mutations land on every path.
ALLSCORE_NIGHT = ALLSCORE_ROWS[:3] + [
    '23:40:10.50\tSTAGE - N2',
    '23:59:59.00\tLIGHTS OFF',
    '00:30:00.00\tSTAGE - N3',
    '01:00:00.00\tSTAGE - N2',
    '01:45:30.00\tSTAGE - R',
    '02:30:00.00\tSTAGE - MVT',
    '02:31:00.00\tSTAGE - W',
    '03:00:00.00\tSTAGE - NO STAGE',
    '03:10:00.00\tSTAGE - N1',
    '04:00:00.00\tSTAGE - R',
]


def _allscore_case(rows, edf_hours=5.0, edf_start=None):
    return rows, edf_hours, edf_start


ALLSCORE_CASES = {
    'fixture': _allscore_case(ALLSCORE_ROWS),
    'night': _allscore_case(ALLSCORE_NIGHT),
    'power_failure': _allscore_case(ALLSCORE_ROWS + ['03:00:00.00\tPOWER FAILURE RECOVERY']),
    'no_start': _allscore_case(ALLSCORE_ROWS[1:]),
    'two_starts': _allscore_case(ALLSCORE_ROWS + ['03:00:00.00\tSTART RECORDING']),
    'edf_start_mismatch': _allscore_case(ALLSCORE_ROWS, edf_start=datetime.datetime(2000, 1, 1, 20, 0, 0)),
    'wake_n2_only': _allscore_case(['21:58:00.00\tSTART RECORDING', '22:00:00.00\tSTAGE - W',
                                    '23:00:00.00\tSTAGE - N2', '02:30:00.00\tSTAGE - W']),
    'too_short': _allscore_case(['21:58:00.00\tSTART RECORDING', '22:00:00.00\tSTAGE - N3',
                                 '22:30:00.00\tSTAGE - R']),
    'too_long': _allscore_case(ALLSCORE_ROWS + ['12:30:00.00\tSTAGE - W']),
    'pre_start_strays': _allscore_case(['17:00:00.00\tSTAGE - W'] + ALLSCORE_ROWS),
    'unconvertible_stamp': _allscore_case(ALLSCORE_ROWS + ['03:61:00.00\tSTAGE - W']),
    'later_day_without_wrap': _allscore_case(['21:58:00.00\tSTART RECORDING', '20:00:00.00\tSTAGE - N1',
                                              '23:00:00.00\tSTAGE - R', '23:59:00.00\tSTAGE - N3']),
    'unseen_stage': _allscore_case(ALLSCORE_ROWS + ['03:00:00.00\tSTAGE - Q']),
    'duplicate_times': _allscore_case(ALLSCORE_ROWS[:2] + ['22:00:00.00\tSTAGE - N3'] + ALLSCORE_ROWS[2:]),
    'events_between_grid_points': _allscore_case(['21:58:00.00\tSTART RECORDING', '21:58:10.00\tSTAGE - W',
                                                  '21:58:20.00\tSTAGE - N1', '21:58:50.00\tSTAGE - N3',
                                                  '02:30:00.00\tSTAGE - R']),
    'start_without_fraction': _allscore_case(['21:58:00\tSTART RECORDING'] + ALLSCORE_ROWS[1:]),
    'only_a_start': _allscore_case(['21:58:00.00\tSTART RECORDING']),
    'three_columns': _allscore_case(['21:58:00.00\tSTART RECORDING\tx'] + ALLSCORE_ROWS[1:]),
    'numbers_only': _allscore_case(['1\t2', '3\t4']),
    'empty': _allscore_case([]),
}


def _write_allscore(folder, rows, edf_hours=5.0, edf_start=None, newline='\n'):
    fp = os.path.join(folder, 'subj1.allscore.txt')
    edf_fp = os.path.join(folder, 'subj1.edf')
    if edf_hours is not None:
        _write_night_edf(edf_fp, hours=edf_hours, start=edf_start or datetime.datetime(2000, 1, 1, 21, 58, 0))
    with open(fp, 'w', newline='') as f:
        f.write(newline.join(rows) + (newline if rows else ''))
    return fp


@pytest.mark.parametrize('case', sorted(ALLSCORE_CASES))
def test_allscore_cases_match_jax(case, tmp_path):
    """Exact: seconds and stages, None or the exception class."""
    rows, hours, start = ALLSCORE_CASES[case]
    fp = _write_allscore(str(tmp_path), rows, hours, start)
    assert_same(fp, jax_txt.parse_all_score, txt.parse_all_score)
    assert_same(fp, jax_txt.parse_txt_annotations, txt.parse_txt_annotations)


_ALLSCORE_TEXTS = ['STAGE - W', 'STAGE - N1', 'STAGE - N2', 'STAGE - N3', 'STAGE - R', 'STAGE - NO STAGE',
                   'STAGE - MVT', 'STAGE - X', 'LIGHTS OFF', 'START RECORDING', 'POWER FAILURE RECOVERY', '', 'NA']
_HOURS = [17, 19, 20, 21, 22, 23, 0, 1, 2, 3, 5, 8, 10, 13]


def _random_stamp(rng) -> str:
    h, m, s = int(rng.choice(_HOURS)), int(rng.integers(0, 60)), int(rng.integers(0, 60))
    frac = rng.choice(['.00', '', '.5', '.125', '.000000001'])
    return f'{h:02d}:{m:02d}:{s:02d}{frac}'


def _mutate_rows(rng, rows: list[str], texts, stamp) -> list[str]:
    rows = list(rows)
    for _ in range(int(rng.integers(1, 4))):
        op = int(rng.integers(0, 8))
        i = int(rng.integers(0, len(rows))) if rows else 0
        if not rows:
            rows.append(f'{stamp(rng)}\t{rng.choice(texts)}')
        elif op == 0:  # another annotation
            rows[i] = rows[i].split('\t')[0] + '\t' + str(rng.choice(texts))
        elif op == 1:  # another time
            rows[i] = stamp(rng) + '\t' + '\t'.join(rows[i].split('\t')[1:])
        elif op == 2:  # a row lost
            del rows[i]
        elif op == 3:  # a row twice
            rows.insert(i, rows[i])
        elif op == 4:  # two rows swapped
            j = int(rng.integers(0, len(rows)))
            rows[i], rows[j] = rows[j], rows[i]
        elif op == 5:  # a new row
            rows.insert(i, f'{stamp(rng)}\t{rng.choice(texts)}')
        elif op == 6:  # an extra field
            rows[i] += '\t' + str(rng.choice(['0', 'x', '']))
        else:  # a blank line
            rows.insert(i, str(rng.choice(['', '  '])))
    return rows


def test_allscore_mutation_fuzz_matches_jax(tmp_path):
    """Exact over 150 row mutations of the night (seed 11; 1-3 a variant:
    annotations, times, lost, doubled, swapped and new rows, extra fields,
    blank lines; LF or CRLF): the same arrays, None or exception class,
    case by case. The outcomes must cover arrays, None and raises."""
    rng = np.random.default_rng(11)
    seen = set()
    _write_allscore(str(tmp_path), [])
    for _ in range(150):
        rows = _mutate_rows(rng, ALLSCORE_NIGHT, _ALLSCORE_TEXTS, _random_stamp)
        fp = _write_allscore(str(tmp_path), rows, edf_hours=None, newline=str(rng.choice(['\n', '\r\n'])))
        out = assert_same(fp, jax_txt.parse_all_score, txt.parse_all_score)
        seen.add('none' if out is None else out[0] if isinstance(out[0], str) else 'arrays')
    assert seen == {'none', 'raises', 'arrays'}


# ---------------------------------------------------------------------------
# WSC .stg.txt and .log.txt
# ---------------------------------------------------------------------------

STG_HEADER = 'Epoch\tUser-Defined Stage'
STG_ROWS = [f'{i}\t{v}' for i, v in enumerate([0, 1, 2, 3, 4, 5, 0] * 100, start=1)]
LOG = '21:58:00 1\tRecording Started\n10:00:00 2\tLights Out\n'

STG_CASES = {
    'fixture': ([STG_HEADER] + STG_ROWS, LOG, 5.0, None),
    'headerless_three_columns': ([f'{r}\t0' for r in STG_ROWS[:720]], LOG, 5.0, None),
    'headerless_two_columns': (STG_ROWS, LOG, 5.0, None),
    'implicit_index': ([STG_HEADER] + [f'{r}\t7' for r in STG_ROWS], LOG, 5.0, None),
    'missing_log': ([STG_HEADER] + STG_ROWS, None, 5.0, None),
    'log_without_start': ([STG_HEADER] + STG_ROWS, '10:00:00 1\tLights Out\n', 5.0, None),
    'log_several_starts': ([STG_HEADER] + STG_ROWS, '20:00:00 1\tRecording Started\nbad line\n'
                           '21:58:00 5\tRecording Started\n', 5.0, None),
    'start_mismatch': ([STG_HEADER] + STG_ROWS, LOG, 5.0, datetime.datetime(2000, 1, 1, 20, 0, 0)),
    'edf_too_short': ([STG_HEADER] + STG_ROWS, LOG, 1.0, None),
    'edf_too_long': ([STG_HEADER] + STG_ROWS, LOG, 15.0, None),
    'wake_n2_only': ([STG_HEADER] + [f'{i}\t{v}' for i, v in enumerate([0, 2] * 300, start=1)], LOG, 5.0, None),
    'invalid_code': ([STG_HEADER] + STG_ROWS[:5] + ['6\t8'], LOG, 5.0, None),
    'missing_stage': ([STG_HEADER] + STG_ROWS[:5] + ['6\t'], LOG, 5.0, None),
    'float_stage': ([STG_HEADER] + STG_ROWS[:5] + ['6\t2.5'], LOG, 5.0, None),
    'text_epoch': ([STG_HEADER] + STG_ROWS[:5] + ['x\t2'], LOG, 5.0, None),
    'duplicate_epochs': ([STG_HEADER] + STG_ROWS + STG_ROWS[:3], LOG, 5.0, None),
    'header_only': ([STG_HEADER], LOG, 5.0, None),
    'empty': ([], LOG, 5.0, None),
    'row_too_long': ([STG_HEADER] + STG_ROWS[:5] + ['6\t2\t1'], LOG, 5.0, None),
}


def _write_stg(folder, rows, log, edf_hours=5.0, edf_start=None, newline='\n'):
    fp = os.path.join(folder, 'subj2.stg.txt')
    if not os.path.exists(os.path.join(folder, 'subj2.edf')):
        _write_night_edf(os.path.join(folder, 'subj2.edf'), hours=edf_hours,
                         start=edf_start or datetime.datetime(2000, 1, 1, 21, 58, 0))
    with open(fp, 'w', newline='') as f:
        f.write(newline.join(rows) + (newline if rows else ''))
    if log is not None:
        with open(os.path.join(folder, 'subj2.log.txt'), 'w') as f:
            f.write(log)
    return fp


@pytest.mark.parametrize('case', sorted(STG_CASES))
def test_stg_cases_match_jax(case, tmp_path):
    """Exact: seconds and stages, None or the exception class."""
    fp = _write_stg(str(tmp_path), *STG_CASES[case])
    assert_same(fp, jax_txt.parse_stg_file, txt.parse_stg_file)
    assert_same(fp, jax_txt.parse_txt_annotations, txt.parse_txt_annotations)


_STG_VALUES = ['0', '1', '2', '3', '4', '5', '6', '7', '8', '9', 'x', '', '2.5', 'NA', ' 3']
_STG_LOGS = [LOG, '21:58:00 1\tRecording Started\n', '22:00:00 1\tRecording Started\n', '10:00:00 2\tLights Out\n',
             '21:58:00 1\tRecording Started\n00:10:00 9\tRecording Started\n', '21:58 1\tRecording Started\n']


def _stg_stamp(rng) -> str:
    return str(int(rng.integers(1, 900)))


def test_stg_mutation_fuzz_matches_jax(tmp_path):
    """Exact over 150 mutations (seed 13; 1-3 row mutations a variant as
    for allscore, over stage codes and epoch numbers; the header dropped
    one time in 8; the log one of six, 1, 5 or 15 h of EDF): the same
    arrays, None or exception class, case by case."""
    rng = np.random.default_rng(13)
    seen = set()
    base = STG_ROWS[:720]
    for _ in range(150):
        rows = _mutate_rows(rng, base, _STG_VALUES, _stg_stamp)
        if rng.random() >= 0.125:
            rows = [STG_HEADER] + rows
        hours = float(rng.choice([5.0, 5.0, 5.0, 1.0, 15.0]))
        folder = tmp_path / f'{hours:g}h'  # one EDF of each length
        folder.mkdir(exist_ok=True)
        fp = _write_stg(str(folder), rows, str(rng.choice(_STG_LOGS)), hours,
                        newline=str(rng.choice(['\n', '\r\n'])))
        out = assert_same(fp, jax_txt.parse_stg_file, txt.parse_stg_file)
        seen.add('none' if out is None else out[0] if isinstance(out[0], str) else 'arrays')
    assert seen == {'none', 'raises', 'arrays'}


@pytest.mark.parametrize('log', _STG_LOGS + ['', 'no tabs here\n'])
def test_start_from_log_is_jaxs(log, tmp_path):
    """Exact: the same (time, epoch) pair, (None, None) or exception."""
    fp = str(tmp_path / 'x.log.txt')
    with open(fp, 'w') as f:
        f.write(log)
    assert _outcome(txt.get_start_from_log, fp) == _outcome(jax_txt.get_start_from_log, fp)


def test_unsupported_extension_raises_as_jax(tmp_path):
    """Exact: ValueError for a .txt of neither format."""
    fp = str(tmp_path / 'subj.something.txt')
    with open(fp, 'w') as f:
        f.write('x')
    assert _outcome(txt.parse_txt_annotations, fp) == _outcome(jax_txt.parse_txt_annotations, fp)


def test_get_edf_end_is_jaxs(tmp_path):
    """Exact: the same end datetime from the header."""
    from wav2sleep_tpu.data.edf import get_edf_end as jax_end
    from wav2sleep_tpu_torch.data import get_edf_end

    fp = str(tmp_path / 'n.edf')
    _write_night_edf(fp, hours=4.25)
    assert get_edf_end(fp) == jax_end(fp) == datetime.datetime(2000, 1, 1, 21, 58) + datetime.timedelta(hours=4.25)
