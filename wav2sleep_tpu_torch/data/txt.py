"""Wisconsin Sleep Cohort (WSC) sleep-stage annotations.

The port's copy of ``wav2sleep_tpu/data/txt.py``, without pandas. Two
formats:

- ``.stg.txt``: integer stages by epoch number; the recording start is
  checked against the paired ``.log.txt`` ("Recording Started", the one
  closest to midnight when there are several) and the EDF header.
- ``.allscore.txt``: stage changes at hh:mm:ss times; times before the
  start hour belong to the next day, a power failure rejects the night, and
  each point of a 30 s grid from the first event takes the last stage at or
  before it.

Both reject recordings shorter than 4 h or longer than 14 h (``None``) and
nights scored with only Wake/N2 (``ValueError``). They return
``(seconds, stages)`` float64 arrays, each label at the end of the 30 s it
describes, NaN where unscored.

``read_table`` reads the tab-separated files as the JAX package's
``pd.read_csv(..., delimiter='\\t', index_col=0)`` frames them: blank lines
skipped, a header row or ``names``, an implicit index when the first data
row has one field more than the names, short rows padded with NaN, a row
longer than the first a ``ParserError``, pandas' missing-value strings, and
each column int, float or text as pandas infers it. Quoted fields are not
read (``ValueError``).
"""

from __future__ import annotations

import datetime
import logging
import os
import re

import numpy as np

from .edf import get_edf_end, get_edf_start
from .frame import NA_STRINGS
from .utils import convert_int_stage, convert_str_stage

logger = logging.getLogger(__name__)

MIN_RECORDING_LENGTH = 60 * 60 * 4  # 4 hours
MAX_RECORDING_LENGTH = 60 * 60 * 14  # 14 hours

_STG_COL = 'User-Defined Stage'
_GRID_NS = 30 * 1_000_000_000

_LINE_BREAK = re.compile(r'\r\n|\r|\n')
_INT = re.compile(r' *[+-]?\d+ *')
_FLOAT = re.compile(r' *[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|inf|infinity) *', re.IGNORECASE)
# hh:mm:ss with optional fractional seconds, the time of an allscore row.
_CLOCK = re.compile(r'(\d{1,2}):(\d{2}):(\d{2})(?:\.(\d+))?')


class ParserError(ValueError):
    """A row with more fields than the table (pandas' ``ParserError``)."""


class EmptyDataError(ValueError):
    """A file with no rows (pandas' ``EmptyDataError``)."""


def _column(raw: list[str | None]) -> list:
    """Fields of one column as pandas types them: all ints -> int, numbers
    with or without missing values -> float (NaN), else text (NaN where
    missing)."""
    missing = [v is None or v in NA_STRINGS for v in raw]
    present = [v for v, m in zip(raw, missing) if not m]
    if present and not any(missing) and all(_INT.fullmatch(v) for v in present):
        return [int(v) for v in raw]
    if all(_INT.fullmatch(v) or _FLOAT.fullmatch(v) for v in present):
        return [np.nan if m else float(v) for v, m in zip(raw, missing)]
    return [np.nan if m else v for v, m in zip(raw, missing)]


def _mangle(names: list[str]) -> list[str]:
    """Header names as pandas makes them unique ('X', 'X.1', ...), empty
    ones as 'Unnamed: i'."""
    out, seen = [], {}
    for i, name in enumerate(names):
        name = name or f'Unnamed: {i}'
        if name in seen:
            seen[name] += 1
            name = f'{name}.{seen[name]}'
        seen.setdefault(name, 0)
        out.append(name)
    return out


def read_table(fp: str, encoding: str = 'utf-8', header: bool = True, names: list[str] | None = None):
    """``(index, {name: values})`` of a tab-separated file as
    ``pd.read_csv(fp, encoding=..., delimiter='\\t', index_col=0,
    header=0 | None, names=...)`` frames it, the values as Python ints,
    floats and strings in pandas' column types (``_column``)."""
    with open(fp, 'rb') as f:
        text = f.read().decode(encoding)
    if '"' in text:
        raise ValueError(f'{fp}: quoted fields are not read')
    rows = [line.split('\t') for line in _LINE_BREAK.split(text) if line.strip(' ')]
    if names is not None:
        cols = list(names)
    elif not rows:
        raise EmptyDataError('No columns to parse from file')
    elif header:
        cols = _mangle(rows.pop(0))
    else:
        cols = list(range(len(rows[0])))
    implicit = (header or names is not None) and bool(rows) and len(rows[0]) == len(cols) + 1
    if names is not None and rows and len(rows[0]) > len(cols) + 1:
        raise ParserError('Could not construct index: more fields than names and an index')
    width = len(cols) + implicit
    for i, row in enumerate(rows):
        if len(row) > width:
            raise ParserError(f'Expected {width} fields in line {i + 1}, saw {len(row)}')
    fields = [_column([row[j] if j < len(row) else None for row in rows]) for j in range(width)]
    data_names = cols if implicit else cols[1:]
    return fields[0], dict(zip(data_names, fields[1:]))


def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v


def _swap_suffix(fp: str, old: str, new: str) -> str:
    """The sibling file of ``fp`` with suffix ``old`` replaced by ``new``
    (only at the end: directory names keep theirs)."""
    if not fp.endswith(old):
        raise ValueError(f'{fp=} does not end with {old!r}')
    return fp[: -len(old)] + new


def _clock_ns(day: datetime.date, stamp: str) -> int:
    """``day`` at the hh:mm:ss[.f] ``stamp`` as nanoseconds since the epoch;
    raises ``ValueError`` for any other stamp."""
    m = _CLOCK.fullmatch(stamp)
    if m is None:
        raise ValueError(f'{stamp!r} is not hh:mm:ss[.f]')
    h, mi, s = int(m.group(1)), int(m.group(2)), int(m.group(3))
    t = datetime.datetime(day.year, day.month, day.day, h, mi, s)  # raises past 23:59:59
    frac = int((m.group(4) or '0')[:9].ljust(9, '0'))
    return (t - datetime.datetime(1970, 1, 1)) // datetime.timedelta(microseconds=1) * 1000 + frac


def convert_index(stamps: list[str], start_ts: datetime.datetime) -> np.ndarray:
    """hh:mm:ss[.f] stamps as int64 nanoseconds on the day of ``start_ts``
    or, for an hour before its hour, the next day. Assumes a night starts
    between about 5 pm and 3 am and lasts under 24 h; raises ``ValueError``
    when the last stamp's hour is after the start hour and some stamp's is
    before it."""
    hours = [int(s[:2]) for s in stamps]
    multiday = start_ts.hour >= hours[-1]
    same_day = [start_ts.hour <= h for h in hours]
    if not multiday and not all(same_day):
        raise ValueError(f'{multiday=}, but {start_ts=} and found timestamps on a possibly different day.')
    day = start_ts.date()
    next_day = day + datetime.timedelta(days=1)
    return np.array([_clock_ns(day if same else next_day, s) for s, same in zip(stamps, same_day)], np.int64)


def _has_deep_sleep_stages(stages) -> bool:
    """True if any of N1/N3/REM is present; sleep/wake-only scoring is not."""
    return any(s in (1, 3, 4) for s in stages if s is not None and not _is_nan(s))


def _forward_fill_30s(offsets: np.ndarray, values: list) -> tuple[np.ndarray, list]:
    """``resample('30s').ffill()`` of events at ``offsets`` (ns, unique):
    a grid from the first to the last event in 30 s steps, each point with
    the value of the last event at or before it."""
    order = np.argsort(offsets, kind='stable')
    t = offsets[order]
    grid = t[0] + _GRID_NS * np.arange((t[-1] - t[0]) // _GRID_NS + 1, dtype=np.int64)
    take = order[np.searchsorted(t, grid, side='right') - 1]
    return grid, [values[i] for i in take]


def parse_all_score(fp: str) -> tuple[np.ndarray, np.ndarray] | None:
    """``(seconds, stages)`` of a WSC ``.allscore.txt`` (stage changes), or
    None for a power failure, no or several START RECORDING rows, stamps
    that do not convert, or a length outside 4-14 h."""
    index, cols = read_table(fp, encoding='unicode_escape', header=False)
    if len(cols) != 1:
        raise TypeError(f'{fp}: {len(cols)} annotation columns, expected 1')
    (values,) = cols.values()
    if not any(isinstance(v, str) for v in values):
        raise AttributeError('Can only use .str accessor with string values')
    rows = [(t, v) for t, v in zip(index, values) if not _is_nan(v)]
    if any('POWER FAILURE RECOVERY' in v for _, v in rows):
        logger.info(f'Recording contains power failure for {fp=}')
        return None
    rows = [(t, v) for t, v in rows if 'STAGE' in v or 'START' in v]
    starts = [i for i, (_, v) in enumerate(rows) if v == 'START RECORDING']
    if not starts:
        logger.info(f"Didn't find START RECORDING annotation for {fp=}.")
        return None
    # Annotations before START RECORDING are strays of an earlier session.
    rows = rows[starts[0]:]
    if len(starts) != 1:
        logger.info(f'Found multiple START RECORDING annotations for {fp=}.')
        return None
    start_stamp = rows[0][0]
    hour, minute, second = int(start_stamp[:2]), int(start_stamp[3:5]), int(start_stamp[6:8])
    edf_start = get_edf_start(_swap_suffix(fp, 'allscore.txt', 'edf'))
    if (edf_start.hour, edf_start.minute, edf_start.second) != (hour, minute, second):
        logger.warning(f'{edf_start=} did not match allscore file start: {start_stamp} for {fp=}. Skipping...')
        raise ValueError(f'EDF/annotation start mismatch for {fp}')
    start_ts = datetime.datetime.strptime(f'01/01/2000 {start_stamp}', '%d/%m/%Y %H:%M:%S.%f')
    try:
        times = convert_index([t for t, _ in rows], start_ts=start_ts)
    except Exception:  # noqa: BLE001 - as the JAX package: any stamp fault rejects the night
        logger.warning(f'Failed to convert timestamps for {fp=}')
        return None
    _, first = np.unique(times, return_index=True)  # the first of each duplicate
    first.sort()
    times = times[first]
    grid, texts = _forward_fill_30s(times - times[0], [rows[i][1] for i in first])
    seconds = grid / 1e9 + 30.0  # labels describe the preceding 30 s
    stages = [convert_str_stage(v) for v in texts]
    if seconds[-1] < MIN_RECORDING_LENGTH:
        logger.warning(f'Recording less than {MIN_RECORDING_LENGTH=} for {fp=}')
        return None
    if seconds[-1] > MAX_RECORDING_LENGTH:
        logger.warning(f'Recording greater than {MAX_RECORDING_LENGTH=} for {fp=}')
        return None
    if not _has_deep_sleep_stages(stages):
        raise ValueError(f'Only Wake/N2 scoring found in {fp} - rejecting sleep/wake-only recording.')
    return seconds, np.array([np.nan if s is None else s for s in stages], dtype=np.float64)


def midnight_dist(start_entry) -> float:
    """Distance (hours, mod 24) of an hh:mm[:ss] timestamp past midnight."""
    hh_mm = start_entry[0]
    return (float(hh_mm[:2]) + float(hh_mm[3:5]) / 60 - 24) % 24


def get_start_from_log(fp: str):
    """Recording start (time string, epoch number) from a WSC ``.log.txt``,
    ``(None, None)`` without one. Of several 'Recording Started' lines (a
    restarted recording) the one closest to midnight wins."""
    with open(fp, 'r') as f:
        lines = f.readlines()
    starts = []
    for line in lines:
        contents = line.strip().split('\t')
        if len(contents) < 2:
            continue
        time_epoch, annotation = contents[0], contents[1]
        if annotation == 'Recording Started':
            time, _, epoch_no = time_epoch.partition(' ')
            starts.append((time.strip(), epoch_no.strip()))
    if not starts:
        logger.warning(f"Couldn't find 'Recording Start' annotation in {fp=}")
        return None, None
    if len(starts) > 1:
        logger.warning(f'Found multiple starts in {fp=}. Using closest to midnight...')
        starts = sorted(starts, key=midnight_dist)
    return starts[-1]


def parse_stg_file(fp: str) -> tuple[np.ndarray, np.ndarray] | None:
    """``(seconds, stages)`` of a WSC ``.stg.txt`` (stages by epoch), or None
    when the log has no start, the log and EDF starts differ or the EDF
    lasts outside 4-14 h. Raises ``FileNotFoundError`` without a log."""
    index, cols = read_table(fp)
    if _STG_COL in cols:
        values = cols[_STG_COL]
    else:  # some files have no header row
        index, cols = read_table(fp, names=[_STG_COL, 'X'])
        values = cols[_STG_COL]
    log_fp = _swap_suffix(fp, 'stg.txt', 'log.txt')
    if not os.path.exists(log_fp):
        raise FileNotFoundError(f"Couldn't find corresponding log file for {fp=}")
    start_time, _epoch = get_start_from_log(log_fp)
    if start_time is None:
        return None
    hour, minute, second = map(int, start_time.split(':'))
    edf_fp = _swap_suffix(fp, 'stg.txt', 'edf')
    edf_start, edf_end = get_edf_start(edf_fp), get_edf_end(edf_fp)
    if (edf_start.hour, edf_start.minute, edf_start.second) != (hour, minute, second):
        logger.warning(f'{edf_start=} did not match log file start: {start_time} for {fp=}. Skipping...')
        return None
    edf_duration = (edf_end - edf_start).total_seconds()
    if edf_duration < MIN_RECORDING_LENGTH:
        logger.warning(f'EDF less than {MIN_RECORDING_LENGTH=} for {fp=}')
        return None
    if edf_duration > MAX_RECORDING_LENGTH:
        logger.warning(f'EDF greater than {MAX_RECORDING_LENGTH=} for {fp=}')
        return None
    # Epoch i ends at 30 i s, so the labels already sit at the end of their 30 s.
    seconds = np.array([e * 30.0 for e in index], dtype=np.float64)
    stages = [convert_int_stage(v) for v in values]
    if not _has_deep_sleep_stages(stages):
        raise ValueError(f'Only Wake/N2 scoring found in {fp} - rejecting sleep/wake-only recording.')
    return seconds, np.array(stages, dtype=np.float64)


def parse_txt_annotations(fp: str) -> tuple[np.ndarray, np.ndarray] | None:
    """``(seconds, stages)`` of a WSC annotation file of either format."""
    if fp.endswith('.stg.txt'):
        return parse_stg_file(fp)
    if fp.endswith('.allscore.txt'):
        return parse_all_score(fp)
    raise ValueError(f'File extension {fp=} unsupported. Expected .stg.txt or .allscore.txt')
