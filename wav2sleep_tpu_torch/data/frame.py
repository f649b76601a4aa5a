"""Columns over one index, without pandas, and the conversions pandas makes on
the inference API's path.

The JAX package's API holds a night as a pandas DataFrame: float columns over
a seconds index or a datetime index. The port holds it as a ``Frame``:
numpy columns over a float64 seconds index, or over an int64 index of
nanoseconds since the epoch (``datetime=True``, naive, as pandas'
``datetime64[ns]``). The functions here do what pandas does where the
answer depends on it, bit for bit:

- ``seconds_to_ns``: ``pd.to_timedelta(seconds, unit='s')``, whose float to
  nanosecond rounding moves sample times that are not whole nanoseconds;
- ``format_stamps``: how ``DataFrame.to_csv`` writes a datetime index (the
  fractional digits follow the finest value);
- ``read_csv``: ``pd.read_csv(fp, index_col=0, parse_dates=True)`` for what
  ``to_csv`` writes: a numeric index (seconds) or ISO 8601 stamps without a
  time zone. Any other index raises ``ValueError``.
"""

from __future__ import annotations

import csv
import datetime
import itertools
import re
from dataclasses import dataclass, field

import numpy as np

NS_PER_S = 1_000_000_000
CSV_CHUNK_ROWS = 1 << 20  # rows of a CSV converted at a time by read_csv
_EPOCH = datetime.datetime(1970, 1, 1)
# pandas' default missing-value strings of read_csv.
NA_STRINGS = frozenset({'', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan', '1.#IND', '1.#QNAN',
                        '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a', 'nan', 'null'})
# ISO 8601 stamps as to_csv writes them: a date, or a date and a time to the
# minute, second or up to nine fractional digits; ' ' or 'T' between.
_STAMP = re.compile(r'\d{4}-\d{2}-\d{2}(?:[ T]\d{2}:\d{2}(?::\d{2}(?:\.\d{1,9})?)?)?')


@dataclass
class Frame:
    """Named columns over one index: float64 seconds, or int64 nanoseconds
    since the epoch when ``datetime``."""

    index: np.ndarray
    columns: dict[str, np.ndarray] = field(default_factory=dict)
    datetime: bool = False

    def seconds(self) -> np.ndarray:
        """The index in seconds from its first value (datetime) or as it is
        (seconds), float64, as the JAX package's preprocessing reads it."""
        if self.datetime:
            return (self.index - self.index[0]).astype(np.float64) / 1e9
        return np.asarray(self.index, dtype=np.float64)


def seconds_to_ns(seconds: np.ndarray) -> np.ndarray:
    """``pd.to_timedelta(seconds, unit='s')`` as int64 nanoseconds: the
    whole seconds and the fraction apart, the fraction rounded to 9 decimals
    and then truncated to whole nanoseconds (pandas'
    ``cast_from_unit_vectorized``). For times that are no whole number of
    nanoseconds this differs from ``round(seconds * 1e9)``."""
    s = np.asarray(seconds, dtype=np.float64)
    base = s.astype(np.int64)
    frac = np.round(s - base, 9)
    return base * NS_PER_S + (frac * 1e9).astype(np.int64)


def datetime_to_ns(t: datetime.datetime) -> int:
    """A naive ``datetime`` as nanoseconds since the epoch."""
    return (t - _EPOCH) // datetime.timedelta(microseconds=1) * 1000


def format_stamps(ns: np.ndarray) -> list[str]:
    """Nanosecond stamps as ``to_csv`` writes a ``datetime64[ns]`` index:
    dates alone when every stamp is at midnight, else date and time with 9,
    6, 3 or no fractional digits, the fewest that show every stamp."""
    ns = np.asarray(ns, dtype=np.int64)
    if ns.size == 0:
        return []
    if not (ns % (86_400 * NS_PER_S)).any():
        return [str(d) for d in ns.astype('datetime64[ns]').astype('datetime64[D]')]
    whole = np.datetime_as_string(ns.astype('datetime64[ns]'), unit='s')
    sub = ns % NS_PER_S
    if (sub % 1000).any():
        frac = [f'.{v:09d}' for v in sub.tolist()]
    elif (sub % 1_000_000).any():
        frac = [f'.{v // 1000:06d}' for v in sub.tolist()]
    elif sub.any():
        frac = [f'.{v // 1_000_000:03d}' for v in sub.tolist()]
    else:
        frac = [''] * len(sub)
    return [w.replace('T', ' ') + f for w, f in zip(whole, frac)]


def _floats(values, what: str) -> np.ndarray:
    try:
        return np.array([np.nan if v in NA_STRINGS else v for v in values], dtype=np.float64)
    except ValueError as e:
        raise ValueError(f'{what}: not numeric ({e})') from None


def _stamps(values, what: str) -> np.ndarray:
    if not all(map(_STAMP.fullmatch, values)):
        raise ValueError(f'{what}: the index is neither numbers nor ISO 8601 stamps without a time zone')
    return np.array(values, dtype='datetime64[ns]').view(np.int64)


def read_csv(fp: str, columns: list[str] | None = None) -> Frame:
    """A CSV file as ``pd.read_csv(fp, index_col=0, parse_dates=True)``
    reads what ``to_csv`` writes: the first column is the index (seconds
    when every entry is a number, else ISO 8601 stamps), the header names
    the rest; pandas' missing-value strings read as NaN. Only ``columns``
    (every column when None) are converted, and must be numeric; anything
    else raises ``ValueError``. Rows are converted ``CSV_CHUNK_ROWS`` at a time,
    so a night's strings never all sit in memory at once."""
    with open(fp, newline='', encoding='utf-8') as f:
        reader = (r for r in csv.reader(f) if r)
        header = next(reader, None)
        if header is None:
            raise ValueError(f'{fp}: no header')
        keep: dict[int, str] = {}  # position -> name; a repeated name keeps its first column
        for i, name in enumerate(header[1:], 1):
            if (columns is None or name in columns) and name not in keep.values():
                keep[i] = name
        datetime_index = None
        index_parts: list[np.ndarray] = []
        parts: dict[int, list[np.ndarray]] = {i: [] for i in keep}
        while chunk := list(itertools.islice(reader, CSV_CHUNK_ROWS)):
            if any(len(r) != len(header) for r in chunk):
                raise ValueError(f'{fp}: rows of unequal length')
            cols = list(zip(*chunk))
            if datetime_index is None:
                try:
                    index_parts.append(_floats(cols[0], fp))
                    datetime_index = False
                except ValueError:
                    datetime_index = True
                    index_parts.append(_stamps(cols[0], fp))
            else:
                index_parts.append(_stamps(cols[0], fp) if datetime_index else _floats(cols[0], fp))
            for i in keep:
                parts[i].append(_floats(cols[i], f'{fp}: column {keep[i]}'))
    empty = np.zeros(0, np.int64 if datetime_index else np.float64)
    frame = Frame(np.concatenate(index_parts) if index_parts else empty, datetime=bool(datetime_index))
    for i, name in keep.items():
        frame.columns[name] = np.concatenate(parts[i]) if parts[i] else np.zeros(0)
    return frame
