"""Per-night parquet files: list, probe, read and write them.

The one module of the port that uses ``pyarrow``, and only inside its
functions, so the rest of the port imports without it. It is the port's
counterpart of the parquet half of ``wav2sleep_tpu/data/utils.py``
(``get_parquet_cols``, ``get_parquet_fps``), of the read in
``wav2sleep_tpu/data/dataset.py::try_read_parquet`` and of the write in
``wav2sleep_tpu/ingest.py``. Columns come back as numpy arrays with nulls as
NaN, which is what the JAX package's pandas frames hold; no pandas is used.
Files written by pandas' ``to_parquet`` are read too: their stored index
columns are left out, as pandas moves them into the frame's index.

For the inference API it also writes and reads a ``frame.Frame`` as pandas
lays a DataFrame out (``write_frame``, ``read_frame``): the index as the
``__index_level_0__`` column (``timestamp[ns]`` or float64) and the
``pandas`` schema metadata, so that ``pd.read_parquet`` of a file the port
wrote gives the JAX package's frame and the port reads the JAX package's
files; ``index_start`` reads the first index value alone.
"""

from __future__ import annotations

import json
import logging
import os
from glob import glob

import numpy as np

from .frame import Frame

logger = logging.getLogger(__name__)


def _index_columns(schema) -> set[str]:
    """The columns pandas stores its index in, which are not data columns."""
    meta = schema.pandas_metadata or {}
    names = {c for c in meta.get('index_columns', []) if isinstance(c, str)}
    return names | {n for n in schema.names if n.startswith('__index_level_')}


def get_parquet_cols(fp: str) -> list[str]:
    """Data column names of a parquet file, from its footer only."""
    import pyarrow.parquet as pq

    schema = pq.read_schema(fp, memory_map=True)
    index = _index_columns(schema)
    return [c for c in schema.names if c not in index]


def get_parquet_fps(folder: str, recursive: bool = False) -> list[str]:
    """Parquet files in ``folder`` (and below it with ``recursive``)."""
    if not os.path.exists(folder):
        raise FileNotFoundError(folder)
    if recursive:
        return glob(f'{folder}/**/*.parquet', recursive=True)
    return glob(f'{folder}/*.parquet')


def _read(fp: str, columns: list[str] | None) -> dict[str, np.ndarray]:
    import pyarrow.parquet as pq

    if columns is None:
        columns = get_parquet_cols(fp)
    table = pq.read_table(fp, columns=columns)
    # pyarrow turns nulls into NaN (integers with nulls into float64), as
    # pandas does.
    return {name: table.column(name).to_numpy() for name in columns}


def read_columns(fp: str, columns: list[str] | None = None, max_retries: int = 3) -> dict[str, np.ndarray]:
    """``{column: numpy array}`` of ``columns`` (every data column when None),
    nulls as NaN, retried ``max_retries`` times for flaky network file
    systems; raises ``ValueError`` when every attempt failed."""
    last_error = None
    for _ in range(max_retries + 1):
        try:
            return _read(fp, None if columns is None else list(columns))
        except Exception as e:  # noqa: BLE001 - deliberate: any I/O flake retries
            logger.error(f'Failed to read parquet {fp=} - {e}')
            last_error = e
    raise ValueError(f'Failed to read parquet {fp=}') from last_error


def write_night(fp: str, columns: dict[str, np.ndarray], metadata: dict | None = None) -> None:
    """Write one night as ``ingest`` lays it out: a table with one float32
    column per entry of ``columns``, the shorter ones padded with nulls to
    the longest, NaN stored as null, and ``metadata`` as the
    ``signal_metadata`` JSON of the schema."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = max(len(v) for v in columns.values())
    arrays = {}
    for name, values in columns.items():
        col = np.full(n, np.nan, np.float32)
        col[: len(values)] = values
        arrays[name] = pa.array(col, type=pa.float32(), from_pandas=True)
    table = pa.table(arrays)
    if metadata is not None:
        table = table.replace_schema_metadata({b'signal_metadata': json.dumps(metadata).encode('utf-8')})
    pq.write_table(table, fp)


# The pandas release whose ``to_parquet`` layout (the ``pandas`` schema
# metadata) ``write_frame`` follows.
PANDAS_LAYOUT = '3.0.3'
INDEX_COLUMN = '__index_level_0__'


def _pandas_column(name: str | None, field_name: str, dtype: np.dtype) -> dict:
    if dtype.kind == 'M':
        pandas_type, numpy_type = 'datetime', 'datetime64[ns]'
    else:
        pandas_type = numpy_type = str(dtype)
    return {'name': name, 'field_name': field_name, 'pandas_type': pandas_type, 'numpy_type': numpy_type,
            'metadata': None}


def write_frame(fp: str, frame: Frame) -> None:
    """Write ``frame`` as ``DataFrame.to_parquet`` writes the JAX package's
    frame: each column in its dtype with NaN as null, then the index as
    ``__index_level_0__`` (``timestamp[ns]`` for a datetime index, else
    float64), and the ``pandas`` metadata that describes them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    index = frame.index.view('datetime64[ns]') if frame.datetime else np.asarray(frame.index, np.float64)
    arrays = {name: pa.array(v, from_pandas=True) for name, v in frame.columns.items()}
    arrays[INDEX_COLUMN] = pa.array(index)
    meta = {
        'index_columns': [INDEX_COLUMN],
        'column_indexes': [{'name': None, 'field_name': None, 'pandas_type': 'unicode', 'numpy_type': 'str',
                            'metadata': {'encoding': 'UTF-8'}}],
        'columns': [_pandas_column(name, name, v.dtype) for name, v in frame.columns.items()]
        + [_pandas_column(None, INDEX_COLUMN, index.dtype)],
        'attributes': {},
        'creator': {'library': 'pyarrow', 'version': pa.__version__},
        'pandas_version': PANDAS_LAYOUT,
    }
    table = pa.table(arrays).replace_schema_metadata({b'pandas': json.dumps(meta).encode('utf-8')})
    pq.write_table(table, fp)


def _index_values(column) -> tuple[np.ndarray, bool]:
    """A stored index column as (values, is datetime): int64 nanoseconds for
    a naive timestamp column, float64 otherwise."""
    import pyarrow as pa

    if pa.types.is_timestamp(column.type):
        if column.type.tz is not None:
            raise ValueError(f'a time-zone index ({column.type}) is not read')
        return column.cast(pa.timestamp('ns')).to_numpy().view(np.int64), True
    return np.asarray(column.to_numpy(), dtype=np.float64), False


def _index_spec(schema):
    """The one index the ``pandas`` metadata describes: a stored column's
    name, a range (a dict), or None (no metadata: a RangeIndex from 0)."""
    entries = (schema.pandas_metadata or {}).get('index_columns', [])
    if len(entries) > 1:
        raise ValueError(f'a multi-level index ({entries}) is not read')
    return entries[0] if entries else None


def read_frame(fp: str, columns: list[str] | None = None) -> Frame:
    """A parquet file as ``pd.read_parquet`` frames it: the data columns
    (``columns`` of them when given, nulls as NaN) over the index the
    ``pandas`` metadata names (a stored column, or a RangeIndex it
    describes), or over 0, 1, 2, ... without it; a naive datetime index in
    nanoseconds whatever its stored unit."""
    import pyarrow.parquet as pq

    schema = pq.read_schema(fp, memory_map=True)
    spec = _index_spec(schema)
    names = [c for c in get_parquet_cols(fp) if columns is None or c in columns]
    table = pq.read_table(fp, columns=names + ([spec] if isinstance(spec, str) else []))
    if isinstance(spec, str):
        index, is_datetime = _index_values(table.column(spec))
    elif isinstance(spec, dict):
        index, is_datetime = np.arange(spec['start'], spec['stop'], spec['step'], dtype=np.float64), False
    else:
        index, is_datetime = np.arange(table.num_rows, dtype=np.float64), False
    return Frame(index, {c: table.column(c).to_numpy() for c in names}, datetime=is_datetime)


def index_start(fp: str) -> tuple[float, bool]:
    """The first value of a parquet file's index as ``pd.read_parquet``
    frames it (``read_frame``), and whether it is a datetime (then in
    nanoseconds since the epoch)."""
    import pyarrow.parquet as pq

    f = pq.ParquetFile(fp)
    spec = _index_spec(f.schema_arrow)
    if isinstance(spec, str):
        first = next(f.iter_batches(batch_size=1, columns=[spec]))  # decodes the first page only
        values, is_datetime = _index_values(first.column(0))
        return values[0], is_datetime
    return (spec['start'] if isinstance(spec, dict) else 0), False
