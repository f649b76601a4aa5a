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
"""

from __future__ import annotations

import json
import logging
import os
from glob import glob

import numpy as np

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
