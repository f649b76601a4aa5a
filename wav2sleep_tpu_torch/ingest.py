"""Offline ingest: per-night EDF and annotations to training parquet.

The port's copy of ``wav2sleep_tpu/ingest.py``, without pandas. A night's
labels are parsed (NSRR XML or WSC txt) and put on the 1,200-epoch 30 s grid
with unscored epochs as -1; nights without N1, N3 or REM, or whose ECG/EOG
unit is not a known voltage unit, are quarantined as ``.issues.parquet``; a
flat PPG is dropped; the signals are resampled onto the model grids and
written with the per-signal metadata in the schema (``signal_metadata``).
The files hold the JAX package's frame (the same columns, values and
``pandas`` metadata) with its rows in time order: the JAX package writes the
points of a finer grid after those of a coarser one that comes before it,
and its dataset then reads that signal out of order (ROADMAP §C.19). Either
package reads these files.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from glob import glob

import numpy as np

from .data.edf import INV_ALT_UNIT_NAMES, VOLTAGE_SIGNALS, load_edf_arrays
from .data.frame import Frame
from .data.parquet import schema_metadata, write_frame
from .data.preprocessing import EDF_COLS, TARGET_LABEL_INDEX, process_waveform_arrays
from .data.txt import parse_txt_annotations
from .data.xml import parse_xml_annotations
from .settings import CCSHS, CFS, CHAT, INGEST, LABEL, MESA, MROS, PPG, SHHS, WSC

logger = logging.getLogger(__name__)

VALID_VOLTAGE_UNITS = set(INV_ALT_UNIT_NAMES.keys())
MIN_SIGNAL_STD = 0.001  # below this a channel is flat (dead)
SIGNAL_METADATA = b'signal_metadata'


def check_voltage_signal_units(signal_metadata: dict[str, dict]) -> list[str]:
    """Voltage signals (ECG/EOG) whose header unit isn't a known voltage unit."""
    invalid = []
    for sig_name, meta in signal_metadata.items():
        if sig_name in VOLTAGE_SIGNALS:
            unit = meta.get('unit', '').strip()
            if unit not in VALID_VOLTAGE_UNITS:
                invalid.append(f"{sig_name} (unit='{unit}')")
    return invalid


def check_and_drop_flat_arrays(
    arrays: dict[str, tuple], signal_metadata: dict[str, dict]
) -> tuple[dict[str, tuple], dict[str, dict], list[str]]:
    """Drop a flat PPG (some CFS/CCSHS nights record a disconnected pleth
    sensor): a sample standard deviation (ddof 1) under ``MIN_SIGNAL_STD``.
    Returns the arrays and metadata without it, and the dropped names."""
    dropped = []
    for sig_name in (PPG,):
        if sig_name in arrays:
            sig = arrays[sig_name][0]
            std = float(np.std(sig, ddof=1)) if len(sig) > 1 else 0.0
            if std < MIN_SIGNAL_STD:
                logger.warning(f'Dropping flat signal {sig_name} (std={std:.6f})')
                arrays = {k: v for k, v in arrays.items() if k != sig_name}
                signal_metadata.pop(sig_name, None)
                dropped.append(sig_name)
    return arrays, signal_metadata, dropped


def _labels_on_grid(seconds: np.ndarray, stages: np.ndarray) -> np.ndarray:
    """The stages at ``TARGET_LABEL_INDEX``, -1 where there is none or it is
    NaN (``reindex(...).fillna(-1)``); raises ``ValueError`` for duplicate
    times, as ``reindex`` does."""
    if len(np.unique(seconds)) != len(seconds):
        raise ValueError('cannot reindex on an axis with duplicate labels')
    out = np.full(len(TARGET_LABEL_INDEX), np.nan)
    order = np.argsort(seconds, kind='stable')
    pos = np.clip(np.searchsorted(seconds[order], TARGET_LABEL_INDEX), 0, max(len(seconds) - 1, 0))
    if len(seconds):
        hit = seconds[order][pos] == TARGET_LABEL_INDEX
        out[hit] = stages[order][pos[hit]]
    out[np.isnan(out)] = -1
    return out


def _join_labels(waveform: Frame, labels: np.ndarray) -> Frame:
    """``pd.concat([waveform, labels], axis=1)`` in time order: the columns
    over the sorted union of the two indexes, NaN where a column has no
    value, ``Stage`` last."""
    index = np.union1d(waveform.index, TARGET_LABEL_INDEX)
    out = Frame(index)
    rows = np.searchsorted(index, waveform.index)
    for name, values in waveform.columns.items():
        col = np.full(len(index), np.nan, values.dtype)
        col[rows] = values
        out.columns[name] = col
    stage = np.full(len(index), np.nan)
    stage[np.searchsorted(index, TARGET_LABEL_INDEX)] = labels
    out.columns[LABEL] = stage
    return out


def _parse_labels(label_fp: str):
    """``(seconds, stages)`` of an annotation file, or None when it does not
    parse."""
    try:
        if label_fp.endswith('.xml'):
            return parse_xml_annotations(label_fp)
        labels = parse_txt_annotations(fp=label_fp)
    except Exception as e:  # noqa: BLE001 - per-file tolerance
        logger.error(f'Failed to parse: {label_fp}. {e}')
        return None
    if labels is None:
        logger.error(f'Failed to parse: {label_fp}.')
    return labels


def process_night(
    edf_fp: str,
    label_fp: str | None,
    output_fp: str,
    columns: list[str],
    overwrite: bool = False,
) -> bool:
    """One night: EDF (and annotations) to parquet. Returns True if written;
    False when the output or its ``.issues`` file exists (unless
    ``overwrite``) or the annotations do not parse."""
    quarantine_fp = output_fp.replace('.parquet', '.issues.parquet')
    if not overwrite and (os.path.exists(output_fp) or os.path.exists(quarantine_fp)):
        # A quarantined night is done work too.
        logger.debug(f'Skipping {edf_fp=}, {output_fp=}, already exists')
        return False
    os.makedirs(os.path.dirname(output_fp), exist_ok=True)

    labels = None
    if label_fp is not None:
        parsed = _parse_labels(label_fp)
        if parsed is None:
            return False
        labels = _labels_on_grid(*parsed)
        # Sleep/wake-only scoring (no N1/N3/REM) is quarantined, not trained on.
        if not np.isin(labels, (1.0, 3.0, 4.0)).any():
            logger.error(f'No N1, N3 or REM in {label_fp}.')
            output_fp = quarantine_fp

    arrays, signal_metadata, _start = load_edf_arrays(edf_fp, columns=columns)
    invalid_voltage = check_voltage_signal_units(signal_metadata)
    if invalid_voltage:
        logger.warning(f'{edf_fp}: Invalid units for voltage signals: {invalid_voltage}')
        output_fp = quarantine_fp  # a night failing both checks stays '.issues.parquet'
    arrays, signal_metadata, _dropped = check_and_drop_flat_arrays(arrays, signal_metadata)

    frame = process_waveform_arrays(arrays, columns=columns)
    if labels is not None:
        frame = _join_labels(frame, labels)
    write_frame(output_fp, frame, metadata={SIGNAL_METADATA: json.dumps(signal_metadata).encode('utf-8')})
    return True


def read_signal_metadata(parquet_fp: str) -> dict[str, dict]:
    """The per-signal metadata dict written into a night's schema, {} when
    there is none."""
    raw = schema_metadata(parquet_fp).get(SIGNAL_METADATA)
    return json.loads(raw.decode('utf-8')) if raw else {}


def get_edf_path(session_id: str, dataset: str, folder: str) -> str:
    """A session's EDF in its dataset's layout (SHHS and MrOS by visit, CHAT
    by partition and its ``_fixed.edf`` repair where there is one)."""
    if dataset == SHHS:
        partition, _ = session_id.split('-')  # shhs1 / shhs2 visit partitions
        return os.path.join(folder, 'polysomnography/edfs', partition, f'{session_id}.edf')
    if dataset == MROS:
        _, partition, *_ = session_id.split('-')  # mros visit1/visit2
        return os.path.join(folder, 'polysomnography/edfs', partition, f'{session_id}.edf')
    if dataset == CHAT:
        if 'nonrandomized' in session_id:
            partition = 'nonrandomized'
        else:
            partition = session_id.split('-')[1]
        edf_fp = os.path.join(folder, 'polysomnography/edfs', partition, f'{session_id}.edf')
        fixed = edf_fp.replace('.edf', '_fixed.edf')
        # Prefer repaired headers (physical_max == 0.0 files, see preprocessing.fix_edfs).
        return fixed if os.path.exists(fixed) else edf_fp
    return os.path.join(folder, 'polysomnography/edfs', f'{session_id}.edf')


def prepare_dataset(folder: str, output_folder: str, dataset: str) -> dict[str, dict[str, str | None]]:
    """``{session_id: {edf_fp, label_fp, output_fp}}`` of a dataset: WSC pairs
    each EDF with its ``.stg.txt`` or ``.allscore.txt``, the NSRR datasets
    each ``-nsrr.xml`` with its EDF, and any other dataset is EDF only."""
    fp_dict: dict[str, dict[str, str | None]] = {}
    if dataset == WSC:
        for edf_fp in glob(f'{folder}/**/*.edf', recursive=True):
            stg_fp = edf_fp.replace('.edf', '.stg.txt')
            all_score_fp = edf_fp.replace('.edf', '.allscore.txt')
            if os.path.exists(stg_fp):
                label_fp = stg_fp
            elif os.path.exists(all_score_fp):
                label_fp = all_score_fp
            else:
                continue
            session_id = os.path.basename(edf_fp).replace('.edf', '')
            output_fp = os.path.join(output_folder, dataset, INGEST, f'{session_id}.parquet')
            fp_dict[session_id] = {'edf_fp': edf_fp, 'label_fp': label_fp, 'output_fp': output_fp}
    elif dataset in (SHHS, MROS, CHAT, MESA, CCSHS, CFS):
        for label_fp in glob(f'{folder}/polysomnography/annotations-events-nsrr/**/**.xml', recursive=True):
            session_id = os.path.basename(label_fp).replace('-nsrr.xml', '')
            edf_fp = get_edf_path(session_id, dataset, folder)
            if not os.path.exists(edf_fp):
                logger.warning(f"{edf_fp=} doesn't exist. Skipping...")
                continue
            output_fp = os.path.join(output_folder, dataset, INGEST, f'{session_id}.parquet')
            fp_dict[session_id] = {'edf_fp': edf_fp, 'label_fp': label_fp, 'output_fp': output_fp}
    else:
        logger.warning(f'Unknown dataset: {dataset}. Only processing EDF files.')
        for edf_fp in glob(f'{folder}/**/*.edf', recursive=True):
            if os.path.exists(edf_fp.replace('.edf', '_fixed.edf')):
                continue  # the repaired copy is picked up separately
            output_fp = edf_fp.replace(folder, output_folder).replace('.edf', '.parquet')
            fp_dict[os.path.basename(edf_fp)] = {'edf_fp': edf_fp, 'label_fp': None, 'output_fp': output_fp}
    return fp_dict


def process_files(
    fp_dict: dict[str, dict],
    max_parallel: int = 1,
    overwrite: bool = False,
    columns: list[str] | None = None,
    shard_hosts: bool = False,
) -> int:
    """Ingest every night of ``fp_dict`` over ``max_parallel`` processes (and,
    with ``shard_hosts``, this process's share of the ``torch.distributed``
    group's); returns the number written."""
    from .parallel.map import parallelise, shard_across_hosts

    columns = columns or EDF_COLS
    # A fixed order before sharding: glob's order may differ between hosts,
    # and an unsorted round-robin could give one night to two hosts.
    work = [fp_dict[k] for k in sorted(fp_dict)]
    if shard_hosts:
        work = shard_across_hosts(work)
    logger.info(f'Preparing to process {len(work)} files.')

    proc = functools.partial(_safe_process_night, columns=columns, overwrite=overwrite)
    if max_parallel > 1:
        converted = sum(parallelise(proc, work, max_parallel=max_parallel))
    else:
        converted = sum(proc(arg) for arg in work)
    logger.info(f'Converted {converted} files.')
    return converted


def _safe_process_night(arg_dict: dict, columns: list[str], overwrite: bool) -> bool:
    try:
        return process_night(columns=columns, overwrite=overwrite, **arg_dict)
    except Exception as e:  # noqa: BLE001 - per-file tolerance by design
        logger.error(f'Failed on {arg_dict} - {e}')
        return False
