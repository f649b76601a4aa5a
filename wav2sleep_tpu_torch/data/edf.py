"""EDF/EDF+ reading and a minimal writer, on numpy alone.

The port's copy of the EDF reader of ``wav2sleep_tpu/data/edf.py`` that the
serving extractors use: a fixed-layout header parse (256-byte file header,
256 bytes per signal header) with the same salvage of malformed headers, a
memory-mapped int16 record matrix (``EdfFile``), channel-alias matching with
the BROKEN-unit skip, and the per-channel normalization affine (voltages to
mV, arbitrary units onto [-1, 1]). ``load_edf_arrays`` reads the
channels of a night with its QC warnings (the inference API's EDF path),
``sample_seconds`` gives their sample times as the JAX package's datetime
index holds them, ``get_edf_start`` reads the start time and ``write_edf``
writes test and synthetic nights.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass, field

import numpy as np

from ..settings import ABD, ECG, EOG_L, EOG_R, PPG, THX
from .frame import seconds_to_ns

_logger = logging.getLogger(__name__)

# Alternative channel names seen across NSRR datasets (reference edf.py:15-33;
# the PPG list absorbs the CHAT dataset's typo zoo).
ALT_COLUMNS = {
    ECG: ('EKG', 'ECG1', 'ECG L', 'ECGL', 'ECG L-ECG R'),
    PPG: (
        'Pleth',
        'PlethWV',
        'PWF',
        'PlethMasimo',
        'PletMasimo',
        'PlethMasino',
        'PLETHMASIMO',
        'plethmasimo',
        'Plethmasimo',
    ),
    ABD: ('Abdo', 'ABDO RES', 'ABDO EFFORT', 'Abdominal', 'abdomen'),
    THX: ('Thor', 'THOR RES', 'THOR EFFORT', 'Thoracic', 'Chest', 'thorax', 'CHEST'),
    EOG_L: ('EOG-L', 'EOG(L)', 'E1', 'LOC', 'EOGl'),
    EOG_R: ('EOG-R', 'EOG(R)', 'E2', 'ROC', 'EOGr'),
}

MICRO_V = 'uV'
MILLI_V = 'mV'
VOLTS = 'V'
ALT_UNIT_NAMES = {
    MICRO_V: {'uV', 'uv'},
    MILLI_V: {'mV', 'mv'},
    VOLTS: {'V', 'v', 'Volts'},
}
INV_ALT_UNIT_NAMES = {v_i: k for k, v in ALT_UNIT_NAMES.items() for v_i in v}

VOLTAGE_SIGNALS = {ECG, EOG_L, EOG_R}
ARBITRARY_UNIT_SIGNALS = {ABD, THX, PPG}

UNIT_SCALING = {MICRO_V: 1e-3, MILLI_V: 1, VOLTS: 1e3}

BROKEN_UNIT = 'BROKEN'


def channel_norm_affine(
    sig_name: str,
    unit: str,
    physical_min: float,
    physical_max: float,
) -> tuple[str, float, float]:
    """(method, scale, offset) such that ``normalized = raw * scale + offset``.

    Voltage signals scale to mV; arbitrary-unit signals map their physical
    range onto [-1, 1] (reference edf.py:254-281)."""
    if sig_name in VOLTAGE_SIGNALS:
        return 'voltage_to_mV', get_unit_scaling(sig_name, unit), 0.0
    if sig_name in ARBITRARY_UNIT_SIGNALS:
        physical_range = abs(physical_max - physical_min)
        if physical_range > 0:
            physical_center = (physical_max + physical_min) / 2
            scale = 2.0 / physical_range
            return 'physical_range', scale, -physical_center * scale
    return 'none', 1.0, 0.0

HEADER_BYTES = 256
SIGNAL_HEADER_BYTES = 256


@dataclass
class EdfChannel:
    label: str
    transducer: str
    unit: str
    physical_min: float
    physical_max: float
    digital_min: int
    digital_max: int
    prefilter: str
    samples_per_record: int
    index: int

    @property
    def bitvalue(self) -> float:
        dig_range = self.digital_max - self.digital_min
        if dig_range == 0:
            return 1.0
        return (self.physical_max - self.physical_min) / dig_range


@dataclass
class EdfHeader:
    version: str
    patient_id: str
    recording_id: str
    start: datetime.datetime
    header_bytes: int
    n_records: int
    record_duration: float
    channels: list[EdfChannel] = field(default_factory=list)

    @property
    def duration_seconds(self) -> float:
        return self.n_records * self.record_duration


def _ascii(b: bytes) -> str:
    return b.decode('ascii', errors='replace').strip()


def _parse_start(date_s: str, time_s: str) -> datetime.datetime:
    try:
        d, mo, y = (int(x) for x in date_s.replace('-', '.').split('.'))
        h, mi, s = (int(x) for x in time_s.replace('-', '.').replace(':', '.').split('.'))
        # EDF spec: two-digit years 85-99 => 1985-1999, else 2000+.
        year = 1900 + y if y >= 85 else 2000 + y
        return datetime.datetime(year, mo, d, h, mi, s)
    except (ValueError, TypeError):
        return datetime.datetime(1985, 1, 1)


def read_edf_header(filepath: str) -> EdfHeader:
    """Parse the EDF fixed header + per-signal headers."""
    with open(filepath, 'rb') as f:
        h = f.read(HEADER_BYTES)
        if len(h) < HEADER_BYTES:
            raise ValueError(f'{filepath}: truncated EDF header')
        version = _ascii(h[0:8])
        patient = _ascii(h[8:88])
        recording = _ascii(h[88:168])
        start = _parse_start(_ascii(h[168:176]), _ascii(h[176:184]))
        try:
            header_bytes = int(_ascii(h[184:192]) or 0)
        except ValueError:
            header_bytes = 0
        try:
            n_records = int(_ascii(h[236:244]) or -1)
        except ValueError:
            n_records = -1
        try:
            record_duration = float(_ascii(h[244:252]) or 1.0)
        except ValueError:
            record_duration = 1.0
        if record_duration <= 0:
            # '0' is legal only for annotation-only EDF+ files, which hold
            # no signal data we could read; negative is corrupt. A clean
            # error keeps the per-file quarantine behavior instead of a
            # ZeroDivisionError deep in sampling_freq().
            raise ValueError(
                f'{filepath}: non-positive record duration {record_duration}'
            )
        try:
            ns = int(_ascii(h[252:256]))
        except ValueError:
            raise ValueError(f'{filepath}: invalid EDF signal count {_ascii(h[252:256])!r}')
        if ns < 0:
            raise ValueError(f'{filepath}: invalid EDF signal count {ns}')
        raw = f.read(ns * SIGNAL_HEADER_BYTES)
        if len(raw) < ns * SIGNAL_HEADER_BYTES:
            raise ValueError(f'{filepath}: truncated EDF signal headers')

    def fields(width: int, offset: int) -> list[str]:
        base = offset * ns
        return [_ascii(raw[base + i * width : base + (i + 1) * width]) for i in range(ns)]

    labels = fields(16, 0)
    transducers = fields(80, 16)
    units = fields(8, 96)
    p_min = fields(8, 104)
    p_max = fields(8, 112)
    d_min = fields(8, 120)
    d_max = fields(8, 128)
    prefilter = fields(80, 136)
    spr = fields(8, 216)

    def _f(s: str, default: float = 0.0) -> float:
        try:
            return float(s)
        except ValueError:
            return default

    channels = [
        EdfChannel(
            label=labels[i],
            transducer=transducers[i],
            unit=units[i],
            physical_min=_f(p_min[i]),
            physical_max=_f(p_max[i]),
            digital_min=int(_f(d_min[i], -32768)),
            digital_max=int(_f(d_max[i], 32767)),
            prefilter=prefilter[i],
            samples_per_record=int(_f(spr[i], 0)),
            index=i,
        )
        for i in range(ns)
    ]
    # Defensive fixes for malformed headers (Profusion exports and truncated
    # transfers are common in NSRR data; the reference routes these through
    # pyedflib errors + 0_fix_edfs — here the reader salvages what the file
    # actually holds and warns, so ingestion can quarantine per-file instead
    # of crashing on an obscure mmap error).
    for c in channels:
        if c.samples_per_record < 0:
            _logger.warning(
                f'{filepath}: signal {c.label!r} claims {c.samples_per_record} '
                'samples/record; treating as 0.'
            )
            c.samples_per_record = 0
    expected_header = HEADER_BYTES + ns * SIGNAL_HEADER_BYTES
    if header_bytes != expected_header:
        _logger.warning(
            f'{filepath}: header claims {header_bytes} header bytes but '
            f'{ns} signals imply {expected_header}; using the computed size.'
        )
        header_bytes = expected_header
    header = EdfHeader(
        version=version,
        patient_id=patient,
        recording_id=recording,
        start=start,
        header_bytes=header_bytes,
        n_records=n_records,
        record_duration=record_duration,
        channels=channels,
    )
    total_spr = sum(c.samples_per_record for c in channels)
    data_bytes = max(os.path.getsize(filepath) - header_bytes, 0)
    fit_records = int(data_bytes // (2 * total_spr)) if total_spr else 0
    if header.n_records < 0:  # Unknown record count: infer from file size.
        header.n_records = fit_records
    elif header.n_records > fit_records:
        # Data area shorter than the header claims (truncated download):
        # clamp to whole records actually present rather than failing the
        # memmap with a size error.
        _logger.warning(
            f'{filepath}: header claims {header.n_records} records but the '
            f'file holds {fit_records}; reading the records present.'
        )
        header.n_records = fit_records
    return header


class EdfFile:
    """Random-access EDF reader over a memory-mapped record matrix."""

    def __init__(self, filepath: str):
        self.filepath = filepath
        self.header = read_edf_header(filepath)
        self._total_spr = sum(c.samples_per_record for c in self.header.channels)
        self._offsets = np.cumsum([0] + [c.samples_per_record for c in self.header.channels])
        self._data: np.memmap | None = None

    @property
    def _records(self) -> np.ndarray:
        if self._data is None:
            if self.header.n_records == 0 or self._total_spr == 0:
                # Degenerate (empty/salvaged) data area: mmap rejects
                # zero-length maps; an empty record matrix reads as
                # zero-sample channels downstream.
                self._data = np.empty((self.header.n_records, self._total_spr), '<i2')
            else:
                self._data = np.memmap(
                    self.filepath,
                    dtype='<i2',
                    mode='r',
                    offset=self.header.header_bytes,
                    shape=(self.header.n_records, self._total_spr),
                )
        return self._data

    def labels(self) -> list[str]:
        return [c.label for c in self.header.channels]

    def channel(self, label: str) -> EdfChannel:
        for c in self.header.channels:
            if c.label == label:
                return c
        raise KeyError(label)

    def n_samples(self, label: str) -> int:
        return self.channel(label).samples_per_record * self.header.n_records

    def read_digital(self, label: str, out: np.ndarray | None = None) -> np.ndarray:
        """Extract one channel's int16 samples (strided slice of the record
        matrix). ``out`` reuses a caller-owned buffer: first-touch page
        faults can make fresh large allocations far slower than copies into
        warm buffers, so hot pipelines pool them."""
        c = self.channel(label)
        lo, hi = self._offsets[c.index], self._offsets[c.index + 1]
        view = self._records[:, lo:hi]
        n = view.size
        if out is not None:
            dst = out[:n].reshape(view.shape)
            np.copyto(dst, view)
            return out[:n]
        return np.ascontiguousarray(view).reshape(-1)

    def read_physical(self, label: str, dtype=np.float64, out: np.ndarray | None = None) -> np.ndarray:
        """Digital -> physical conversion, matching edflib:
        phys = (dig - dig_min) * bitvalue + phys_min.

        ``dtype=np.float32`` halves memory traffic on the hot inference path
        (int16 sources lose nothing in f32)."""
        c = self.channel(label)
        dig = self.read_digital(label)
        n = dig.size
        if out is not None:
            buf = out[:n]
            np.multiply(dig, dtype(c.bitvalue), out=buf, casting='unsafe')
            buf += dtype(c.physical_min) - dtype(c.bitvalue) * dtype(c.digital_min)
            return buf
        # Same fused association as the pooled path above (dig*bv + const):
        # (dig - dmin)*bv + pmin rounds differently in f32, and streaming/
        # ingestion parity must not be data-dependent.
        digf = dig.astype(dtype)
        digf *= dtype(c.bitvalue)
        digf += dtype(c.physical_min) - dtype(c.bitvalue) * dtype(c.digital_min)
        return digf

    def sampling_freq(self, label: str) -> float:
        c = self.channel(label)
        return c.samples_per_record / self.header.record_duration

    def close(self):
        self._data = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_unit_scaling(col: str, unit: str) -> float:
    """Scaling factor to mV for voltage signals; 1.0 otherwise
    (reference edf.py:59-84)."""
    if col not in VOLTAGE_SIGNALS:
        return 1.0
    unit_stripped = unit.strip()
    if not unit_stripped:
        _logger.warning(f"Blank unit for voltage signal '{col}' - assuming no scaling needed")
        return 1.0
    if unit_stripped in ALT_UNIT_NAMES:
        return UNIT_SCALING[unit_stripped]
    if unit_stripped in INV_ALT_UNIT_NAMES:
        return UNIT_SCALING[INV_ALT_UNIT_NAMES[unit_stripped]]
    _logger.warning(f"Unknown unit '{unit}' for voltage signal '{col}' - assuming no scaling needed")
    return 1.0


def get_column_match(
    target_col: str,
    available_cols,
    units_map: dict[str, str] | None = None,
    raise_error: bool = True,
):
    """Resolve a canonical column name against EDF channel labels, skipping
    channels whose unit carries the BROKEN sentinel (reference edf.py:90-128)."""

    def is_broken(col: str) -> bool:
        if units_map is None:
            return False
        return units_map.get(col, '').strip().upper() == BROKEN_UNIT

    available = list(available_cols)
    if target_col in available and not is_broken(target_col):
        return target_col
    for alt_col in ALT_COLUMNS.get(target_col, ()):
        if alt_col in available and not is_broken(alt_col):
            return alt_col
    if raise_error:
        raise KeyError(f'EDF has no valid signal called {target_col}')
    return None


def units_map_first(header) -> dict[str, str]:
    """label -> unit with FIRST occurrence winning on duplicate labels.

    ``EdfFile.channel()``/reads return the first matching channel, so any
    unit-based decision (the BROKEN-unit skip especially) must judge the
    same channel that would actually be read — a last-wins dict could pass
    a broken first channel on the strength of a later duplicate's unit.
    """
    out: dict[str, str] = {}
    for c in header.channels:
        out.setdefault(c.label, c.unit)
    return out


def _warn_signal_issues(
    filepath: str,
    sig_name: str,
    sig: np.ndarray,
    raw_std: float,
    raw_min: float,
    raw_max: float,
    physical_min: float,
    physical_max: float,
    unit: str,
) -> None:
    """QC warnings for likely data problems (reference edf.py:131-179)."""
    basename = os.path.basename(filepath)
    nan_count = int(np.isnan(sig).sum())
    if nan_count > 0:
        nan_pct = 100 * nan_count / len(sig)
        _logger.warning(f'{basename}: {sig_name} has {nan_count} NaN values ({nan_pct:.1f}%)')
    if raw_std == 0 or np.isnan(raw_std):
        _logger.warning(f'{basename}: {sig_name} is constant (std=0) - possible dead channel')
    if physical_max - physical_min == 0:
        _logger.warning(
            f'{basename}: {sig_name} has zero physical range '
            f'(min={physical_min}, max={physical_max}) - cannot normalize'
        )
    if sig_name in VOLTAGE_SIGNALS:
        scaled_max = max(abs(raw_min), abs(raw_max)) * get_unit_scaling(sig_name, unit)
        if scaled_max > 200:  # ECG/EOG > 200 mV => header unit is wrong.
            _logger.warning(
                f'{basename}: {sig_name} has extreme amplitude ({scaled_max:.1f} mV after scaling) '
                f"- likely incorrect unit '{unit}' in header"
            )


def load_edf_arrays(
    filepath: str, columns: list[str]
) -> tuple[dict[str, tuple[np.ndarray, float]], dict[str, dict], datetime.datetime]:
    """The counterpart of the JAX package's ``load_edf_arrays`` with its
    defaults as ``prepare`` calls it: ``{col: (values, sampling_freq)}`` of
    the canonical ``columns`` found, in float64 (voltages in mV, arbitrary
    units on [-1, 1], see ``channel_norm_affine``; a column not found is
    left out), the per-signal metadata with the raw statistics and the
    affine applied, and the start."""
    metadata: dict[str, dict] = {}
    arrays: dict[str, tuple[np.ndarray, float]] = {}
    with EdfFile(filepath) as f:
        labels = f.labels()
        units_map = units_map_first(f.header)
        for sig_name in columns:
            actual = get_column_match(sig_name, labels, units_map=units_map, raise_error=False)
            if actual is None:
                continue
            ch = f.channel(actual)
            sig = f.read_physical(actual)
            sampling_freq = f.sampling_freq(actual)
            unit = ch.unit
            physical_min, physical_max = ch.physical_min, ch.physical_max

            raw_mean = float(np.nanmean(sig)) if len(sig) else float('nan')
            raw_std = float(np.nanstd(sig)) if len(sig) else float('nan')
            raw_min = float(np.nanmin(sig)) if len(sig) else float('nan')
            raw_max = float(np.nanmax(sig)) if len(sig) else float('nan')
            _warn_signal_issues(filepath, sig_name, sig, raw_std, raw_min, raw_max, physical_min, physical_max, unit)

            norm_method, norm_scale, norm_offset = channel_norm_affine(sig_name, unit, physical_min, physical_max)
            if norm_scale != 1.0 or norm_offset != 0.0:
                sig = sig * norm_scale + norm_offset

            metadata[sig_name] = {
                'unit': unit,
                'physical_min': physical_min,
                'physical_max': physical_max,
                'physical_range_inverted': physical_max < physical_min,
                'raw_mean': raw_mean,
                'raw_std': raw_std,
                'raw_min': raw_min,
                'raw_max': raw_max,
                'norm_method': norm_method,
                'norm_scale': norm_scale,
                'norm_offset': norm_offset,
                'sampling_freq': sampling_freq,
            }
            arrays[sig_name] = (sig, sampling_freq)
        start = f.header.start
    if not arrays:
        _logger.warning(f'No signals found in {filepath} for {columns}')
    return arrays, metadata, start


def sample_seconds(n: int, sampling_freq: float, convert_time: bool = False) -> np.ndarray:
    """The times in seconds of a channel's ``n`` samples, ``arange(n) / fs``
    as the JAX package's ``load_edf_data`` indexes them. With
    ``convert_time`` they go, as there, through a datetime index and back
    (``start + pd.to_timedelta(t, unit='s')``, then the offsets from the
    start over 1e9): rounded to whole nanoseconds as pandas rounds
    (``frame.seconds_to_ns``), which moves the times of rates such as 77 Hz
    that are not whole nanoseconds."""
    t = np.arange(n) / sampling_freq
    if convert_time:
        t = seconds_to_ns(t).astype(np.float64) / 1e9
    return t


def get_edf_start(filepath: str) -> datetime.datetime:
    """The recording's start date and time, from its header."""
    return read_edf_header(filepath).start


def write_edf(
    filepath: str,
    signals: dict[str, np.ndarray],
    sampling_freqs: dict[str, float],
    units: dict[str, str] | None = None,
    physical_ranges: dict[str, tuple[float, float]] | None = None,
    record_duration: float = 1.0,
    start: datetime.datetime | None = None,
) -> None:
    """Minimal EDF writer (test fixtures + synthetic data generation).

    Quantizes each float signal into int16 using the provided (or observed)
    physical range.
    """
    units = units or {}
    physical_ranges = physical_ranges or {}
    start = start or datetime.datetime(2000, 1, 1, 22, 0, 0)
    labels = list(signals.keys())
    ns = len(labels)
    sprs = []
    durations = []
    for lab in labels:
        fs = sampling_freqs[lab]
        spr = fs * record_duration
        if abs(spr - round(spr)) > 1e-9:
            raise ValueError(f'{lab}: sampling freq {fs} incompatible with record_duration {record_duration}')
        sprs.append(int(round(spr)))
        durations.append(len(signals[lab]) / fs)
    n_records = int(min(d // record_duration for d in durations)) if ns else 0

    header_bytes = HEADER_BYTES + ns * SIGNAL_HEADER_BYTES

    def pad(s: str, width: int) -> bytes:
        b = s.encode('ascii', errors='replace')[:width]
        return b + b' ' * (width - len(b))

    dig_min, dig_max = -32768, 32767
    quantized = []
    phys = []
    for lab in labels:
        x = np.asarray(signals[lab], dtype=np.float64)
        if lab in physical_ranges:
            pmin, pmax = physical_ranges[lab]
        else:
            pmin, pmax = float(np.min(x)), float(np.max(x))
            if pmin == pmax:
                pmax = pmin + 1.0
        bitvalue = (pmax - pmin) / (dig_max - dig_min)
        dig = np.clip(np.round((x - pmin) / bitvalue) + dig_min, dig_min, dig_max).astype('<i2')
        quantized.append(dig)
        phys.append((pmin, pmax))

    with open(filepath, 'wb') as f:
        f.write(pad('0', 8))
        f.write(pad('X X X X', 80))
        f.write(pad('Startdate X X X X', 80))
        f.write(pad(start.strftime('%d.%m.%y'), 8))
        f.write(pad(start.strftime('%H.%M.%S'), 8))
        f.write(pad(str(header_bytes), 8))
        f.write(pad('', 44))
        f.write(pad(str(n_records), 8))
        f.write(pad(f'{record_duration:g}', 8))
        f.write(pad(str(ns), 4))
        for lab in labels:
            f.write(pad(lab, 16))
        for _ in labels:
            f.write(pad('', 80))
        for lab in labels:
            f.write(pad(units.get(lab, ''), 8))
        for pmin, _ in phys:
            f.write(pad(f'{pmin:.6g}'[:8], 8))
        for _, pmax in phys:
            f.write(pad(f'{pmax:.6g}'[:8], 8))
        for _ in labels:
            f.write(pad(str(dig_min), 8))
        for _ in labels:
            f.write(pad(str(dig_max), 8))
        for _ in labels:
            f.write(pad('', 80))
        for spr in sprs:
            f.write(pad(str(spr), 8))
        for _ in labels:
            f.write(pad('', 32))
        for r in range(n_records):
            for lab, spr, dig in zip(labels, sprs, quantized):
                f.write(dig[r * spr : (r + 1) * spr].tobytes())
