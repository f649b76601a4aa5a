"""Synthetic overnight polysomnography with realistic signal morphology.

The port's copy of ``wav2sleep_tpu/data/synth.py``: for the same seed,
``write_nights`` writes the same EDF bytes and returns the same labels. The
waveforms have the structure that stresses the pipeline: QRS complexes with
sharp R-waves (where mu-law quantization bites), stage-modulated heart rate
and HRV, baseline wander, movement artifacts, pulsatile PPG, and
breathing-shaped respiration with apnea dropouts, not bare sinusoids. The
float32 order of operations and the scratch and time-grid caches decide the
bytes; keep them as they are.

Signal names use EDF channel conventions (``Pleth``, ``ABDO RES`` ...); the
EDF reader's alias tables map them onto the model columns.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from .edf import write_edf

# NSRR-realistic source rates (SHHS ECG 125 Hz, MESA PPG 256 Hz, resp 10 Hz):
# off-grid vs the model grid, so decoding exercises the real lerp path.
RATES = {'ECG': 125.0, 'Pleth': 256.0, 'ABDO RES': 10.0, 'THOR RES': 10.0}

# EOG (MESA-style 256 Hz; model grid is 4096/30 ~ 136.5 Hz, so decoding
# exercises the DOWN-sampling lerp path — the opposite regime from ECG).
RATES_EOG = {'EOG(L)': 256.0, 'EOG(R)': 256.0}

# Per-stage signal physiology (Wake / Light / Deep / REM). Deliberately
# strong signatures: the aim is a model with genuine cross-night skill whose
# decision margins reflect *trained* behavior, not clinical realism. (With
# subtle signatures a 1M-param model just memorizes the handful of synthetic
# train nights and never generalizes — measured eval acc below chance.)
STAGE_HR = np.array([1.4, 1.1, 0.7, 1.0])
STAGE_HRV = np.array([0.05, 0.02, 0.01, 0.25])
STAGE_RESP_AMP = np.array([0.2, 0.55, 0.95, 0.35])
STAGE_RESP_HZ = np.array([0.35, 0.25, 0.16, 0.30])
STAGE_ECG_NOISE = np.array([80.0, 20.0, 5.0, 35.0])


def synth_stages(rng: np.random.Generator, n_epochs: int) -> np.ndarray:
    """Stage sequence with realistic dwell (~20-epoch geometric segments)."""
    stages = []
    while len(stages) < n_epochs:
        stage = int(rng.integers(0, 4))
        stages.extend([stage] * int(rng.geometric(1 / 20.0)))
    return np.asarray(stages[:n_epochs], np.int32)


# Scratch pool: all per-night arrays are float32, built in place in pooled
# buffers that persist across nights (fresh large allocations page-fault
# slowly, and expression temporaries in f64 are many times slower).
_SCRATCH: dict[str, np.ndarray] = {}


def _scratch(key: str, n: int, dtype=np.float32) -> np.ndarray:
    buf = _SCRATCH.get(key)
    if buf is None or buf.size < n or buf.dtype != dtype:
        buf = _SCRATCH[key] = np.empty(n, dtype)
    return buf[:n]


def _time_grid(key: str, fs: float, n: int) -> np.ndarray:
    """Cached seconds grid (constant across same-length same-rate nights).
    The rate is part of the key: mixed grid/offgrid calls in one process
    could otherwise collide on equal lengths and reuse a wrong-fs grid."""
    key = f'{key}@{fs:g}'
    grid = _SCRATCH.get(key)
    if grid is None or grid.size != n:
        grid = np.arange(n, dtype=np.float32)
        grid /= np.float32(fs)
        _SCRATCH[key] = grid
    return grid


def _blend_toward_mean(table: np.ndarray, overlap: float) -> np.ndarray:
    """Difficulty knob: shrink per-stage physiology toward the across-stage
    mean. ``overlap=0`` keeps the strong default signatures; ``overlap=1``
    makes every stage physiologically identical (chance-level separability).
    Used to build corpora where eval accuracy sits below ceiling so transport
    deltas and model-selection decisions are measured where they can spread."""
    return table * (1.0 - overlap) + table.mean() * overlap


def _flip_labels(
    rng: np.random.Generator, stages: np.ndarray, label_noise: float, n_classes: int
) -> np.ndarray:
    """Difficulty knob: re-score a ``label_noise`` fraction of epochs to a
    uniformly random OTHER stage. Signals stay tied to the true stage, so
    the flips are irreducible label error — val_loss genuinely plateaus at
    the noise entropy instead of falling monotonically to ~0, which is what
    lets early stopping and the plateau LR controller actually fire."""
    if label_noise <= 0.0:
        return stages
    stages = stages.copy()
    flip = np.flatnonzero(rng.random(stages.size) < label_noise)
    offset = rng.integers(1, n_classes, size=flip.size)
    stages[flip] = (stages[flip] + offset) % n_classes
    return stages


def synth_night(
    rng: np.random.Generator,
    hours: float,
    rates: dict | None = None,
    overlap: float = 0.0,
    label_noise: float = 0.0,
) -> tuple[dict, np.ndarray]:
    """Stage-modulated signals (amplitudes in channel-native units).

    ECG: Gaussian R-wave (sigma 20 ms) + negative T-ish deflection on a
    stage-modulated instantaneous heart rate with HRV, 0.1 Hz baseline
    wander, stage-dependent broadband noise and 5-s wake movement artifacts.
    PPG: pulse waves phase-locked to the same heart rate with respiratory
    amplitude modulation. ABD/THX: stage-modulated breathing with REM
    apnea-like dropouts and a fixed thoraco-abdominal phase lag.

    The returned arrays live in a shared scratch pool and are overwritten by
    the next call — consume (write/copy) them before synthesizing again.
    """
    R = RATES if rates is None else rates
    n_epochs = int(hours * 120)
    stages = synth_stages(rng, n_epochs)
    two_pi = np.float32(2 * np.pi)
    s_hr = _blend_toward_mean(STAGE_HR, overlap)
    s_hrv = _blend_toward_mean(STAGE_HRV, overlap)
    s_resp_amp = _blend_toward_mean(STAGE_RESP_AMP, overlap)
    s_resp_hz = _blend_toward_mean(STAGE_RESP_HZ, overlap)
    s_ecg_noise = _blend_toward_mean(STAGE_ECG_NOISE, overlap)

    def per_sample_into(out: np.ndarray, fs: float, values: np.ndarray) -> np.ndarray:
        spe = int(round(fs * 30))
        out.reshape(n_epochs, spe)[:] = values[stages].astype(np.float32)[:, None]
        return out

    # --- ECG ---
    # Samples-per-epoch uses int(round(...)) everywhere so buffer sizes agree
    # with per_sample_into's reshape for arbitrary (non-grid) rates.
    fs_e = R['ECG']
    spe_e = int(round(fs_e * 30))
    n_e = spe_e * n_epochs
    t_e = _time_grid('t_ecg', fs_e, n_e)
    a = _scratch('a', n_e)  # HRV envelope -> instantaneous HR
    b = _scratch('b', n_e)
    np.multiply(t_e, two_pi / np.float32(20.0), out=b)
    np.sin(b, out=b)
    b *= per_sample_into(a, fs_e, s_hrv)
    b += np.float32(1.0)
    b *= per_sample_into(a, fs_e, s_hr)  # b = hr
    phase = np.cumsum(b, dtype=np.float64, out=_scratch('phase64', n_e, np.float64))
    phase /= fs_e
    np.mod(phase, 1.0, out=phase)
    frac = _scratch('frac', n_e)
    frac[:] = phase  # f64 beat phase -> f32 (cumsum in f64: f32 drifts ~0.3 beats)
    ecg = _scratch('out_ecg', n_e)
    np.subtract(frac, np.float32(0.5), out=ecg)  # R wave
    ecg /= np.float32(0.02)
    np.square(ecg, out=ecg)
    ecg *= np.float32(-0.5)
    np.exp(ecg, out=ecg)
    ecg *= np.float32(800.0)
    np.subtract(frac, np.float32(0.56), out=b)  # T-ish deflection
    b /= np.float32(0.05)
    np.square(b, out=b)
    b *= np.float32(-0.5)
    np.exp(b, out=b)
    b *= np.float32(120.0)
    ecg -= b
    np.multiply(t_e, two_pi * np.float32(0.1), out=b)  # baseline wander
    np.sin(b, out=b)
    b *= np.float32(60.0)
    ecg += b
    rng.standard_normal(out=b, dtype=np.float32)
    b *= per_sample_into(a, fs_e, s_ecg_noise)
    ecg += b
    for ep in np.flatnonzero(stages == 0)[:: max(1, n_epochs // 40)]:  # wake artifacts
        s = int(ep) * spe_e
        ecg[s : s + int(fs_e * 5)] *= np.float32(5.0)

    # --- PPG (pulse phase from the same stagewise HR law, on its own grid) ---
    fs_p = R['Pleth']
    n_p = int(round(fs_p * 30)) * n_epochs
    t_p = _time_grid('t_ppg', fs_p, n_p)
    ap = _scratch('ap', n_p)
    bp = _scratch('bp', n_p)
    np.multiply(t_p, two_pi / np.float32(20.0), out=bp)
    np.sin(bp, out=bp)
    bp *= per_sample_into(ap, fs_p, s_hrv)
    bp += np.float32(1.0)
    bp *= per_sample_into(ap, fs_p, s_hr)  # bp = hr on the ppg grid
    pphase = np.cumsum(bp, dtype=np.float64, out=_scratch('pphase64', n_p, np.float64))
    pphase /= fs_p
    np.mod(pphase, 1.0, out=pphase)
    ppg = _scratch('out_ppg', n_p)
    ppg[:] = pphase
    ppg *= two_pi
    np.cos(ppg, out=ppg)
    ppg += np.float32(1.0)
    ppg *= np.float32(0.4)
    np.multiply(t_p, two_pi * np.float32(0.25), out=bp)  # respiratory AM
    np.sin(bp, out=bp)
    bp *= np.float32(0.15)
    bp += np.float32(1.0)
    ppg *= bp
    rng.standard_normal(out=bp, dtype=np.float32)
    bp *= np.float32(0.02)
    ppg += bp

    # --- Respiration (small arrays; same in-place discipline) ---
    fs_r = R['ABDO RES']
    spe_r = int(round(fs_r * 30))
    n_r = spe_r * n_epochs
    amp = _scratch('amp', n_r)
    per_sample_into(amp, fs_r, s_resp_amp)
    for ep in np.flatnonzero(stages == 3)[:: max(1, n_epochs // 60)]:  # REM apneas
        s = int(ep) * spe_r
        amp[s : s + int(fs_r * 20)] = np.float32(0.05)
    hz = _scratch('hz', n_r)
    per_sample_into(hz, fs_r, s_resp_hz)
    rphase = np.cumsum(hz, dtype=np.float64, out=_scratch('rphase64', n_r, np.float64))
    rphase *= 2 * np.pi / fs_r
    abd = _scratch('out_abd', n_r)
    thx = _scratch('out_thx', n_r)
    abd[:] = rphase
    np.sin(abd, out=abd)
    abd *= amp
    thx[:] = rphase
    thx += np.float32(0.6)
    np.sin(thx, out=thx)
    thx *= amp
    rng.standard_normal(out=hz, dtype=np.float32)
    hz *= np.float32(0.02)
    abd += hz
    rng.standard_normal(out=hz, dtype=np.float32)
    hz *= np.float32(0.02)
    thx += hz

    signals = {'ECG': ecg, 'Pleth': ppg, 'ABDO RES': abd, 'THOR RES': thx}
    return signals, _flip_labels(rng, stages, label_noise, n_classes=4)


# Per-stage EOG physiology (Wake / N1 / N2 / N3 / REM), amplitudes in uV.
# Wake: blink spikes + high broadband noise; N1: slow rolling eye movements
# (anti-phase L/R); N2: quiescent; N3: high-amplitude delta bleed (common-
# mode, in-phase on both channels); REM: bursts of sharp saccades
# (anti-phase). Strong signatures on purpose, like the cardio tables above.
EOG_SLOW_AMP = np.array([5.0, 60.0, 8.0, 10.0, 15.0])
EOG_SLOW_HZ = np.array([0.5, 0.30, 0.2, 0.2, 0.4])
EOG_DELTA_AMP = np.array([4.0, 10.0, 25.0, 90.0, 6.0])
EOG_NOISE = np.array([18.0, 9.0, 7.0, 8.0, 10.0])


def synth_night_eog(
    rng: np.random.Generator,
    hours: float,
    rates: dict | None = None,
    overlap: float = 0.0,
    label_noise: float = 0.0,
) -> tuple[dict, np.ndarray]:
    """Stage-modulated EOG-L/EOG-R pair; returns ({channel: uV}, stages 0-4).

    Same scratch-pool discipline as ``synth_night`` (arrays are overwritten
    by the next call). The two channels share conjugate eye-movement
    components: slow rolling movements and REM saccades are ANTI-phase
    (horizontal gaze moves the eyes together, which flips polarity across
    the L/R referential pair) while delta/EEG bleed and blinks ride
    IN-phase — the cross-channel structure a 2-channel EOG model learns.
    """
    R = RATES_EOG if rates is None else rates
    n_epochs = int(hours * 120)
    # 5-class stage sequence with the same ~20-epoch dwell law.
    stages = []
    while len(stages) < n_epochs:
        stage = int(rng.integers(0, 5))
        stages.extend([stage] * int(rng.geometric(1 / 20.0)))
    stages = np.asarray(stages[:n_epochs], np.int32)
    two_pi = np.float32(2 * np.pi)

    fs = R['EOG(L)']
    spe = int(round(fs * 30))
    n = spe * n_epochs
    t = _time_grid('t_eog', fs, n)

    def per_sample_into(out: np.ndarray, values: np.ndarray) -> np.ndarray:
        out.reshape(n_epochs, spe)[:] = values[stages].astype(np.float32)[:, None]
        return out

    e_slow_amp = _blend_toward_mean(EOG_SLOW_AMP, overlap).astype(np.float32)
    e_slow_hz = _blend_toward_mean(EOG_SLOW_HZ, overlap).astype(np.float32)
    e_delta_amp = _blend_toward_mean(EOG_DELTA_AMP, overlap).astype(np.float32)
    e_noise = _blend_toward_mean(EOG_NOISE, overlap).astype(np.float32)

    a = _scratch('eog_a', n)
    b = _scratch('eog_b', n)
    # Slow rolling eye movements: stage-modulated rate + amplitude.
    per_sample_into(b, e_slow_hz)
    phase = np.cumsum(b, dtype=np.float64, out=_scratch('eog_phase64', n, np.float64))
    phase *= 2 * np.pi / fs
    slow = _scratch('eog_slow', n)
    slow[:] = phase
    np.sin(slow, out=slow)
    slow *= per_sample_into(a, e_slow_amp)
    # Common-mode delta/EEG bleed at ~1.2 Hz.
    delta = _scratch('eog_delta', n)
    np.multiply(t, two_pi * np.float32(1.2), out=delta)
    np.sin(delta, out=delta)
    delta *= per_sample_into(a, e_delta_amp)

    eog_l = _scratch('out_eog_l', n)
    eog_r = _scratch('out_eog_r', n)
    np.add(delta, slow, out=eog_l)
    np.multiply(slow, np.float32(-0.9), out=slow)  # anti-phase on R
    np.add(delta, slow, out=eog_r)
    # Per-channel broadband noise.
    rng.standard_normal(out=b, dtype=np.float32)
    b *= per_sample_into(a, e_noise)
    eog_l += b
    rng.standard_normal(out=b, dtype=np.float32)
    b *= per_sample_into(a, e_noise)
    eog_r += b
    # REM saccade bursts (anti-phase square deflections, ~0.4 s each).
    sac = int(fs * 0.4)
    for ep in np.flatnonzero(stages == 4)[:: max(1, n_epochs // 80)]:
        s = int(ep) * spe
        for k in range(3):
            o = s + k * 2 * sac
            amp = np.float32(150.0 if k % 2 == 0 else -150.0)
            eog_l[o : o + sac] += amp
            eog_r[o : o + sac] -= amp * np.float32(0.9)
    # Wake blinks (in-phase positive spikes, ~0.3 s).
    blink = int(fs * 0.3)
    for ep in np.flatnonzero(stages == 0)[:: max(1, n_epochs // 80)]:
        s = int(ep) * spe
        eog_l[s : s + blink] += np.float32(120.0)
        eog_r[s : s + blink] += np.float32(110.0)
    return {'EOG(L)': eog_l, 'EOG(R)': eog_r}, _flip_labels(rng, stages, label_noise, n_classes=5)


def write_night_edf(fp: str, signals: dict, rates: dict | None = None, start=None) -> None:
    if rates is None:
        rates = RATES_EOG if 'EOG(L)' in signals else RATES
    write_edf(
        fp,
        signals=signals,
        sampling_freqs=rates,
        units={'ECG': 'uV', 'EOG(L)': 'uV', 'EOG(R)': 'uV'},
        physical_ranges={
            'ECG': (-6000, 6000),
            'Pleth': (-1, 1),
            'ABDO RES': (-1, 1),
            'THOR RES': (-1, 1),
            'EOG(L)': (-500, 500),
            'EOG(R)': (-500, 500),
        },
        record_duration=30.0,
        start=start or datetime.datetime(2002, 3, 1, 22, 0, 0),
    )


def write_nights(
    folder: str,
    n_nights: int,
    hours: float,
    seed: int,
    rates: dict | None = None,
    kind: str = 'cardio',
    overlap: float = 0.0,
    label_noise: float = 0.0,
):
    """N distinct realistic-morphology EDF nights; returns (paths, labels).

    ``kind='cardio'`` (default): ECG/PPG/ABD/THX with 4-class stages;
    ``kind='eog'``: EOG-L/EOG-R with 5-class stages (the wav2sleep-eog
    released-variant geometry).
    ``overlap``/``label_noise`` are the corpus difficulty knobs
    (``_blend_toward_mean`` / ``_flip_labels``); 0 keeps the easy default.
    """
    gen = {'cardio': synth_night, 'eog': synth_night_eog}[kind]
    rng = np.random.default_rng(seed)
    fps, labels = [], []
    for i in range(n_nights):
        signals, stages = gen(rng, hours, rates, overlap=overlap, label_noise=label_noise)
        fp = os.path.join(folder, f'night{i:03d}.edf')
        write_night_edf(fp, signals, rates)
        fps.append(fp)
        labels.append(stages)
    return fps, np.stack(labels)
