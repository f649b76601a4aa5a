"""Signal names, sampling geometry and causal-normalization constants.

The port's own copy of the values it uses from ``wav2sleep_tpu/settings.py``
(the two must agree; ``tests/test_torch_imports.py`` checks that they do).
"""

# Signal (column) names.
PPG = 'PPG'
ECG = 'ECG'
ABD = 'ABD'
THX = 'THX'
EOG_L = 'EOG-L'
EOG_R = 'EOG-R'

EPOCH_SECONDS = 30.0

# Samples per 30-second sleep epoch on each signal's model grid.
LOW_FREQ_SAMPLES_PER_EPOCH = 256
MEDIUM_FREQ_SAMPLES_PER_EPOCH = 1024
HIGH_FREQ_SAMPLES_PER_EPOCH = 4096
COLS_TO_SAMPLES_PER_EPOCH = {
    ABD: LOW_FREQ_SAMPLES_PER_EPOCH,
    THX: LOW_FREQ_SAMPLES_PER_EPOCH,
    ECG: MEDIUM_FREQ_SAMPLES_PER_EPOCH,
    PPG: MEDIUM_FREQ_SAMPLES_PER_EPOCH,
    EOG_L: HIGH_FREQ_SAMPLES_PER_EPOCH,
    EOG_R: HIGH_FREQ_SAMPLES_PER_EPOCH,
}

# Causal (online EMA) normalization.
CAUSAL_NORM_TAU_SECONDS = 900.0  # variance-tracking time constant (15 min)
NORM_OUTLIER_THRESHOLD = 4.0  # sigma threshold for residual clipping
CAUSAL_NORM_BASELINE_TAU_SECONDS = 120.0  # baseline (mean) tracking time constant
CAUSAL_NORM_MIN_SIGMA = 0.1  # sigma floor against near-zero variance
