"""Signal and label names, sampling geometry, causal-normalization constants,
dataset names and label maps.

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
LABEL = 'Stage'

# Columns of the prediction CSVs.
TIMESTAMP = 'Timestamp'
PRED = 'Pred'

# Recording length in hours during training. One night = 1,200 sleep epochs of 30 s.
TRAINING_LENGTH_HOURS = 10
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

# PSG datasets.
SHHS = 'shhs'
MESA = 'mesa'
CFS = 'cfs'
CHAT = 'chat'
CCSHS = 'ccshs'
MROS = 'mros'
WSC = 'wsc'
CENSUS = 'census'  # census-balanced benchmark split (Jones et al.)

TRAIN, VAL, TEST = 'train', 'val', 'test'

# Five-class sleep stages to integer labels, per number of classes; four
# classes merge N1 and N2 into light sleep.
INTEGER_LABEL_MAPS = {
    4: {0: 0, 1: 1, 2: 1, 3: 2, 4: 3},
    5: {0: 0, 1: 1, 2: 2, 3: 3, 4: 4},
}

# Label of unscored or ignored epochs.
IGNORE_LABEL = -1
