"""Sleep-stage codes of the annotation formats onto the five-class labels.

The port's copy of the label half of ``wav2sleep_tpu/data/utils.py``. Its
parquet helpers are in ``parquet.py``; its pandas resampler
``interpolate_index`` has no caller in the port and is not carried.
"""

from __future__ import annotations

import numpy as np


def convert_int_stage(stage: int | str):
    """An NSRR or WSC integer stage as a five-class label: N4 (4) -> N3 (3),
    REM (5) -> 4, movement (6, 7) and unscored (9) -> NaN; any other code
    raises ``ValueError``."""
    stage = int(stage)
    if stage not in [0, 1, 2, 3, 4, 5, 6, 7, 9]:
        raise ValueError(f'{stage} not a valid sleep stage.')
    if stage == 4:
        return 3
    if stage == 5:
        return 4
    if stage in [6, 7, 9]:
        return np.nan
    return stage


def convert_str_stage(stage: str):
    """A textual stage annotation ('STAGE - N2', ...) as a five-class label;
    None for no stage, movement and non-stage text; an unknown stage raises
    ``ValueError``."""
    if 'STAGE' not in stage:
        return None
    if 'NO STAGE' in stage:
        return None
    elif 'W' in stage:
        return 0
    elif 'N1' in stage:
        return 1
    elif 'N2' in stage:
        return 2
    elif 'N3' in stage:
        return 3
    elif 'R' in stage:
        return 4
    elif 'MVT' in stage:
        return None
    else:
        raise ValueError(f'Encountered unseen value: {stage=}')
