"""NSRR XML sleep-stage annotations.

The port's copy of ``wav2sleep_tpu/data/xml.py``, without pandas: the scored
stage events are read with the same two patterns, expanded into 30 s epochs
and returned as ``(seconds, stages)`` arrays with each label at the end of
the 30 s it describes.
"""

from __future__ import annotations

import re

import numpy as np

from .utils import convert_int_stage

_STAGE_EVENT_RE = re.compile(
    r'<EventType>Stages.Stages</EventType>\n'
    r'<EventConcept>(?P<concept>.+)</EventConcept>\n'
    r'<Start>(?P<start>.+)</Start>\n'
    r'<Duration>(?P<duration>.+)</Duration>\n'
    r'</ScoredEvent>'
)
_START_RE = re.compile(r'<EventConcept>Recording Start Time</EventConcept>\n<Start>0</Start>')


def parse_xml_annotations(filepath: str) -> tuple[np.ndarray, np.ndarray]:
    """``(seconds, stages)`` of an NSRR annotations XML, float64, stages NaN
    where unscored. Raises ``ValueError`` for no or several start times, a
    first stage not at 0 s, a duration that is not a multiple of 30 s and an
    invalid stage code."""
    with open(filepath) as f:
        content = f.read()
    n_starts = len(_START_RE.findall(content))
    if n_starts == 0:
        raise ValueError(f'{filepath=} had no start time.')
    if n_starts > 1:
        raise ValueError(f'{filepath=} had multiple start times.')
    return create_sleep_series(_STAGE_EVENT_RE.finditer(content))


def create_sleep_series(events) -> tuple[np.ndarray, np.ndarray]:
    """Stage events (concept, start, duration) expanded into 30 s epochs,
    each labelled at its end (+30 s) and sorted by time."""
    stages: list[float] = []
    for ind, m in enumerate(events):
        # NSRR stage concepts end '...|<digit>'; the digit is the stage code.
        stage = convert_int_stage(m.group('concept').rsplit('|', 1)[-1])
        start = float(m.group('start'))
        if ind == 0 and start != 0.0:
            raise ValueError(f'First stage did not start at 0.0s: {start}')
        duration = float(m.group('duration'))
        if duration % 30 != 0.0:
            raise ValueError(f'Non-30s epoch duration: {duration}')
        stages += [stage] * (int(duration) // 30)
    seconds = np.arange(0, 30 * len(stages), 30.0) + 30  # a label describes the preceding 30 s
    values = np.asarray(stages, dtype=np.float64)
    order = np.argsort(seconds, kind='stable')
    return seconds[order], values[order]
