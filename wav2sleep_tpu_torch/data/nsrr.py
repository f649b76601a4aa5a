"""NSRR dataset split lists.

The port's copy of ``wav2sleep_tpu/data/nsrr.py``. The session-ID lists of
each dataset's train, val and test splits (16,368 IDs) live in the port's
own ``splits/<dataset>/<split>.txt``, byte for byte the JAX package's; the
``WAV2SLEEP_SPLITS`` environment variable names a folder that takes
precedence. ``import_splits`` copies lists from another installation into
the port's folder.
"""

from __future__ import annotations

import logging
import os
import shutil

from ..settings import KNOWN_DATASETS

logger = logging.getLogger(__name__)

_LOCAL_SPLITS = os.path.join(os.path.dirname(__file__), 'splits')


def splits_roots() -> list[str]:
    """The folders searched for split lists, in order."""
    env = os.environ.get('WAV2SLEEP_SPLITS')
    return ([env] if env else []) + [_LOCAL_SPLITS]


def get_split(dataset: str, split: str) -> list[str]:
    """Session IDs for (dataset, split); empty list when no list exists."""
    for root in splits_roots():
        fp = os.path.join(root, dataset, f'{split}.txt')
        if os.path.exists(fp):
            with open(fp, 'r') as f:
                return [line.strip() for line in f if line.strip()]
    logger.info(f"Couldn't find a split list for {dataset=}, {split=}")
    return []


def import_splits(source_dir: str, overwrite: bool = False) -> int:
    """Copy the ``<dataset>/<split>.txt`` lists under ``source_dir`` into the
    port's splits folder, keeping existing files unless ``overwrite``.
    Returns the number of files copied."""
    count = 0
    for ds in os.listdir(source_dir):
        src_ds = os.path.join(source_dir, ds)
        if not os.path.isdir(src_ds):
            continue
        for fn in os.listdir(src_ds):
            if not fn.endswith('.txt'):
                continue
            dst_ds = os.path.join(_LOCAL_SPLITS, ds)
            os.makedirs(dst_ds, exist_ok=True)
            dst = os.path.join(dst_ds, fn)
            if os.path.exists(dst) and not overwrite:
                continue
            shutil.copyfile(os.path.join(src_ds, fn), dst)
            count += 1
    return count


def get_dataset(fp: str) -> str:
    """The dataset whose name occurs first (in ``KNOWN_DATASETS`` order) in
    ``fp``; raises ``ValueError`` when none does."""
    for ds in KNOWN_DATASETS:
        if ds in fp:
            return ds
    raise ValueError(f"Couldn't determine source dataset of {fp=}")
