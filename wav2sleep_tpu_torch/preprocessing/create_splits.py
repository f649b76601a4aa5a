"""Split one dataset's ingested parquet into train, val and test by the
split lists (``data/splits``).

    python -m wav2sleep_tpu_torch.preprocessing.create_splits --folder /data/processed/mesa \\
        [--output-folder OUT] [--copy]

Files are symlinked (copied with ``--copy``) from ``<folder>/ingest`` into
``<output>/{train,val,test}``; sessions in no list are skipped (scoring
issues and the like).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from glob import glob

from ..data.nsrr import get_split
from ..settings import INGEST, TEST, TRAIN, VAL

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog='Dataset Splitter')
    parser.add_argument('--folder', required=True, help='Dataset location (contains ingest/).')
    parser.add_argument('--output-folder', default=None, help='Defaults to the dataset folder.')
    parser.add_argument('--copy', action='store_true', default=False, help='Copy instead of symlink.')
    args = parser.parse_args(argv)

    fps = glob(f'{args.folder}/{INGEST}/*.parquet')
    dataset = args.folder.rstrip('/').split('/')[-1]
    print(f'Found {len(fps)} files in {args.folder}/{INGEST}. Splitting into train, val, test sets...')
    splits = {s: set(get_split(dataset, s)) for s in (TRAIN, VAL, TEST)}
    output_folder = args.output_folder or args.folder
    counts = {TRAIN: 0, VAL: 0, TEST: 0}
    for fp in fps:
        session_id = os.path.basename(fp).replace('.parquet', '').replace('.issues', '')
        for split in (TRAIN, VAL, TEST):
            if session_id in splits[split]:
                o_fp = os.path.join(output_folder, split, os.path.basename(fp))
                os.makedirs(os.path.dirname(o_fp), exist_ok=True)
                # A dangling symlink (ingest moved since the last run) is
                # replaced, not re-linked over.
                if os.path.lexists(o_fp) and not os.path.exists(o_fp):
                    os.unlink(o_fp)
                if not os.path.lexists(o_fp):
                    if args.copy:
                        shutil.copy2(fp, o_fp)
                    else:
                        os.symlink(os.path.abspath(fp), o_fp)
                    counts[split] += 1  # creations: a rerun over a split tree reports 0
                break
        else:
            logger.debug(f'Session {session_id} not found in train/val/test sets.')
    print(f'Created {counts[TRAIN]} train, {counts[VAL]} val, {counts[TEST]} test files.')


if __name__ == '__main__':
    main()
