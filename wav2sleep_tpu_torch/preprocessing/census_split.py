"""Assemble the census-balanced val and test benchmark (Jones et al.).

    python -m wav2sleep_tpu_torch.preprocessing.census_split --folder /data/processed [--copy]

Collects the census sessions from every dataset's ingest folder into
``<folder>/census/{val,test}``, fails if any session is missing, and takes
``.issues`` out of the names so evaluation does not skip them.
"""

from __future__ import annotations

import argparse
import os
import shutil
from glob import glob

from ..data.nsrr import get_split
from ..settings import CENSUS, INGEST, TEST, VAL


def build_set(folder: str, split: str, all_parquet_fps: list[str], copy: bool = False) -> None:
    """Link (or copy) the census ``split``'s sessions into
    ``<folder>/census/<split>``; raises ``ValueError`` when one is missing."""
    if split not in (VAL, TEST):
        raise ValueError(f'Split must be either {VAL} or {TEST}')
    session_ids = get_split(CENSUS, split)
    found = {}
    for fp in all_parquet_fps:
        session_id = os.path.basename(fp).replace('.parquet', '').replace('.issues', '')
        if session_id in session_ids:
            found[session_id] = fp
    if len(found) != len(session_ids):
        missing = set(session_ids).difference(found)
        print(len(missing), missing)
        raise ValueError(f'Found {len(found)} files, but expected {len(session_ids)}')
    print(f'Found all {len(found)} files necessary for {split} split. Linking...')
    for _session_id, fp in found.items():
        o_fp = os.path.join(folder, CENSUS, split, os.path.basename(fp).replace('.issues', ''))
        os.makedirs(os.path.dirname(o_fp), exist_ok=True)
        if os.path.exists(o_fp):
            continue
        if copy:
            shutil.copy2(fp, o_fp)
        else:
            os.symlink(os.path.abspath(fp), o_fp)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog='Census Split Builder')
    parser.add_argument('--folder', required=True, help='Location of processed NSRR datasets.')
    parser.add_argument('--copy', action='store_true', default=False)
    args = parser.parse_args(argv)
    print('Globbing all ingested files...')
    all_parquet_fps = glob(f'{args.folder}/*/{INGEST}/*.parquet')
    print('Found', len(all_parquet_fps), 'files.')
    build_set(args.folder, VAL, all_parquet_fps, copy=args.copy)
    build_set(args.folder, TEST, all_parquet_fps, copy=args.copy)


if __name__ == '__main__':
    main()
