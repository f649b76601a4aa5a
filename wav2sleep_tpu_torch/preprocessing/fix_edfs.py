"""Repair EDFs whose signal headers carry a physical maximum of 0.0.

Some CHAT channels (CHIN, SNORE 2, ECG, ...) have physical_max 0.0, which
breaks range-based readers. A copy of the file is patched in its signal
header: the unit field of each such channel is set to ``BROKEN`` (so readers
skip the channel) and its physical range to +/-3.28; the copy is kept as
``*_fixed.edf`` if its header then reads.

    python -m wav2sleep_tpu_torch.preprocessing.fix_edfs --folder DATASET [--overwrite]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from glob import glob

from ..data.edf import read_edf_header

HEADER_BYTES = 256


def _scan_broken_signals(filename: str) -> dict[str, tuple[int, int, int]]:
    """Broken channel label -> byte offsets of its (unit, phys_min, phys_max)."""
    with open(filename, 'rb') as f:
        f.seek(252)
        nsigs = int(f.read(4).decode())
        labels = [f.read(16).decode() for _ in range(nsigs)]
        # Field layout per signal block: label 16, transducer 80, unit 8,
        # phys_min 8, phys_max 8, ...
        pmax_start = HEADER_BYTES + (16 + 80 + 8 + 8) * nsigs
        f.seek(pmax_start)
        fix_map: dict[str, tuple[int, int, int]] = {}
        for i in range(nsigs):
            pos = f.tell()
            pmax_val = f.read(8).decode()
            try:
                broken = float(pmax_val) == 0.0
            except ValueError:
                broken = False
            if broken:
                pos_unit = pos - 16 * nsigs  # the unit field is (8 + 8) * nsigs bytes earlier
                pos_min = pos - 8 * nsigs
                fix_map[labels[i]] = (pos_unit, pos_min, pos)
    return fix_map


def _patch_header(filename: str, fix_map: dict[str, tuple[int, int, int]], fill_val: float = 3.28) -> None:
    with open(filename, 'rb+') as f:
        for _label, (pos_unit, pos_min, pos_max) in fix_map.items():
            f.seek(pos_unit)
            f.write('BROKEN'.ljust(8).encode())
            f.seek(pos_min)
            f.write(f'{-fill_val:.2f}'.ljust(8).encode())
            f.seek(pos_max)
            f.write(f'{fill_val:.2f}'.ljust(8).encode())


def _try_read(fp: str) -> bool:
    try:
        return read_edf_header(fp).n_records > 0
    except (ValueError, OSError) as e:
        print(f'Failed to read {fp} due to {e}')
        return False


def triage_edf_fp(filename: str, overwrite: bool = False) -> bool:
    """Write ``*_fixed.edf`` beside ``filename`` when it has broken channels;
    True if a fixed copy was written."""
    fixed_filename = filename.replace('.edf', '_fixed.edf')
    if os.path.exists(fixed_filename) and not overwrite:
        return False
    fix_map = _scan_broken_signals(filename)
    if not fix_map:
        return False
    with tempfile.NamedTemporaryFile() as tmp_file:
        shutil.copyfile(filename, tmp_file.name)
        _patch_header(tmp_file.name, fix_map)
        if _try_read(tmp_file.name):
            shutil.copyfile(tmp_file.name, fixed_filename)
            return True
    return False


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog='Fix EDFs', description='Repair EDFs with broken physical ranges.')
    parser.add_argument('--folder', required=True, help='Dataset location (e.g. CHAT).')
    parser.add_argument('--overwrite', action='store_true', default=False)
    args = parser.parse_args(argv)
    edf_fps = [fp for fp in glob(f'{args.folder}/**/*.edf', recursive=True) if not fp.endswith('_fixed.edf')]
    print(f'Found {len(edf_fps)} EDF files.')
    fixed = sum(triage_edf_fp(fp, overwrite=args.overwrite) for fp in edf_fps)
    print(f'Fixed {fixed} EDF files.')


if __name__ == '__main__':
    main()
