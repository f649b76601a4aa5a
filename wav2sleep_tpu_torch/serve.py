"""Serving CLI: a folder of EDF recordings -> one hypnogram CSV per night.

    python -m wav2sleep_tpu_torch.serve --input-folder EDFS --output-folder OUT --model-folder CKPT

The port's counterpart of ``scripts/serve.py``, with the same flags and
output, on the card (``--device cpu`` runs it on the CPU instead). It loads
the model from a checkpoint folder (``api.load_model``) and streams the
nights through one of the serving pipelines, chosen by ``--transport``:

  q16  lossless int16 digital codes on the model grid (the default; within
       0.5 LSB, the EDF's own quantization)
  q8   mu-law int8 codes (half q16's bytes, a small accuracy tax)
  q4   packed 4-bit block-DPCM codes (for links that bytes bound; its
       hypnogram flips are not confined to near-tie epochs)
  raw  the EDF's int16 channels, resampled on the device
  f32  f32 rows decoded and resampled on the host

``--data-parallel N`` serves each batch over replicas on ``cuda:0..N-1``
(q16, q8 and q4; ``--device cpu`` puts the N replicas on the CPU), as the
JAX script shards it over a mesh of N devices.

Each night gets ``<name>.preds.csv`` (columns ``Timestamp,Pred``): one row
per 30-second epoch, timestamped from the EDF's start at the epoch's end,
or in seconds (``30.0, 60.0, ...``) when the start cannot be read.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import time

import numpy as np

from .api import PRECISIONS, check_local, load_model, write_predictions_csv
from .checkpoint import read_config
from .data.edf import get_edf_start
from .data.frame import datetime_to_ns, format_stamps, seconds_to_ns
from .instantiate import model_family, wav2sleep_arguments
from .parallel import mesh as pmesh
from .pipeline import (
    StreamingPipeline,
    StreamingPipelineQ4,
    StreamingPipelineQ8,
    StreamingPipelineQ16,
    StreamingPipelineRaw,
)
from .settings import EPOCH_SECONDS
from .utils import resolve_device

logger = logging.getLogger('serve')

PIPELINES = {
    'q16': StreamingPipelineQ16,
    'q8': StreamingPipelineQ8,
    'q4': StreamingPipelineQ4,
    'raw': StreamingPipelineRaw,
    'f32': StreamingPipeline,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Stream EDF recordings through the card to hypnogram CSVs.')
    parser.add_argument('--input-folder', required=True, help='Folder of EDF recordings.')
    parser.add_argument('--output-folder', required=True, help='Where .preds.csv files are written.')
    parser.add_argument(
        '--model-folder',
        default='hf://joncarter/wav2sleep',
        help='Checkpoint folder (config.yaml + state_dict.pth or params.npz). hf:// URIs are not '
        'downloaded: pass a local copy.',
    )
    parser.add_argument('--signals', default=None, help='Comma-separated subset of the model signals.')
    parser.add_argument(
        '--transport',
        default='q16',
        choices=list(PIPELINES),
        help='Host->device input encoding. q16 (default) is lossless to 0.5 LSB of the EDF\'s own '
        'quantization; q8 (mu-law int8) halves the bytes again with a small accuracy tax; q4 (packed '
        '4-bit block-DPCM) is for link-bound deployments only: its hypnogram flips are not confined '
        'to near-tie epochs.',
    )
    parser.add_argument('--precision', default='bfloat16', choices=list(PRECISIONS))
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--max-length-hours', type=float, default=10.0)
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--device', default=None, help='torch device (default: cuda; raises without a card).')
    parser.add_argument(
        '--data-parallel',
        type=int,
        default=0,
        help='Shard each batch over this many devices (0 = single device).',
    )
    return parser


def write_predictions(out_fp: str, hyp: np.ndarray, start: datetime.datetime | None) -> None:
    """``<name>.preds.csv`` as ``pandas.DataFrame.to_csv`` writes it: a
    ``Timestamp`` index of epoch ends (``start`` + 30 s x (k + 1), or the
    seconds as floats when ``start`` is None) and the ``Pred`` column."""
    ends = EPOCH_SECONDS * np.arange(1, len(hyp) + 1)
    if start is None:
        stamps = [repr(t) for t in ends.tolist()]
    else:
        stamps = format_stamps(datetime_to_ns(start) + seconds_to_ns(ends))
    write_predictions_csv(out_fp, stamps, np.asarray(hyp))


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    n = args.data_parallel
    devices = pmesh.devices_for(n, device, f'--data-parallel {n}') if n else None
    if devices is not None and args.transport not in ('q8', 'q16', 'q4'):
        raise SystemExit('--data-parallel requires --transport q8, q16 or q4')
    try:
        check_local(args.model_folder)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    cfg = read_config(args.model_folder)
    if model_family(cfg) == 'ppgnet':
        raise SystemExit(
            'The streaming transports drive the multi-modal wav2sleep family; '
            'SleepPPG-Net checkpoints are not served by the port yet.'
        )
    valid = list(wav2sleep_arguments(cfg)['signal_map'])
    signals = args.signals.split(',') if args.signals else valid
    invalid = set(signals) - set(valid)
    if invalid:
        raise SystemExit(f'Signals {sorted(invalid)} not supported by this model ({valid}).')

    def out_path(fp: str) -> str:
        rel = os.path.relpath(fp, args.input_folder)
        return os.path.join(args.output_folder, os.path.splitext(rel)[0] + '.preds.csv')

    fps = sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(args.input_folder)
        for f in files
        if f.lower().endswith('.edf')
    )
    if not fps:
        raise SystemExit(f'No EDF files under {args.input_folder}')
    if not args.overwrite:
        # Skip nights whose output exists before any work on the card.
        skipped = [fp for fp in fps if os.path.exists(out_path(fp))]
        for fp in skipped:
            logger.warning(f'File {out_path(fp)} exists. Skipping.')
        fps = [fp for fp in fps if fp not in set(skipped)]
        if not fps:
            logger.info('Nothing to do.')
            return
    logger.info(f'Serving {len(fps)} recordings with transport={args.transport} signals={signals}')

    # precision reaches load_model: with bfloat16 the parameters are cast
    # too, as in the JAX package's serving.
    model = load_model(args.model_folder, precision=args.precision, device=device)
    pipe = PIPELINES[args.transport](
        model, list(signals), batch_size=args.batch_size, max_length_hours=args.max_length_hours,
        precision=args.precision, device=device, **({'devices': devices} if devices is not None else {}),
    )
    os.makedirs(args.output_folder, exist_ok=True)
    t0 = time.time()
    n = 0
    for fp, hyp in pipe.run(fps):
        out_fp = out_path(fp)
        os.makedirs(os.path.dirname(out_fp), exist_ok=True)
        try:
            start = get_edf_start(fp)
        except (OSError, ValueError):
            start = None
        write_predictions(out_fp, hyp, start)
        n += 1
    elapsed = time.time() - t0
    logger.info(f'{n} recordings in {elapsed:.1f} s ({n / max(elapsed, 1e-9) * 3600:.0f}/hour) on {device}')


if __name__ == '__main__':
    main()
