"""Inference CLI: a folder of EDF/CSV/parquet nights -> hypnogram CSVs.

    python -m wav2sleep_tpu_torch.cli.predict --input-folder IN --output-folder OUT --model-folder CKPT

The port's counterpart of the JAX package's ``scripts/predict.py``
(``wav2sleep_tpu.cli.predict``), with the same flags: preprocessing and
batched inference on the card (``--device cpu`` for the CPU) through
``api.predict_on_folder``, one ``.preds.csv`` per night, and Cohen's kappa
and accuracy when the nights carry labels. The default ``--model-folder``
is a Hugging Face Hub URI, which the port refuses: pass a local folder.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger('predict')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Run wav2sleep-tpu inference on a folder of recordings.')
    parser.add_argument('--input-folder', required=True, help='Folder of EDF/CSV/parquet recordings.')
    parser.add_argument('--output-folder', required=True, help='Where .preds.csv files are written.')
    parser.add_argument(
        '--model-folder',
        default='hf://joncarter/wav2sleep',
        help='Checkpoint folder (hf:// URIs are refused: pass a local copy of the released model).',
    )
    parser.add_argument('--signals', default=None, help='Comma-separated subset of the model signals, e.g. ECG,THX.')
    parser.add_argument('--no-preprocess', action='store_true', help='Input folder is already model-ready parquet.')
    parser.add_argument('--max-length-hours', type=int, default=10)
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--compile', action='store_true', help='Accepted and ignored.')
    parser.add_argument('--precision', default='float32', choices=['float32', 'bfloat16'])
    parser.add_argument('--batch-size', type=int, default=4)
    parser.add_argument('--num-workers', type=int, default=4)
    parser.add_argument('--device', default='auto', help="torch device ('auto': the card; raises without one).")
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from .. import api
    from ..stats import cohens_kappa, confusion_accuracy
    from ..train.metrics import confusion_matrix

    signals = args.signals.split(',') if args.signals else None
    preds, labels = api.predict_on_folder(
        input_folder=args.input_folder,
        output_folder=args.output_folder,
        model_folder=args.model_folder,
        signals=signals,
        device=args.device,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        preprocess=not args.no_preprocess,
        max_length_hours=args.max_length_hours,
        overwrite=args.overwrite,
        compile=args.compile,
        precision=args.precision,
        return_tensors=True,
    )
    logger.info(f'Wrote predictions for {len(preds)} nights to {args.output_folder}')
    if labels is not None:
        # The matrix covers the labels' classes too, not only the predicted
        # ones: a class never predicted must keep its labeled epochs.
        num_classes = 1 + max(
            max(int(np.max(p)) for p in preds),
            max(int(np.max(y)) for y in labels),
        )
        num_classes = max(num_classes, 4)
        cmat = np.zeros((num_classes, num_classes), np.int64)
        for p, y in zip(preds, labels):
            cmat += confusion_matrix(torch.from_numpy(p), torch.from_numpy(y), num_classes, from_logits=False).numpy()
        kappa = cohens_kappa(cmat, n_classes=num_classes)
        acc = confusion_accuracy(cmat)
        print(f"Cohen's kappa: {kappa:.4f}")
        print(f'Accuracy: {acc:.4f}')


if __name__ == '__main__':
    main()
