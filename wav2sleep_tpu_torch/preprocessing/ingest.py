"""Ingest an NSRR or WSC dataset: EDF and annotations to per-night parquet
under ``<output-folder>/<dataset>/ingest``, the dataset named by the
folder's basename.

    python -m wav2sleep_tpu_torch.preprocessing.ingest --folder /data/raw/mesa \\
        --output-folder /data/processed --columns ECG PPG ABD THX --max-parallel 16

``--max-parallel`` spawns that many worker processes on this host;
``--shard-hosts`` first joins the ``torch.distributed`` group that torchrun's
environment describes (``parallel.mesh.maybe_initialize_distributed``) and
splits the work list across its processes, one a host (the counterpart of
``preprocessing/1_tpu_ingest.sh``)::

    torchrun --nnodes=H --nproc-per-node=1 --node-rank=<h> --master-addr=<host 0> --master-port=29500 \
        -m wav2sleep_tpu_torch.preprocessing.ingest --folder /data/raw/mesa \
        --output-folder /data/processed --columns ECG PPG ABD THX --max-parallel 16 --shard-hosts
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(prog='Dataset Processor', description='Process dataset.')
    parser.add_argument('--folder', required=True, help='Location of dataset (basename = dataset name).')
    parser.add_argument('--columns', nargs='+', default=None, help='Signals to process (e.g. ECG PPG ABD THX).')
    parser.add_argument('--max-parallel', default=1, type=int, help='Parallel worker processes.')
    parser.add_argument('--output-folder', required=True, help='Base output folder for processed datasets.')
    parser.add_argument('--overwrite', action='store_true', default=False)
    parser.add_argument('--shard-hosts', action='store_true', default=False,
                        help='Split the work list across the hosts of a torch.distributed group.')
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from ..ingest import prepare_dataset, process_files

    if args.shard_hosts:
        from ..parallel.mesh import maybe_initialize_distributed

        maybe_initialize_distributed()
    dataset = args.folder.rstrip('/').split('/')[-1]
    print(f'Processing {dataset=}...')
    fp_dict = prepare_dataset(folder=args.folder, output_folder=args.output_folder, dataset=dataset)
    process_files(
        fp_dict,
        max_parallel=args.max_parallel,
        overwrite=args.overwrite,
        columns=args.columns,
        shard_hosts=args.shard_hosts,
    )


if __name__ == '__main__':
    main()
