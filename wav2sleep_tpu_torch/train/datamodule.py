"""Multi-dataset data module for training.

The port's counterpart of ``wav2sleep_tpu/train/datamodule.py`` (the
reference's ``SleepDataModule``):

- train set = union of each dataset's ``train/`` partition under
  ``<data_location>/<dataset>/<split>/*.parquet``,
- val loaders: ``all`` combines every val dataset but census (whose nights
  are drawn from the others), then one loader per dataset, each named,
- per-dataset test loaders,
- ``.issues.parquet`` exclusion, PPG-only file filtering by parquet schema,
- epoch-seeded shuffling (``seed + epoch``).

Over a data-parallel group (``mesh``) the train loader follows the group's
launch contract (``parallel.mesh``): one launch over N devices splits each
global batch of ``batch_size`` in rank order, and a rank reads only its
rows' nights from the one-card shuffle; one process per host shards the
file list (``shard_train_files``) and each rank loads ``batch_size`` rows.
Both give every rank the same number of batches, which the collectives
need. The eval loaders are not sharded, as in the JAX package: the trainer
takes a rank's rows of each batch. The reference's rsync staging of the
corpus to local scratch is not ported (ROADMAP §A.4).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import settings
from ..data.dataset import ParquetDataset, batch_iterator
from ..data.parquet import get_parquet_cols, get_parquet_fps
from ..parallel.mesh import Mesh
from ..settings import CENSUS, PPG, TEST, TRAIN, VAL
from ..utils import resolve_device

logger = logging.getLogger(__name__)


def shard_train_files(fps: list[str], seed: int, n_hosts: int, host: int) -> list[str]:
    """Deterministic per-host shard of the train file list for one epoch.

    All hosts shuffle the global list with the same seed, truncate it to a
    multiple of ``n_hosts`` (every host then yields the same number of
    batches, which collectives need) and take a disjoint stride. The seed
    varies per epoch, so remainder nights rotate back in on later epochs.
    A single-card run is one host (``n_hosts=1``)."""
    order = np.random.default_rng(seed).permutation(len(fps))
    n = (len(order) // n_hosts) * n_hosts
    if n == 0:
        raise ValueError(
            f'{len(fps)} train nights cannot be sharded over {n_hosts} hosts.'
        )
    return [fps[i] for i in order[host:n:n_hosts]]


def get_parquet_fps_for_dataset(
    data_location: str,
    dataset: str,
    split: str,
    columns: list[str],
    max_nights: int | None = None,
) -> list[str]:
    """Parquet files for one (dataset, split), ``.issues.parquet`` nights
    skipped, with schema-based filtering for PPG-only column sets (reference
    datamodule.py:100-125)."""
    folder = os.path.join(data_location, dataset, split)
    if not os.path.isdir(folder):
        logger.info(f'No folder for {dataset=} {split=} at {folder}')
        return []
    fps = [fp for fp in sorted(get_parquet_fps(folder)) if not fp.endswith('.issues.parquet')]
    # When training PPG-only models, drop files without a PPG column to avoid
    # wasted loads (schema check is metadata-only).
    if columns == [PPG]:
        fps = [fp for fp in fps if PPG in get_parquet_cols(fp)]
    if max_nights is not None:
        fps = fps[:max_nights]
    return fps


@dataclass
class SleepDataModule:
    columns: list[str]
    data_location: str
    train_datasets: list[str] = field(default_factory=list)
    val_datasets: list[str] = field(default_factory=list)
    test_datasets: list[str] = field(default_factory=list)
    num_classes: int = 4
    max_nights: int = 1_000_000
    test: bool = False
    batch_size: int = 16
    val_batch_size: int = 32
    test_batch_size: int = 32
    num_workers: int = 2
    drop_last: bool = False
    causal: bool = False
    seed: int = 42
    max_length_hours: int = settings.TRAINING_LENGTH_HOURS
    pad_to_epochs: int | None = None  # default: max_length_hours * 120
    # The device the batches are for (the card when None; raises without
    # one): the trainer that takes this data module stages onto it.
    device: torch.device | str | None = None
    # The data-parallel group the train loader feeds (its rank's rows), or None.
    mesh: Mesh | None = None

    def __post_init__(self):
        self.device = resolve_device(self.mesh.device if self.mesh is not None and self.device is None
                                     else self.device)
        self.columns = list(self.columns)
        if self.pad_to_epochs is None:
            self.pad_to_epochs = int(round(self.max_length_hours * 120))
        self._train_fps = []
        for ds in self.train_datasets:
            self._train_fps += self._fps(ds, TRAIN)
        # The combined val loader (named 'all') merges all val datasets
        # except census (its nights are drawn from the other datasets —
        # including it would duplicate). Consumers identify loaders by the
        # names val_loaders()/test_loaders() return, never by index (loaders
        # with no files are skipped).
        self._val_fps_combined = []
        self._val_fps_per_ds: list[tuple[str, list[str]]] = []
        for ds in self.val_datasets:
            fps = self._fps(ds, VAL)
            if ds != CENSUS:
                self._val_fps_combined += fps
            self._val_fps_per_ds.append((ds, fps))
        self._test_fps_per_ds: list[tuple[str, list[str]]] = []
        if self.test:
            for ds in self.test_datasets:
                self._test_fps_per_ds.append((ds, self._fps(ds, TEST)))

    def _fps(self, dataset: str, split: str) -> list[str]:
        return get_parquet_fps_for_dataset(
            self.data_location,
            dataset,
            split,
            self.columns,
            max_nights=self.max_nights,
        )

    def _make_dataset(self, fps: list[str]) -> ParquetDataset:
        return ParquetDataset(
            parquet_fps=fps,
            columns=self.columns,
            num_classes=self.num_classes,
            require_labels=True,
            max_length_hours=self.max_length_hours,
            causal=self.causal,
        )

    @property
    def num_train_nights(self) -> int:
        return len(self._train_fps)

    @property
    def rank_batch_size(self) -> int:
        """The rows of each train batch this rank gets: its block of the
        global batch in one launch over N devices, else ``batch_size``."""
        if self.mesh is None or self.mesh.per_process_batches:
            return self.batch_size
        return -(-self.batch_size // self.mesh.data)

    def train_loader(self, epoch: int = 0):
        """Shuffled train iterator, the shuffle seeded by ``seed + epoch``:
        over a group, this rank's rows of each global batch (one launch) or
        its own batches from its shard of the files (one process per host)."""
        mesh = self.mesh
        if mesh is not None and mesh.per_process_batches:
            fps = shard_train_files(self._train_fps, self.seed + epoch, mesh.data, mesh.data_index)
            # Already shuffled by the shard.
            return batch_iterator(self._make_dataset(fps), batch_size=self.batch_size, shuffle=False,
                                  drop_last=self.drop_last, num_threads=self.num_workers,
                                  pad_to_epochs=self.pad_to_epochs)
        return batch_iterator(
            self._make_dataset(self._train_fps),
            batch_size=self.batch_size,
            shuffle=True,
            seed=self.seed + epoch,
            drop_last=self.drop_last,
            num_threads=self.num_workers,
            pad_to_epochs=self.pad_to_epochs,
            block=None if mesh is None else (mesh.data_index, mesh.data),
        )

    def val_loaders(self):
        """[(name, loader)] — index 0 is the combined loader."""
        out = []
        sets = [('all', self._val_fps_combined)] + self._val_fps_per_ds
        for name, fps in sets:
            if not fps:
                continue
            ds = self._make_dataset(fps)
            out.append(
                (
                    name,
                    batch_iterator(
                        ds,
                        batch_size=self.val_batch_size,
                        shuffle=False,
                        num_threads=self.num_workers,
                        pad_to_epochs=self.pad_to_epochs,
                    ),
                )
            )
        return out

    def test_loaders(self):
        out = []
        for name, fps in self._test_fps_per_ds:
            if not fps:
                continue
            ds = self._make_dataset(fps)
            out.append(
                (
                    name,
                    batch_iterator(
                        ds,
                        batch_size=self.test_batch_size,
                        shuffle=False,
                        num_threads=self.num_workers,
                        pad_to_epochs=self.pad_to_epochs,
                    ),
                )
            )
        return out

