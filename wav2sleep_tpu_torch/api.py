"""Public API of the port: run a trained model on a folder of nights.

The port's counterpart of ``wav2sleep_tpu/api.py``, with its signatures and
defaults: ``load_model`` / ``prepare`` / ``load_dataset`` / ``predict`` /
``save_predictions`` / ``predict_on_folder``, the same checkpoint folders
(``config.yaml`` + ``state_dict.pth`` or ``params.npz``), the same parquet
cache (one file per night under ``<tmp>/wav2sleep/<signals>_<h>h``, laid out
as pandas writes it, so either package reads the other's) and the same
``.preds.csv`` bytes. The forward runs on the card (``device`` None or
``'auto'``; ``'cpu'`` asks for the CPU), through the port's kernels.

``load_model`` gives the ``nn.Module`` (a ``Wav2Sleep`` or a
``SleepPPGNet``), which the serving pipelines take; ``predict`` and
``predict_on_folder`` take it or a ``W2SModel``, the JAX package's model
handle, and wrap the former. Nights are padded as the JAX package pads them
(to a multiple of 120 epochs, a short batch with copies of its last
night); the zeros enter the encoders' instance-norm statistics, so the
padding is part of the result, not only of the speed.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
from dataclasses import dataclass
from glob import glob
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .checkpoint import load_state_dict, read_config
from .data import parquet
from .data.dataset import ParquetDataset, collate, pad_or_truncate_item
from .data.edf import load_edf_arrays
from .data.frame import Frame, format_stamps, read_csv, seconds_to_ns
from .data.preprocessing import process_waveform_arrays, process_waveform_frame
from .hub import download_from_hub, is_hf_repo_id
from .instantiate import build_model, model_family
from .models.ppgnet import SleepPPGNet
from .settings import EPOCH_SECONDS, LABEL, MEDIUM_FREQ_SAMPLES_PER_EPOCH, PRED, TIMESTAMP, TRAINING_LENGTH_HOURS
from .utils import full_f32, resolve_device

logger = logging.getLogger(__name__)

PRECISIONS = ('float32', 'bfloat16')
EPOCH_BUCKET = 120  # Night lengths are padded to multiples of 1 h, as in the JAX package.


def check_local(folder: str) -> None:
    """Raise for a Hugging Face Hub URI: the port reads local folders only."""
    if is_hf_repo_id(folder):
        download_from_hub(folder)


def load_model(folder: str, precision: str = 'float32', device: torch.device | str | None = None) -> nn.Module:
    """The model of a checkpoint folder (a ``Wav2Sleep`` or a
    ``SleepPPGNet``), in eval mode, on ``device`` (the card when None;
    raises without one).

    ``state_dict.pth`` is preferred over ``params.npz``; ``load_state_dict``
    with ``strict=True`` checks that the weights fit the config's model.
    With ``precision='bfloat16'`` the parameters and batch norm's running
    statistics are cast to bf16, as the JAX package casts all its
    variables: the serving pipelines keep the parameters' dtype.

    Full f32 holds in the serving pipelines' forwards and in
    ``W2SModel.logits`` only: they switch cuDNN's and the matmuls' TF32 off
    for each call (``utils.full_f32``). Calling the returned model directly
    runs under the process's flags, which torch defaults to TF32 convs on
    the card. The flags are process-wide and not locked: an f32 forward that
    ends in one thread restores them under an f32 forward still running in
    another, which then finishes in TF32.
    """
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}, got {precision!r}')
    check_local(folder)
    dev = resolve_device(device)
    cfg = read_config(folder)
    model = build_model(cfg)
    model.load_state_dict(load_state_dict(folder, model_family(cfg)), strict=True)
    return model.to(device=dev, dtype=_dtype(precision)).eval()


def _dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == 'bfloat16' else torch.float32


@dataclass
class W2SModel:
    """A loaded model: the module on ``device`` with its parameters in
    ``precision``'s dtype (cast on construction), its family and config.
    ``logits`` takes numpy inputs, as the JAX package's ``W2SModel`` does."""

    module: nn.Module
    family: str
    config: Optional[dict] = None
    precision: str = 'float32'
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f'precision must be one of {PRECISIONS}, got {self.precision!r}')
        dev = resolve_device(self.device)
        self.module = self.module.to(device=dev, dtype=_dtype(self.precision)).eval()
        self.device = next(self.module.parameters()).device

    @classmethod
    def load(cls, folder: str, precision: str = 'float32', device: torch.device | str | None = None) -> 'W2SModel':
        """The model of a checkpoint folder (``load_model``) with its config."""
        module = load_model(folder, precision=precision, device=device)
        cfg = read_config(folder)
        return cls(module, model_family(cfg), cfg, precision, device)

    @classmethod
    def wrap(cls, model: 'W2SModel | nn.Module', device: torch.device | str | None = None) -> 'W2SModel':
        """``model`` on ``device`` (the card for None or ``'auto'``): a
        ``W2SModel`` itself, moved there in place if it is elsewhere (as
        ``nn.Module.to`` moves its module, so the caller's handle follows
        its weights), else a ``W2SModel`` of the bare module, moved there; a
        bare module's precision is its parameters'."""
        dev = resolve_device(device)
        if isinstance(model, W2SModel):
            if not _same_device(model.device, dev):
                model.module.to(dev)
                model.device = next(model.module.parameters()).device
            return model
        family = 'ppgnet' if isinstance(model, SleepPPGNet) else 'wav2sleep'
        dtype = next(model.parameters()).dtype
        return cls(model, family, None, 'bfloat16' if dtype == torch.bfloat16 else 'float32', dev)

    @property
    def num_classes(self) -> int:
        return self.module.num_classes

    @property
    def valid_signals(self) -> list[str]:
        return list(self.module.valid_signals)

    @property
    def causal(self) -> bool:
        return bool(self.module.causal)

    def logits(self, x: dict[str, np.ndarray]) -> np.ndarray:
        """Per-epoch class logits ``[B, S, C]`` (f32) for a dict of ``[B, T]``
        inputs, cast to the model's precision on the device. f32 runs
        without TF32 (``utils.full_f32``)."""
        dtype = _dtype(self.precision)
        xb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, dtype) for k, v in x.items()}
        with torch.inference_mode(), full_f32() if dtype == torch.float32 else contextlib.nullcontext():
            if self.family == 'ppgnet':
                (x_single,) = xb.values()
                out = self.module(x_single)
            else:
                out = self.module(xb)
        return out.float().cpu().numpy()

    def predict(self, x: dict[str, np.ndarray]) -> np.ndarray:
        """Most likely sleep stage per epoch, ``[B, S]``."""
        return np.argmax(self.logits(x), axis=-1)

    def __call__(self, x: dict[str, np.ndarray]) -> np.ndarray:
        return self.logits(x)


def _same_device(have: torch.device, want: torch.device) -> bool:
    return have.type == want.type and (want.index is None or want.index == have.index)


def prepare(
    input_folder: str,
    signals: Iterable[str],
    max_length_hours: int = 10,
    tmp_root_folder: str | None = None,
) -> str:
    """Preprocess EDF/CSV/Parquet into model-ready parquet files; returns
    their folder.

    The cache is keyed by ``signals`` and ``max_length_hours`` under
    ``tmp_root_folder`` (``<tempdir>/wav2sleep``, the JAX package's, whose
    files the port reads and whose layout it writes); files that exist are
    skipped. A file that cannot be read or has none of ``signals`` is logged
    and skipped.
    """
    if tmp_root_folder is None:
        tmp_root_folder = os.path.join(tempfile.gettempdir(), 'wav2sleep')
    logger.info(f'Preparing dataset from {input_folder}...')
    signals = list(signals)
    tmp_subfolder = os.path.join(tmp_root_folder, '_'.join(signals) + f'_{max_length_hours}h')
    fps = _get_supported_files(input_folder)
    logger.debug(f'Found {len(fps)} files in {input_folder}')
    for fp in fps:
        tmp_path = Path(tmp_subfolder) / Path(fp).relative_to(Path(fp).anchor).with_suffix('.parquet')
        if os.path.exists(tmp_path):
            logger.debug(f'Skipping {fp} because it already exists in {tmp_root_folder}')
            continue
        try:
            frame = _load_file(fp, columns=signals, max_length_hours=max_length_hours)
        except (OSError, ValueError, KeyError) as e:
            logger.error(f'Failed to process {fp} due to {e}')
            continue
        os.makedirs(os.path.dirname(tmp_path), exist_ok=True)
        parquet.write_frame(str(tmp_path), frame)
    return tmp_subfolder


def load_dataset(
    parquet_folder: str,
    signals: Iterable[str],
    num_classes: int = 4,
    max_length_hours: Optional[int] = None,
    causal: bool = False,
) -> ParquetDataset:
    """A ``ParquetDataset`` of every parquet file under ``parquet_folder``,
    labels optional."""
    signals = list(signals)
    input_fps = sorted(_get_parquet_files(parquet_folder))
    if len(input_fps) == 0:
        raise ValueError(f'No parquet files found in {parquet_folder}.')
    return ParquetDataset(
        parquet_fps=input_fps,
        columns=signals,
        num_classes=num_classes,
        require_labels=False,
        max_length_hours=max_length_hours,
        causal=causal,
    )


def predict(
    model: W2SModel | nn.Module,
    dataset: ParquetDataset,
    device: str = 'auto',
    batch_size: int = 4,
    num_workers: int = 4,
) -> Tuple[list[np.ndarray], Optional[list[np.ndarray]]]:
    """Apply a model to a dataset on ``device`` (the card for ``'auto'``);
    returns (predictions, labels, or None when no night has one).

    As in the JAX package, nights are read a batch at a time
    (``num_workers`` is accepted and ignored), padded with zeros to a
    multiple of ``EPOCH_BUCKET`` epochs (SleepPPG-Net: to its fixed input
    length), and a short batch is filled with copies of its last night.
    """
    del num_workers
    model = W2SModel.wrap(model, device)
    predictions: list[np.ndarray] = []
    labels: list[np.ndarray] = []
    for i in range(0, len(dataset), batch_size):
        chunk = [dataset[j] for j in range(i, min(i + batch_size, len(dataset)))]
        epochs = [len(it[1]) for it in chunk]
        if model.family == 'ppgnet':
            bucket = model.module.INPUT_LENGTH // MEDIUM_FREQ_SAMPLES_PER_EPOCH
        else:
            bucket = int(np.ceil(max(epochs) / EPOCH_BUCKET) * EPOCH_BUCKET)
        padded = [pad_or_truncate_item(it, bucket) for it in chunk]
        padded.extend([padded[-1]] * (batch_size - len(padded)))
        x, y = collate(padded)
        preds = model.predict(x)
        for j, night_epochs in enumerate(epochs):
            predictions.append(preds[j, :night_epochs])
            labels.append(y[j, :night_epochs])
    if all((lab == -1).all() for lab in labels):
        return predictions, None
    return predictions, labels


def write_predictions_csv(out_fp: str, stamps: list[str], preds: np.ndarray, labels: np.ndarray | None = None) -> None:
    """``DataFrame.to_csv`` of a ``Timestamp`` index (``stamps``, already
    formatted), the ``Pred`` column and, with labels, the ``Stage`` column
    (float32, as the dataset holds it)."""
    header = f'{TIMESTAMP},{PRED}' + (f',{LABEL}' if labels is not None else '')
    rows = [f'{s},{int(p)}' for s, p in zip(stamps, preds.tolist())]
    if labels is not None:
        rows = [f'{r},{float(v)!r}' for r, v in zip(rows, labels.tolist())]
    with open(out_fp, 'w', newline='') as f:
        f.write(header + '\n')
        f.writelines(r + '\n' for r in rows)


def save_predictions(
    predictions,
    parquet_folder: str,
    output_folder: str,
    dataset: ParquetDataset,
    labels=None,
    overwrite: bool = False,
    max_length_hours: Optional[int] = None,
) -> None:
    """Write one ``<name>.preds.csv`` per night of ``dataset`` under
    ``output_folder``, mirroring its path under ``parquet_folder``: a row per
    30 s epoch stamped at the epoch's end, from the night's first index
    value for a datetime index, else in seconds (``30.0, 60.0, ...``)."""
    del max_length_hours
    for idx, fp in enumerate(dataset.files):
        rel_path = Path(fp).relative_to(parquet_folder)
        out_fp = str(Path(output_folder) / rel_path.with_suffix('.preds.csv'))
        if os.path.exists(out_fp) and not overwrite:
            logger.warning(f'File {out_fp} exists. Skipping.')
            continue
        preds = np.asarray(predictions[idx])
        ends = np.arange(0, 60 * len(preds) / 2, step=EPOCH_SECONDS) + EPOCH_SECONDS
        start, is_datetime = parquet.index_start(fp)
        stamps = format_stamps(int(start) + seconds_to_ns(ends)) if is_datetime else [repr(t) for t in ends.tolist()]
        os.makedirs(os.path.dirname(out_fp), exist_ok=True)
        write_predictions_csv(out_fp, stamps, preds, None if labels is None else np.asarray(labels[idx][: len(preds)]))


def predict_on_folder(
    input_folder: str,
    output_folder: str,
    *,
    model: W2SModel | nn.Module | None = None,
    model_folder: Optional[str] = None,
    signals: Optional[Iterable[str]] = None,
    device: str = 'auto',
    batch_size: int = 4,
    num_workers: int = 4,
    preprocess: bool = True,
    max_length_hours: int = 10,
    overwrite: bool = False,
    compile: bool = False,  # noqa: A002 - the JAX package's argument name
    return_tensors: bool = False,
    precision: str = 'float32',
    tmp_root_folder: str | None = None,
):
    """End to end: (optionally) preprocess a folder, run the model on
    ``device`` (the card for ``'auto'``), save the CSVs; with
    ``return_tensors``, return (predictions, labels). ``signals`` must be a
    subset of the model's; ``precision`` applies to a model loaded from
    ``model_folder``. ``compile`` is accepted and ignored."""
    del compile
    if model is None:
        if model_folder is None:
            raise ValueError('Either `model` or `model_folder` must be provided.')
        model = W2SModel.load(model_folder, precision=precision, device=device)
    model = W2SModel.wrap(model, device)

    if signals is None:
        signals = list(model.valid_signals)
    else:
        signals = list(signals)
        valid = set(model.valid_signals)
        if not set(signals).issubset(valid):
            raise ValueError(f'Invalid signal subset: {signals}. Valid signals are: {sorted(valid)}')

    if preprocess:
        parquet_folder = prepare(
            input_folder=input_folder,
            signals=signals,
            max_length_hours=max_length_hours,
            tmp_root_folder=tmp_root_folder,
        )
    else:
        parquet_folder = input_folder

    ds = load_dataset(
        parquet_folder=parquet_folder,
        signals=signals,
        num_classes=model.num_classes,
        max_length_hours=max_length_hours,
        causal=model.causal,
    )
    preds, labels = predict(model=model, dataset=ds, device=device, batch_size=batch_size, num_workers=num_workers)
    save_predictions(
        predictions=preds,
        parquet_folder=parquet_folder,
        output_folder=output_folder,
        dataset=ds,
        labels=labels,
        overwrite=overwrite,
    )
    return (preds, labels) if return_tensors else None


# ---------- internal helpers ----------


def _get_supported_files(input_folder: str) -> list[str]:
    files = []
    for ext in ('edf', 'csv', 'parquet'):
        files.extend(glob(os.path.join(input_folder, f'**/*.{ext}'), recursive=True))
    return sorted(files)


def _get_parquet_files(folder: str) -> list[str]:
    return glob(os.path.join(folder, '**/*.parquet'), recursive=True)


def _load_file(fp: str, columns: list[str], max_length_hours: float = TRAINING_LENGTH_HOURS) -> Frame:
    """One night on the model grids, framed as the JAX package's ``prepare``
    frames it: an EDF's channels at its sample times with a datetime index
    from its start; a CSV or parquet file over its own index."""
    if fp.endswith('.edf'):
        arrays, _metadata, start = load_edf_arrays(fp, columns)
        return process_waveform_arrays(arrays, columns, max_length_hours, start=start)
    elif fp.endswith('.csv'):
        return process_waveform_frame(read_csv(fp, columns), columns, max_length_hours)
    elif fp.endswith('.parquet'):
        return process_waveform_frame(parquet.read_frame(fp, columns), columns, max_length_hours)
    else:
        raise ValueError(f'Unsupported file extension for {fp}')
