"""Public API of the port: load a trained model from a checkpoint folder.

The port's counterpart of ``wav2sleep_tpu/api.py``'s ``load_model``, for
both families. A folder holds ``config.yaml`` and ``state_dict.pth`` (the
reference's deployable format) or ``params.npz`` (the JAX package's); see
``checkpoint``. The loaded module answers what the JAX package's
``W2SModel`` answers for its family: ``valid_signals`` (``['PPG']`` for
SleepPPG-Net), ``num_classes`` and ``causal``. ``predict_on_folder`` and
the parquet path are not ported yet (ROADMAP §A.4).
"""

from __future__ import annotations

import torch
from torch import nn

from .checkpoint import load_state_dict, read_config
from .instantiate import build_model, model_family
from .utils import resolve_device

PRECISIONS = ('float32', 'bfloat16')


def check_local(folder: str) -> None:
    """Raise for a Hugging Face Hub URI: the port reads local folders only."""
    if folder.startswith('hf://'):
        raise ValueError(
            f'{folder}: downloading from the Hugging Face Hub is not ported; '
            'download the checkpoint folder and pass its path'
        )


def load_model(folder: str, precision: str = 'float32', device: torch.device | str | None = None) -> nn.Module:
    """The model of a checkpoint folder (a ``Wav2Sleep`` or a
    ``SleepPPGNet``), in eval mode, on ``device`` (the card when None;
    raises without one).

    ``state_dict.pth`` is preferred over ``params.npz``; ``load_state_dict``
    with ``strict=True`` checks that the weights fit the config's model.
    With ``precision='bfloat16'`` the parameters and batch norm's running
    statistics are cast to bf16, as the JAX package casts all its
    variables: the serving pipelines keep the parameters' dtype.

    Full f32 holds in the serving pipelines' forwards only: they switch
    cuDNN's and the matmuls' TF32 off for each call (``utils.full_f32``).
    Calling the returned model directly runs under the process's flags,
    which torch defaults to TF32 convs on the card. The flags are
    process-wide and not locked: an f32 forward that ends in one thread
    restores them under an f32 forward still running in another, which then
    finishes in TF32.
    """
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}, got {precision!r}')
    check_local(folder)
    dev = resolve_device(device)
    cfg = read_config(folder)
    model = build_model(cfg)
    model.load_state_dict(load_state_dict(folder, model_family(cfg)), strict=True)
    dtype = torch.bfloat16 if precision == 'bfloat16' else torch.float32
    return model.to(device=dev, dtype=dtype).eval()
