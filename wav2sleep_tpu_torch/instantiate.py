"""A checkpoint's ``_target_`` model config -> the port's model.

The port's counterpart of ``wav2sleep_tpu/instantiate.py``. Checkpoint
folders carry the architecture as a Hydra-style config whose ``_target_``
strings name the reference's torch classes (``wav2sleep.models.*``) or the
JAX package's (``wav2sleep_tpu.models.*``); both spellings are read, for
both families: the multi-modal wav2sleep (``wav2sleep_arguments`` turns its
config into the keyword arguments of ``models.wav2sleep.build_wav2sleep``,
with the JAX package's defaults for what the config leaves out) and
SleepPPG-Net (``models.ppgnet``). A training config's masker
(``wav2sleep_tpu.train.masker.SignalMasker``) becomes the port's
``train.masker.SignalMasker`` (``instantiate``). Unknown ``_target_``s and
unresolved ``${...}`` interpolations raise ``ValueError``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .models.ppgnet import build_ppgnet
from .models.wav2sleep import build_wav2sleep
from .train.masker import SignalMasker

_MODULE = 'models.wav2sleep.'
_PPGNET = 'models.ppgnet.SleepPPGNet'
_MASKER = 'train.masker.SignalMasker'
_PREFIXES = ('wav2sleep.', 'wav2sleep_tpu.')


def model_family(cfg: dict) -> str:
    """'wav2sleep' or 'ppgnet' from a model config."""
    return 'ppgnet' if 'ppgnet' in str(cfg.get('_target_', '')).lower() else 'wav2sleep'


def _arguments(node: dict) -> dict:
    """A config node's keyword arguments, without its ``_target_``."""
    out = {}
    for k, v in node.items():
        if k in ('_target_', '_partial_'):
            continue
        if isinstance(v, str) and '${' in v:
            raise ValueError(f'Unresolved interpolation {v!r} for key {k!r}; '
                             'checkpoint configs must be fully resolved.')
        out[k] = v
    return out


def _section(cfg: dict, key: str, cls: str) -> dict:
    """The keyword arguments of one sub-module's config node, checked
    against its ``_target_``."""
    node = cfg.get(key)
    if not isinstance(node, dict):
        raise ValueError(f'model config has no {key!r} section')
    target = node.get('_target_')
    if target is not None and target not in (p + _MODULE + cls for p in _PREFIXES):
        raise ValueError(f'{key}: unknown _target_ {target!r}')
    return _arguments(node)


def _signal_map(mapping: Any) -> dict[str, str]:
    """A ``{signal: encoder}`` mapping, or a list of pairs, as a dict."""
    return {str(k): str(v) for k, v in dict(mapping).items()}


def wav2sleep_arguments(cfg: dict) -> dict:
    """``build_wav2sleep``'s keyword arguments from a wav2sleep ``_target_`` config."""
    target = cfg.get('_target_')
    if target not in (p + _MODULE + 'Wav2Sleep' for p in _PREFIXES):
        raise ValueError(f'Unknown _target_: {target!r}')
    enc = _section(cfg, 'signal_encoders', 'SignalEncoders')
    mix = _section(cfg, 'epoch_mixer', 'MultiModalAttentionEmbedder')
    seq = _section(cfg, 'sequence_mixer', 'SequenceCNN')
    # input_dim is a torch-only argument of the reference.
    enc.pop('input_dim', None)
    signal_map = _signal_map(enc.pop('signal_map'))
    seq.setdefault('norm', 'batch')  # the JAX package's default
    return dict(num_classes=cfg['num_classes'], signal_map=signal_map, encoders=enc, epoch_mixer=mix,
                sequence_mixer=seq)


def ppgnet_arguments(cfg: dict) -> dict:
    """``SleepPPGNet``'s keyword arguments from its ``_target_`` config."""
    if cfg.get('_target_') not in (p + _PPGNET for p in _PREFIXES):
        raise ValueError(f"Unknown _target_: {cfg.get('_target_')!r}")
    return _arguments(cfg)


def build_model(cfg: dict, generator: torch.Generator | None = None) -> nn.Module:
    """The port's model for a ``_target_`` config of either family, with the
    seeded init of ``generator`` (seed 0 without one), to be trained or
    replaced by a checkpoint's weights."""
    if model_family(cfg) == 'ppgnet':
        return build_ppgnet(generator, **ppgnet_arguments(cfg))
    return build_wav2sleep(**wav2sleep_arguments(cfg), generator=generator)


def instantiate(cfg: dict):
    """A model (``build_model``) or a training config's masker from its
    ``_target_`` config."""
    if cfg.get('_target_') in (p + _MASKER for p in _PREFIXES):
        return SignalMasker(**_arguments(cfg))
    return build_model(cfg)


# The JAX package's model targets under the reference's names, which both
# packages and the reference instantiate.
_TARGET_TO_REFERENCE = {f'wav2sleep_tpu.{m}': f'wav2sleep.{m}' for m in (
    _MODULE + 'Wav2Sleep', _MODULE + 'SignalEncoders', _MODULE + 'MultiModalAttentionEmbedder',
    _MODULE + 'SequenceCNN', _PPGNET)}


def reference_compatible_config(cfg: Any) -> Any:
    """``cfg`` with the model ``_target_``s under the reference's names and
    without ``remat`` (a training setting the reference does not take), as
    the JAX package exports a checkpoint folder's ``config.yaml``."""
    if isinstance(cfg, dict):
        out = {k: reference_compatible_config(v) for k, v in cfg.items() if k != 'remat'}
        if '_target_' in out:
            out['_target_'] = _TARGET_TO_REFERENCE.get(out['_target_'], out['_target_'])
        return out
    if isinstance(cfg, list):
        return [reference_compatible_config(v) for v in cfg]
    return cfg


def target_config(**arguments) -> dict:
    """The ``_target_`` config, with the reference's class names, of the
    model that ``build_wav2sleep(**arguments)`` builds or, for arguments
    without a ``signal_map``, ``SleepPPGNet(**arguments)``."""
    if 'signal_map' not in arguments:
        return {'_target_': 'wav2sleep.' + _PPGNET, **arguments}
    ref = 'wav2sleep.' + _MODULE
    a = arguments
    return {
        '_target_': ref + 'Wav2Sleep',
        'num_classes': a['num_classes'],
        'signal_encoders': {'_target_': ref + 'SignalEncoders', 'signal_map': dict(a['signal_map']), **a['encoders']},
        'epoch_mixer': {'_target_': ref + 'MultiModalAttentionEmbedder', **a['epoch_mixer']},
        'sequence_mixer': {'_target_': ref + 'SequenceCNN', **a['sequence_mixer']},
    }
