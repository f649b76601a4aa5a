"""A checkpoint's ``_target_`` model config -> the port's model.

The port's counterpart of ``wav2sleep_tpu/instantiate.py`` for the wav2sleep
family. Checkpoint folders carry the architecture as a Hydra-style config
whose ``_target_`` strings name the reference's torch classes
(``wav2sleep.models.*``) or the JAX package's (``wav2sleep_tpu.models.*``);
both spellings are read. ``wav2sleep_arguments`` turns such a config into
the keyword arguments of ``models.wav2sleep.build_wav2sleep``, with the
JAX package's defaults for what the config leaves out. Model kinds the port
does not have yet (SleepPPG-Net, causal encoders, batch / rms / group /
weight norms) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

from .models.wav2sleep import Wav2Sleep, build_wav2sleep

_MODULE = 'models.wav2sleep.'
_PREFIXES = ('wav2sleep.', 'wav2sleep_tpu.')
_NOT_PORTED = 'is not ported to the torch package yet (ROADMAP §A.3)'
_NORMS = ('instance', 'layer')


def model_family(cfg: dict) -> str:
    """'wav2sleep' or 'ppgnet' from a model config."""
    return 'ppgnet' if 'ppgnet' in str(cfg.get('_target_', '')).lower() else 'wav2sleep'


def _section(cfg: dict, key: str, cls: str) -> dict:
    """The keyword arguments of one sub-module's config node, checked
    against its ``_target_``."""
    node = cfg.get(key)
    if not isinstance(node, dict):
        raise ValueError(f'model config has no {key!r} section')
    target = node.get('_target_')
    if target is not None and target not in (p + _MODULE + cls for p in _PREFIXES):
        raise ValueError(f'{key}: unknown _target_ {target!r}')
    out = {}
    for k, v in node.items():
        if k in ('_target_', '_partial_'):
            continue
        if isinstance(v, str) and '${' in v:
            raise ValueError(f'Unresolved interpolation {v!r} for key {k!r}; checkpoint configs must be fully resolved.')
        out[k] = v
    return out


def _signal_map(mapping: Any) -> dict[str, str]:
    """A ``{signal: encoder}`` mapping, or a list of pairs, as a dict."""
    return {str(k): str(v) for k, v in dict(mapping).items()}


def wav2sleep_arguments(cfg: dict) -> dict:
    """``build_wav2sleep``'s keyword arguments from a ``_target_`` config."""
    if model_family(cfg) == 'ppgnet':
        raise NotImplementedError(f'SleepPPG-Net {_NOT_PORTED}')
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
    if enc.get('causal') or seq.get('causal'):
        raise NotImplementedError(f'causal encoders and sequence mixers {_NOT_PORTED}')
    if enc.get('norm', 'instance') not in _NORMS:
        raise NotImplementedError(f"norm {enc['norm']!r} {_NOT_PORTED}")
    if seq['norm'] is not None and seq['norm'] not in _NORMS:
        raise NotImplementedError(f"norm {seq['norm']!r} {_NOT_PORTED}")
    if not mix.pop('norm_first', True):
        raise NotImplementedError(f'a post-norm epoch mixer {_NOT_PORTED}')
    return dict(num_classes=cfg['num_classes'], signal_map=signal_map, encoders=enc, epoch_mixer=mix,
                sequence_mixer=seq)


def build_model(cfg: dict) -> Wav2Sleep:
    """The port's model for a ``_target_`` config (seeded weights, to be
    replaced by a checkpoint's)."""
    return build_wav2sleep(**wav2sleep_arguments(cfg))


def target_config(num_classes: int, signal_map: dict, encoders: dict, epoch_mixer: dict,
                  sequence_mixer: dict) -> dict:
    """The ``_target_`` config, with the reference's class names, of the
    model that ``build_wav2sleep`` builds from the same arguments."""
    ref = 'wav2sleep.' + _MODULE
    return {
        '_target_': ref + 'Wav2Sleep',
        'num_classes': num_classes,
        'signal_encoders': {'_target_': ref + 'SignalEncoders', 'signal_map': dict(signal_map), **encoders},
        'epoch_mixer': {'_target_': ref + 'MultiModalAttentionEmbedder', **epoch_mixer},
        'sequence_mixer': {'_target_': ref + 'SequenceCNN', **sequence_mixer},
    }
