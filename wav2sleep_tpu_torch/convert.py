"""Weights between the JAX package and the port.

``from_jax_variables`` turns the JAX package's model variables (as numpy)
into a ``state_dict`` for this package's models, which use the reference torch
names and layouts. The key and value mapping is that of the JAX package's
checkpoint export (``wav2sleep_tpu/checkpoint.py``), kept here for the
wav2sleep family. The other direction is the JAX package's own
``convert_state_dict``, which takes that ``state_dict`` as it is.
"""

from __future__ import annotations

import numpy as np
import torch

_SEP = '|'

# Flax module-name prefixes -> torch (ModuleList attribute) names.
_LIST_PREFIXES = {
    'encoders_': 'encoders',
    'cnn_': 'cnn',
    'layers_': 'layers',
    'blocks_': 'dilated_convs',
    'convs_': 'conv_layers',
}


def _flatten(tree: dict, prefix=()) -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[_SEP.join(prefix + (k,))] = np.asarray(v)
    return out


def _to_torch_value(key: str, w: np.ndarray) -> np.ndarray:
    if key.split(_SEP)[-1] == 'kernel':
        if w.ndim == 3:  # conv [k, in, out] -> [out, in, k]
            return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))
        return np.ascontiguousarray(w.T)  # dense [in, out] -> [out, in]
    return np.ascontiguousarray(w)


def _rename_structural(parts: list[str]) -> list[str]:
    out = []
    for p in parts:
        for prefix, name in _LIST_PREFIXES.items():
            if p.startswith(prefix):
                out += [name, p[len(prefix) :]]
                break
        else:
            out.append(p)
    return out


def _to_torch_key(key: str) -> str:
    parts = _rename_structural(key.split(_SEP))
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ''
    base = parts[:-1]
    if leaf == 'register_tokens':
        return '.'.join(parts)
    if parent == 'in_proj':
        # .../self_attn/in_proj/{kernel,bias} -> torch's packed attributes
        name = 'in_proj_weight' if leaf == 'kernel' else 'in_proj_bias'
        return '.'.join(base[:-1]) + '.' + name
    if parent == 'embedder' and leaf == 'embedding':
        return '.'.join(base) + '.weight'
    if leaf in ('kernel', 'scale'):
        return '.'.join(base) + '.weight'
    if leaf == 'bias':
        return '.'.join(base) + '.bias'
    return '.'.join(parts)


def from_jax_variables(variables_np: dict) -> dict[str, torch.Tensor]:
    """JAX-package variables ``{'params': ...}`` (nested dicts of numpy
    arrays) -> torch ``state_dict`` with the reference key names."""
    if variables_np.get('batch_stats'):
        raise NotImplementedError('batch norm is not ported to the torch package yet')
    sd = {}
    for key, w in _flatten(variables_np['params']).items():
        value = _to_torch_value(key, np.array(w, dtype=np.float32))
        parts = key.split(_SEP)
        if parts[-1] in ('scale', 'bias') and len(parts) > 1 and parts[-2] == 'norm':
            # ConvLayerNorm's affine is [1, C, 1] in the reference checkpoints.
            value = value.reshape(1, -1, 1)
        sd[_to_torch_key(key)] = torch.from_numpy(np.ascontiguousarray(value))
    return sd
