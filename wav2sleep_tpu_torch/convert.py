"""Weights between the JAX package and the port.

``from_jax_variables`` turns the JAX package's model variables (as numpy)
into a ``state_dict`` for this package's models, which use the reference torch
names and layouts. The key and value mapping is that of the JAX package's
checkpoint export (``wav2sleep_tpu/checkpoint.py``), kept here for both
families. Weight norm's ``kernel_v`` / ``kernel_g``, which that export
leaves under their JAX names and the JAX package's reader refuses, become
the port's ``weight_v`` [C_out, C_in, k] and ``weight_g`` [C_out, 1, 1].
The other direction is the JAX package's own ``convert_state_dict``, which
takes the port's ``state_dict`` as it is (weight norm aside).
"""

from __future__ import annotations

import numpy as np
import torch

_SEP = '|'

# Flax module-name prefixes -> torch (ModuleList attribute) names.
_LIST_PREFIXES = {
    'encoders_': ('encoders',),
    'cnn_': ('cnn',),
    'layers_': ('layers',),
    'blocks_': ('dilated_convs',),
    'convs_': ('conv_layers',),
}
_PPGNET_PREFIXES = {
    'conv_block_': ('conv_block', 'model'),
    'dilated_': ('dilated_convs',),
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
    leaf = key.split(_SEP)[-1]
    if leaf in ('kernel', 'kernel_v'):
        if w.ndim == 3:  # conv [k, in, out] -> [out, in, k]
            return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))
        return np.ascontiguousarray(w.T)  # dense [in, out] -> [out, in]
    if leaf == 'kernel_g':  # [out] -> torch weight_norm's [out, 1, 1]
        return np.ascontiguousarray(w.reshape(-1, 1, 1))
    return np.ascontiguousarray(w)


def _rename_structural(parts: list[str], family: str) -> list[str]:
    prefixes = {**_LIST_PREFIXES, **(_PPGNET_PREFIXES if family == 'ppgnet' else {})}
    out = []
    for p in parts:
        if p == 'GroupNorm_0':
            # ConvGroupNorm nests the group norm one level deeper in torch
            # ('<x>.norm.norm.weight'); the JAX package's tree names it GroupNorm_0.
            out.append('norm')
            continue
        if family == 'ppgnet' and p == 'dense':
            out += ['dense', 'linear']
            continue
        for prefix, names in prefixes.items():
            if p.startswith(prefix):
                out += [*names, p[len(prefix) :]]
                break
        else:
            out.append(p)
    return out


def _to_torch_key(key: str, family: str) -> str:
    parts = _rename_structural(key.split(_SEP), family)
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
    if leaf in ('kernel_v', 'kernel_g'):
        return '.'.join(base) + '.weight_' + leaf[-1]
    if leaf == 'bias':
        return '.'.join(base) + '.bias'
    return '.'.join(parts)


def from_jax_variables(variables_np: dict, family: str = 'wav2sleep') -> dict[str, torch.Tensor]:
    """JAX-package variables ``{'params': ..., 'batch_stats': ...}`` (nested
    dicts of numpy arrays) of a ``family`` ('wav2sleep' or 'ppgnet') model
    -> torch ``state_dict`` with the reference key names. Batch norm's
    ``mean`` / ``var`` become ``running_mean`` / ``running_var`` with
    ``num_batches_tracked`` 0, as the JAX package's export writes them."""
    if family not in ('wav2sleep', 'ppgnet'):
        raise ValueError(f"family must be 'wav2sleep' or 'ppgnet', got {family!r}")
    stats = _flatten(variables_np.get('batch_stats') or {})
    batch_norms = {key.rsplit(_SEP, 1)[0] for key in stats}
    sd = {}
    for key, w in _flatten(variables_np['params']).items():
        value = _to_torch_value(key, np.array(w, dtype=np.float32))
        parts = key.split(_SEP)
        is_batch_norm = key.rsplit(_SEP, 1)[0] in batch_norms
        if parts[-1] in ('scale', 'bias') and parts[-2:-1] == ['norm'] and not is_batch_norm:
            # ConvLayerNorm's and ConvRMSNorm's affine is [1, C, 1] in the
            # reference checkpoints; batch norm's stays [C].
            value = value.reshape(1, -1, 1)
        sd[_to_torch_key(key, family)] = torch.from_numpy(np.ascontiguousarray(value))
    for key, w in stats.items():
        base = '.'.join(_rename_structural(key.split(_SEP)[:-1], family))
        name = {'mean': 'running_mean', 'var': 'running_var'}[key.split(_SEP)[-1]]
        sd[f'{base}.{name}'] = torch.from_numpy(np.array(w, dtype=np.float32))
        sd.setdefault(f'{base}.num_batches_tracked', torch.tensor(0, dtype=torch.int64))
    return sd
