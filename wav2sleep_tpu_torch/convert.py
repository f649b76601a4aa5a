"""Weights between the JAX package and the port.

``from_jax_variables`` turns the JAX package's model variables (as numpy)
into a ``state_dict`` for this package's models, which use the reference torch
names and layouts. The other direction is the JAX package's own
``wav2sleep_tpu.convert.convert_state_dict``, which takes that
``state_dict`` as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_variables(variables_np: dict) -> dict[str, torch.Tensor]:
    """JAX-package variables ``{'params': ...}`` (nested dicts of numpy
    arrays) -> torch ``state_dict`` with the reference key names."""
    # checkpoint.py imports yaml at module level; yaml is not a dependency of
    # this package, so it is imported here, when a conversion is asked for.
    from wav2sleep_tpu.checkpoint import _SEP, _flatten, _to_torch_key, _to_torch_value

    if variables_np.get('batch_stats'):
        raise NotImplementedError('batch norm is not ported to the torch package yet')
    sd = {}
    for key, w in _flatten(variables_np['params']).items():
        value = _to_torch_value(key, np.asarray(w, dtype=np.float32))
        parts = key.split(_SEP)
        if parts[-1] in ('scale', 'bias') and len(parts) > 1 and parts[-2] == 'norm':
            # ConvLayerNorm's affine is [1, C, 1] in the reference checkpoints.
            value = value.reshape(1, -1, 1)
        sd[_to_torch_key(key, 'wav2sleep')] = torch.from_numpy(np.ascontiguousarray(value))
    return sd
