"""Activations by name, with the JAX package's semantics (exact erf GELU,
leaky slope 0.01)."""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    'relu': F.relu,
    'leaky': partial(F.leaky_relu, negative_slope=0.01),
    'gelu': F.gelu,  # approximate='none': the erf form
    'silu': F.silu,
    'swish': F.silu,
    'linear': _identity,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return an activation function from its name."""
    if name not in _ACTIVATIONS:
        raise ValueError(f'{name=} is unsupported.')
    return _ACTIVATIONS[name]
