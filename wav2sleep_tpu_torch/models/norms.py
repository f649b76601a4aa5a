"""Normalization layers for channels-last ``[N, T, C]`` maps.

The kinds on the serving path of ``wav2sleep_tpu/models/norms.py``:
``InstanceNorm`` (per-(sample, channel) stats over time, no affine, biased
variance) and ``ConvLayerNorm`` (over channels, affine stored ``[1, C, 1]``
as in the reference torch checkpoints). The transformer uses
``torch.nn.LayerNorm`` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvLayerNorm(nn.Module):
    """Layer norm across channels for conv feature maps (biased variance)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(1, num_features, 1))
        self.bias = nn.Parameter(torch.zeros(1, num_features, 1))

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        C = self.num_features
        return F.layer_norm(x_NTC, (C,), self.weight.view(C), self.bias.view(C), self.eps)


class InstanceNorm(nn.Module):
    """Instance norm over the time axis, no affine parameters."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        mu = x_NTC.mean(dim=-2, keepdim=True)
        var = (x_NTC - mu).square().mean(dim=-2, keepdim=True)
        return (x_NTC - mu) / torch.sqrt(var + self.eps)


def get_norm(name: str | None, num_features: int, norm_eps: float | None = None) -> nn.Module | None:
    """Build a norm module by name; None for ``name is None``. ``norm_eps``
    applies to instance norm only, as in the JAX package. The batch, rms,
    group and weight kinds are not ported yet."""
    if name is None:
        return None
    if name == 'instance':
        return InstanceNorm(num_features, eps=norm_eps if norm_eps is not None else 1e-5)
    if name == 'layer':
        return ConvLayerNorm(num_features)
    raise NotImplementedError(f'norm {name!r} is not ported to the torch package yet')
