"""Normalization layers for channels-last ``[N, T, C]`` maps.

Ports of every kind in ``wav2sleep_tpu/models/norms.py``:

- ``ConvLayerNorm``: over channels, affine stored ``[1, C, 1]`` as in the
  reference torch checkpoints;
- ``ConvRMSNorm``: RMS over channels, scale only, stored ``[1, C, 1]``;
- ``InstanceNorm``: per-(sample, channel) statistics over time, no affine,
  biased variance;
- ``ConvGroupNorm``: statistics per (sample, group of channels) over time
  and the group, affine, in the nested ``norm.norm.*`` names of the
  reference (``wav2sleep_tpu/convert.py`` maps them to the JAX tree's
  ``GroupNorm_0``);
- ``BatchNorm``: statistics over every axis but the channels in training,
  the running statistics in eval, affine ``[C]`` and torch's buffers.

The transformer uses ``torch.nn.LayerNorm`` directly. The norms with
parameters cast them to the input's dtype, as ``Conv1D`` casts its weights:
a bf16 step's forward and its rematerialised recompute then compute alike,
whether the module holds the bf16 copies or the f32 masters.
"""

from __future__ import annotations

import contextlib

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
        w, b = (p.view(C).to(x_NTC.dtype) for p in (self.weight, self.bias))
        return F.layer_norm(x_NTC, (C,), w, b, self.eps)


class ConvRMSNorm(nn.Module):
    """RMS normalization across channels: ``x / sqrt(mean(x^2) + eps) * scale``."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(1, num_features, 1))

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        ms = x_NTC.square().mean(dim=-1, keepdim=True)
        return x_NTC / torch.sqrt(ms + self.eps) * self.weight.view(-1).to(x_NTC.dtype)


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


class _GroupNorm(nn.Module):
    """The JAX package's group norm arithmetic: f32 statistics per (sample,
    group) over time and the group's channels, ``E[x^2] - E[x]^2`` clipped
    at 0, then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        N, T, C = x_NTC.shape
        G = self.num_groups
        x = x_NTC.float()
        xg = x.reshape(N, T, G, C // G)
        mean = xg.mean(dim=(1, 3))
        var = (xg.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
        mean = mean.repeat_interleave(C // G, dim=-1)[:, None, :]
        w, b = (p.to(x_NTC.dtype).float() for p in (self.weight, self.bias))
        mul = torch.rsqrt(var + self.eps).repeat_interleave(C // G, dim=-1)[:, None, :] * w
        return ((x - mean) * mul + b).to(x_NTC.dtype)


class ConvGroupNorm(nn.Module):
    """Group norm with 8 groups (or ``channels_per_group``), degrading to
    instance norm (with affine) when there are fewer channels than groups."""

    def __init__(self, num_features: int, num_groups: int = 8, channels_per_group: int | None = None,
                 eps: float = 1e-5):
        super().__init__()
        if channels_per_group is not None:
            num_groups = num_features // channels_per_group
        num_groups = min(num_groups, num_features)
        if num_features % num_groups:
            raise ValueError(f'num_features={num_features} must be divisible by num_groups={num_groups}.')
        self.norm = _GroupNorm(num_groups, num_features, eps)

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        return self.norm(x_NTC)


class BatchNorm(nn.Module):
    """Batch norm over every axis but the channels, with running statistics.

    torch ``nn.BatchNorm1d``'s defaults and buffers (eps 1e-5, momentum
    0.1, ``running_mean``, ``running_var``, ``num_batches_tracked``) with
    the JAX package's arithmetic: in training the batch's biased variance
    as ``E[x^2] - mean^2``, and the running variance takes the unbiased one
    (x n/(n-1)); in eval the running statistics. ``num_batches_tracked``
    counts the updates. A bf16 input is normalized in f32 and the result
    rounded to bf16, as XLA's fused bf16 program computes it: in bf16,
    ``E[x^2] - mean^2`` over a few values goes negative. The running
    statistics keep their own dtype (f32 in a bf16 step, as JAX's
    ``batch_stats``). ``frozen`` (see ``frozen_running_stats``) normalizes
    with the batch's statistics and leaves the buffers alone.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.num_features, self.eps, self.momentum = num_features, eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.register_buffer('num_batches_tracked', torch.tensor(0, dtype=torch.long))
        self.frozen = False

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        x = x_NTC.to(torch.promote_types(x_NTC.dtype, torch.float32))
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = x.square().mean(dim=axes) - mean.square()
            if not self.frozen:
                n = x.numel() // x.shape[-1]
                with torch.no_grad():
                    keep, unbiased = 1.0 - self.momentum, var * (n / max(n - 1, 1))
                    self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                    self.running_var.copy_(keep * self.running_var + self.momentum * unbiased)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        y = (x - mean) / torch.sqrt(var + self.eps)
        # The affine in the input's dtype first: the f32 masters and their
        # bf16 copies give one value (see the module docstring).
        w, b = (p.to(x_NTC.dtype).to(x.dtype) for p in (self.weight, self.bias))
        return (y * w + b).to(x_NTC.dtype)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Inside the block, the batch norms in ``module`` leave their running
    statistics alone: a rematerialised block's recompute in the backward
    must not take a second momentum step (JAX's ``nn.remat`` keeps only the
    forward's mutation)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


def get_norm(name: str | None, num_features: int, norm_eps: float | None = None) -> nn.Module | None:
    """Build a norm module by name; None for ``name is None``. ``norm_eps``
    applies to instance norm only, as in the JAX package. ``'weight'`` is
    the conv's own reparameterisation, not a module (``layers.Conv1D``)."""
    if name is None:
        return None
    if name == 'instance':
        return InstanceNorm(num_features, eps=norm_eps if norm_eps is not None else 1e-5)
    if name == 'layer':
        return ConvLayerNorm(num_features)
    if name == 'rms':
        return ConvRMSNorm(num_features)
    if name == 'group':
        return ConvGroupNorm(num_features)
    if name == 'batch':
        return BatchNorm(num_features)
    raise ValueError(f'Normalisation with {name=} unknown.')
