"""Instance-norm statistics and their application, for the fused encoder chain.

The math of ``wav2sleep_tpu/ops/block_domain.py`` (``block_stats`` and
``apply_norm_act``) as plain reductions over time on channels-last
``[B, T, C]`` maps. The JAX module's 128-lane block packing is a TPU layout
device and is not carried over.
"""

from __future__ import annotations

from typing import Callable

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def block_stats(x_BTC: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) statistics over time: (mu, 1/sqrt(var + eps)),
    both f32 [B, C], with the biased variance of the centered values in f32."""
    var, mu = torch.var_mean(_wide(x_BTC), dim=1, correction=0)
    return mu, torch.rsqrt(var + eps)


def apply_norm_act(
    x_BTC: torch.Tensor, mu: torch.Tensor, inv: torch.Tensor, act: Callable[[torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """``act((x - mu) * inv)`` in f32, returned in ``x``'s dtype."""
    return act((_wide(x_BTC) - mu[:, None, :]) * inv[:, None, :]).to(x_BTC.dtype)
