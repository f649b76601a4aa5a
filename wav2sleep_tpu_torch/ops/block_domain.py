"""Instance-norm statistics and their application, for the fused encoder chain.

The math of ``wav2sleep_tpu/ops/block_domain.py`` (``block_stats`` and
``apply_norm_act``) as plain reductions over time on channels-last
``[B, T, C]`` maps, and the rule for where the fused chain takes
kernel-emitted statistics instead (``kernel_stats_enabled``). The JAX
module's 128-lane block packing is a TPU layout device and is not carried
over.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

# Where the encoders' fused conv chain takes a conv's instance-norm
# statistics from K2 (``ops/conv_k3.conv_k3_stats``, an epilogue of the conv)
# instead of a separate ``block_stats`` pass over its output. None, the
# default, decides per call: K2 where autograd records nothing for the call
# (grad mode off, or no input requires grad), as in serving and evaluation,
# and ``block_stats`` where a backward follows, since K2's backward reruns
# ``block_stats`` in plain ops. True, or ``WAV2SLEEP_KERNEL_STATS`` set,
# forces K2; False forces ``block_stats``.
KERNEL_STATS: bool | None = None


def kernel_stats_enabled(*inputs: torch.Tensor | None) -> bool:
    """Whether a fused-chain conv over ``inputs`` (its input, parameters and
    input statistics) takes its statistics from K2."""
    if KERNEL_STATS is not None:
        return KERNEL_STATS
    if os.environ.get('WAV2SLEEP_KERNEL_STATS'):
        return True
    return not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs))


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
