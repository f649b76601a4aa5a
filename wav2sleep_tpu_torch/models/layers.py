"""1-D convolutional building blocks on channels-last ``[N, T, C]`` tensors.

Ports of ``wav2sleep_tpu/models/layers.py``. Parameters carry the reference
torch names and shapes (``conv.weight`` ``[C_out, C_in, k]``,
``downsample.weight``; ``conv.weight_v`` and ``conv.weight_g`` under weight
norm), so reference ``state_dict``s load unchanged.

Causality (the reference's contract, JAX ``layers.py:9-12``): a causal conv
pads ``(k - 1) * dilation`` on both sides and trims ``max(pad - (stride -
1), 0)`` samples from the right after the conv, which keeps the norm
statistics unskewed and aligns the stride-2 residual.

Kernel dispatch: in a non-causal instance-norm encoder (``use_kernel``),
every k=3, pad-(1,1), dilation-1 conv with 8 <= C_in <= 128 and
C_out in {16, 32, 64, 128} runs through ``ops.conv_k3`` (K1) — the convs the
JAX package runs through its Pallas kernel on the TPU. ``ConvBlock1D`` keeps
the JAX package's fused chain: each conv's input read applies the previous
conv's instance norm and activation, so the normalized maps are never
written out. With kernel statistics on (``block_domain.kernel_stats_enabled``)
those convs run K2 (``ops.conv_k3.conv_k3_stats``), which also returns the
statistics of its output; ``block_stats`` then runs only for the convs
without a kernel. The entry conv (C_in = 1) and the 1x1 stride-2 residual
stay plain torch, as they are XLA (not Pallas) in the JAX package.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.block_domain import apply_norm_act, block_stats, kernel_stats_enabled
from ..ops.conv_k3 import C_IN_RANGE, SUPPORTED_C_OUT, conv_k3, conv_k3_stats
from .activations import get_activation
from .norms import frozen_running_stats, get_norm


def rematerialised(block: nn.Module, x_NTC: torch.Tensor) -> torch.Tensor:
    """``block(x_NTC)`` keeping only its input for the backward, which runs
    the block again (``torch.utils.checkpoint``). The recompute draws no
    random numbers (the blocks that run this way have no dropout) and
    leaves batch norm's running statistics as the forward left them. It
    reads the module's own parameters: under a bf16 ``functional_call``
    those are the f32 masters, and every conv and norm casts its parameters
    to its input's dtype, so the recomputed values are the forward's."""
    return checkpoint(
        block, x_NTC, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), frozen_running_stats(block)),
    )


class Conv1D(nn.Module):
    """Bare 1-D convolution with explicit (left, right) padding.

    The weights are cast to the input's dtype, as the JAX package casts its
    conv kernels: f32 parameters run a bf16 conv on bf16 activations.
    ``fused_in=(mu, inv, act)`` makes the conv read ``act((x - mu) * inv)``
    (per-(batch, channel) f32 statistics) instead of ``x``.

    ``weight_norm=True`` holds a direction ``weight_v`` [C_out, C_in, k]
    and a magnitude ``weight_g`` [C_out, 1, 1] (torch ``weight_norm``'s
    names at dim 0); the conv's weight is ``v / sqrt(sum(v^2) + 1e-12) *
    g`` per output channel, the JAX package's formula.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        padding: tuple[int, int] = (0, 0),
        dilation: int = 1,
        use_bias: bool = True,
        use_kernel: bool = False,
        weight_norm: bool = False,
    ):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, tuple(padding), dilation
        shape = (features, in_features, kernel_size)
        bound = 1.0 / math.sqrt(in_features * kernel_size)
        if weight_norm:
            self.weight_v = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
            self.weight_g = nn.Parameter(torch.ones(features, 1, 1))
        else:
            self.weight = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.kernel_eligible = (
            use_kernel
            and not weight_norm
            and kernel_size == 3
            and self.padding == (1, 1)
            and dilation == 1
            and stride in (1, 2)
            and C_IN_RANGE[0] <= in_features <= C_IN_RANGE[1]
            and features in SUPPORTED_C_OUT
        )

    def kernel(self) -> torch.Tensor:
        """The conv's weight [C_out, C_in, k]."""
        if not hasattr(self, 'weight_v'):
            return self.weight
        v = self.weight_v
        return v / torch.sqrt(v.square().sum(dim=(1, 2), keepdim=True) + 1e-12) * self.weight_g

    def forward(self, x_NTC: torch.Tensor, fused_in=None) -> torch.Tensor:
        w = self.kernel().to(x_NTC.dtype)
        b = None if self.bias is None else self.bias.to(x_NTC.dtype)
        mu, inv, act = fused_in if fused_in is not None else (None, None, None)
        if self.kernel_eligible:
            return conv_k3(x_NTC.contiguous(), w.permute(2, 1, 0).contiguous(), b, mu, inv, self.stride, act)
        if fused_in is not None:
            x_NTC = apply_norm_act(x_NTC, mu, inv, get_activation(act))
        if w.shape[2] == 1 and self.padding == (0, 0):
            # A 1x1 conv (the blocks' stride-2 residual) is a product over
            # channels of every stride-th step, as the JAX package's TPU
            # path computes it. On the card it runs faster than F.conv1d of
            # the [B, C, T] view; on the CPU it keeps off torch 2.13.0+cpu's
            # multithreaded conv1d backward, which corrupts the heap at
            # C_in 1, k 1, stride 2.
            return F.linear(x_NTC[:, :: self.stride], w[:, :, 0], b)
        x = F.pad(x_NTC.transpose(1, 2), self.padding)
        y = F.conv1d(x, w, b, self.stride, dilation=self.dilation)
        return y.transpose(1, 2)

    def forward_with_stats(self, x_NTC: torch.Tensor, eps: float, fused_in=None):
        """``(y, mu, inv)``: the conv's output and its instance-norm
        statistics, from K2 where the conv has a kernel and kernel
        statistics are on, else from ``block_stats`` over ``y``."""
        if self.kernel_eligible and kernel_stats_enabled():
            w = self.weight.to(x_NTC.dtype).permute(2, 1, 0).contiguous()
            b = None if self.bias is None else self.bias.to(x_NTC.dtype)
            mu, inv, act = fused_in if fused_in is not None else (None, None, None)
            return conv_k3_stats(x_NTC.contiguous(), w, b, mu, inv, self.stride, act, eps)
        y = self(x_NTC, fused_in)
        return (y, *block_stats(y, eps))


class ConvLayer1D(nn.Module):
    """Conv + norm + activation. A causal layer pads ``(k - 1) * dilation``
    on both sides and trims the right after the conv; ``norm='weight'``
    reparameterises the conv and adds no module; the conv has a bias where
    there is no norm. (The JAX layer's dropout is left out: no model of
    either package sets it.)"""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 1,
        dilation: int = 1,
        causal: bool = False,
        activation: str = 'gelu',
        use_bias: bool = False,
        norm: str | None = 'instance',
        norm_eps: float | None = None,
        use_kernel: bool = False,
    ):
        super().__init__()
        pad = (kernel_size - 1) * dilation if causal else padding
        self.trim = max(pad - (stride - 1), 0) if causal else 0
        self.conv = Conv1D(
            in_features, features, kernel_size, stride, (pad, pad), dilation,
            use_bias=use_bias or norm is None, use_kernel=use_kernel and not causal,
            weight_norm=norm == 'weight',
        )
        self.norm = None if norm == 'weight' else get_norm(norm, features, norm_eps)
        self.act = get_activation(activation)

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        out = self.conv(x_NTC)
        if self.trim:
            out = out[:, : out.shape[1] - self.trim]
        if self.norm is not None:
            out = self.norm(out)
        return self.act(out)


class ConvBlock1D(nn.Module):
    """Three k=3 conv layers, the third at stride 2, plus a 1x1 stride-2
    residual projection. A non-causal instance-norm block runs the fused
    chain (each conv reads the previous one's norm and activation); every
    other block runs its three layers as they are, as the JAX package
    does."""

    def __init__(
        self,
        in_features: int,
        features: int,
        activation: str = 'gelu',
        norm: str | None = 'instance',
        norm_eps: float | None = None,
        use_residual: bool = True,
        use_kernel: bool = False,
        causal: bool = False,
    ):
        super().__init__()

        def make(cin: int, stride: int) -> ConvLayer1D:
            return ConvLayer1D(
                cin, features, 3, stride, 1, causal=causal, activation=activation, norm=norm, norm_eps=norm_eps,
                use_kernel=use_kernel,
            )

        self.conv1, self.conv2, self.conv3 = make(in_features, 1), make(features, 1), make(features, 2)
        self.downsample = (
            Conv1D(in_features, features, 1, stride=2, use_bias=False) if use_residual else None
        )
        self.activation = activation
        self.act = get_activation(activation)
        self.fused = norm == 'instance' and not causal
        self.eps = norm_eps if norm_eps is not None else 1e-5

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        if self.fused:
            # Each c_i is a PRE-norm conv output; its instance norm and
            # activation are applied inside the next conv's input read.
            c1, mu, inv = self.conv1.conv.forward_with_stats(x_NTC, self.eps)
            c2, mu, inv = self.conv2.conv.forward_with_stats(c1, self.eps, (mu, inv, self.activation))
            c3, mu, inv = self.conv3.conv.forward_with_stats(c2, self.eps, (mu, inv, self.activation))
            out = apply_norm_act(c3, mu, inv, self.act)
        else:
            out = self.conv3(self.conv2(self.conv1(x_NTC)))
        if self.downsample is not None:
            out = out + self.downsample(x_NTC)
        return self.act(out)


class DilatedConvBlock(nn.Module):
    """Residual stack of dilated conv layers with dilations ``2**i``."""

    def __init__(
        self,
        feature_dim: int = 128,
        dropout: float = 0.2,
        activation: str = 'gelu',
        norm: str | None = 'layer',
        kernel_size: int = 7,
        causal: bool = False,
        num_dilations: int = 6,
    ):
        super().__init__()
        layers = []
        for i in range(num_dilations):
            dilation = 2**i
            k_eff = kernel_size + (kernel_size - 1) * (dilation - 1)
            layers.append(
                ConvLayer1D(
                    feature_dim, feature_dim, kernel_size, 1, k_eff // 2, dilation,
                    causal=causal, activation=activation, norm=norm,
                )
            )
        self.conv_layers = nn.ModuleList(layers)
        self.drop = nn.Dropout(dropout)
        self.act = get_activation(activation)

    def forward(self, x_NTC: torch.Tensor) -> torch.Tensor:
        out = x_NTC
        for layer in self.conv_layers:
            out = layer(out)
        return self.act(self.drop(out) + x_NTC)
