"""Transformer encoder with ``nn.TransformerEncoder`` parameter names.

Port of ``wav2sleep_tpu/models/transformer.py``: packed QKV projection
(``in_proj_weight`` [3F, F], ``in_proj_bias``), key-padding masking that
removes masked keys from every query's softmax, LayerNorm eps 1e-5, an
exact-GELU feed-forward, and the pre-norm (``norm_first``, the default) or
post-norm layer. Attention runs over at most a handful of tokens
(modalities + CLS + registers), so it is written as explicit einsums.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation

_NEG_INF = -1e30


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with ``nn.MultiheadAttention``'s parameterization."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f'd_model={d_model} not divisible by nhead={nhead}')
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(d_model, d_model)
        self.drop = nn.Dropout(dropout)

    def forward(self, x_NDF: torch.Tensor, key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        N, D, feat = x_NDF.shape
        head_dim = feat // self.nhead
        q, k, v = F.linear(x_NDF, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def to_heads(t):
            return t.reshape(N, D, self.nhead, head_dim).transpose(1, 2)

        q, k, v = to_heads(q), to_heads(k), to_heads(v)
        scores = torch.einsum('nhqd,nhkd->nhqk', q, k) / math.sqrt(head_dim)
        if key_padding_mask is not None:
            # True => key is masked out for all queries.
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], _NEG_INF)
        attn = self.drop(torch.softmax(scores, dim=-1))
        out = torch.einsum('nhqk,nhkd->nhqd', attn, v).transpose(1, 2).reshape(N, D, feat)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm (``x += attn(norm1(x)); x += ff(norm2(x))``) or, with
    ``norm_first=False``, post-norm (``x = norm1(x + attn(x)); x = norm2(x +
    ff(x))``) transformer encoder layer."""

    def __init__(
        self, d_model: int, nhead: int, dim_ff: int = 512, dropout: float = 0.0, activation: str = 'gelu',
        norm_first: bool = True,
    ):
        super().__init__()
        self.norm_first = norm_first
        self.self_attn = MultiHeadSelfAttention(d_model, nhead, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.act = get_activation(activation)
        self.drop1 = nn.Dropout(dropout)
        self.drop2 = nn.Dropout(dropout)
        self.drop_ff = nn.Dropout(dropout)

    def _sa(self, x_NDF: torch.Tensor, key_padding_mask: torch.Tensor | None) -> torch.Tensor:
        return self.drop1(self.self_attn(x_NDF, key_padding_mask))

    def _ff(self, x_NDF: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.linear2(self.drop_ff(self.act(self.linear1(x_NDF)))))

    def forward(self, x_NDF: torch.Tensor, key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.norm_first:
            x_NDF = x_NDF + self._sa(self.norm1(x_NDF), key_padding_mask)
            return x_NDF + self._ff(self.norm2(x_NDF))
        x_NDF = self.norm1(x_NDF + self._sa(x_NDF, key_padding_mask))
        return self.norm2(x_NDF + self._ff(x_NDF))


class TransformerEncoder(nn.Module):
    """Stack of identical encoder layers (``nn.TransformerEncoder`` names)."""

    def __init__(
        self, d_model: int, nhead: int, num_layers: int, dim_ff: int = 512, dropout: float = 0.0,
        activation: str = 'gelu', norm_first: bool = True,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_ff, dropout, activation, norm_first)
            for _ in range(num_layers)
        )

    def forward(self, x_NDF: torch.Tensor, key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.layers:
            x_NDF = layer(x_NDF, key_padding_mask)
        return x_NDF
