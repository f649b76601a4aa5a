"""wav2sleep model family as ``torch.nn.Module``s on channels-last tensors.

Port of ``wav2sleep_tpu/models/wav2sleep.py``:

1. Per-signal CNN encoders reduce each waveform ``[B, T]`` to one feature
   vector per 30 s sleep epoch (``SignalEncoder``).
2. Set attention over the modality tokens of each epoch, through a CLS
   token (``MultiModalAttentionEmbedder``).
3. A dilated CNN over the night's epochs (``SequenceCNN``).
4. A linear classifier to per-epoch sleep-stage logits.

Missing-modality contract: an absent signal is an all ``-inf`` row (or is
marked absent in ``present``). Encoders zero it, run, and re-mark their
output with ``-inf``; the epoch mixer turns that into a key-padding mask so
attention never reads absent modalities.

Module and parameter names give the reference torch ``state_dict`` keys
(e.g. ``signal_encoders.encoders.ECG.cnn.0.conv1.conv.weight``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..settings import COLS_TO_SAMPLES_PER_EPOCH
from ..utils import resolve_device
from .activations import get_activation
from .layers import Conv1D, ConvBlock1D, DilatedConvBlock, rematerialised
from .norms import ConvLayerNorm
from .transformer import MultiHeadSelfAttention, TransformerEncoder


class SignalEncoder(nn.Module):
    """Per-modality CNN encoder: waveform [B, T] -> [B, S, feature_dim].

    ``log2(samples_per_epoch) - 2`` stride-2 blocks reduce each epoch to 4
    positions; channels double every other block up to ``max_channels``.

    ``causal`` with ``chunk_causal`` runs each 30 s epoch alone (the blocks
    see [B * S, samples_per_epoch, 1]); ``causal`` alone makes every conv
    causal. ``norm='auto'`` is instance norm for blocks 0-1, then layer
    norm. Instance norm uses eps 1e-2. K1 serves only a non-causal
    instance-norm encoder, as the JAX package's Pallas path does.

    ``remat`` recomputes each block's activations in the backward pass
    instead of keeping them (``torch.utils.checkpoint``), when the module is
    training and grad is enabled; only the blocks' inputs stay live. The
    early ECG/PPG blocks hold [B, ~1.2M, C] maps, so this is what lets a
    full-night batch train in the card's memory. Serving ignores it.
    """

    def __init__(
        self,
        feature_dim: int = 256,
        samples_per_epoch: int = 1024,
        activation: str = 'gelu',
        norm: str = 'instance',
        initial_channels: int = 16,
        max_channels: int = 128,
        causal: bool = False,
        chunk_causal: bool = True,
        output_norm: bool = False,
        use_residual: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        if samples_per_epoch & (samples_per_epoch - 1):
            raise ValueError(f'samples_per_epoch must be a power of 2, got {samples_per_epoch}')
        self.samples_per_epoch = samples_per_epoch
        self.remat = remat
        self.chunked = causal and chunk_causal
        num_blocks = int(math.log2(samples_per_epoch)) - 2
        channels = [min(initial_channels * 2 ** (i // 2), max_channels) for i in range(num_blocks)]
        self.epoch_dim = channels[-1] * 4
        blocks, cin = [], 1
        for i, ch in enumerate(channels):
            norm_i = ('instance' if i < 2 else 'layer') if norm == 'auto' else norm
            blocks.append(
                ConvBlock1D(
                    cin, ch, activation=activation, norm=norm_i,
                    # Larger instance-norm eps prevents NaN on low-variance maps.
                    norm_eps=1e-2 if norm_i == 'instance' else None,
                    use_residual=use_residual,
                    use_kernel=norm == 'instance' and not causal,
                    causal=causal and not chunk_causal,
                )
            )
            cin = ch
        self.cnn = nn.ModuleList(blocks)
        self.linear = nn.Linear(self.epoch_dim, feature_dim)
        self.act = get_activation(activation)
        self.output_norm = nn.LayerNorm(feature_dim, eps=1e-5) if output_norm else None

    def forward(self, x_BT: torch.Tensor) -> torch.Tensor:
        B, T = x_BT.shape
        if T % self.samples_per_epoch:
            raise ValueError(f'Input length {T} must be divisible by samples_per_epoch={self.samples_per_epoch}.')
        spe = self.samples_per_epoch
        y = x_BT.reshape(B * (T // spe), spe, 1) if self.chunked else x_BT[:, :, None]
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.cnn:
            y = rematerialised(block, y) if remat else block(y)
        # [B, 4S, C] (or [B * S, 4, C]) -> [B, S, 4C]: the reference's
        # transpose + reshape order.
        y = y.reshape(B, T // self.samples_per_epoch, self.epoch_dim)
        # Promote to the parameters' dtype, as the JAX package's Dense does:
        # with f32 parameters, bf16 serving runs everything after here in f32.
        y = self.act(self.linear(y.to(torch.promote_types(y.dtype, self.linear.weight.dtype))))
        return self.output_norm(y) if self.output_norm is not None else y


class SignalEncoders(nn.Module):
    """Registry of per-signal encoders; several signals may share one."""

    def __init__(
        self,
        signal_map: dict[str, str],
        feature_dim: int,
        activation: str,
        norm: str = 'instance',
        causal: bool = False,
        chunk_causal: bool = True,
        embed_signals: bool = False,
        initial_channels: int = 16,
        max_channels: int = 128,
        output_norm: bool = False,
        use_residual: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        self.signal_map = dict(signal_map)
        self.causal = causal
        self.encoders = nn.ModuleDict()
        for signal_name, encoder_name in self.signal_map.items():
            if encoder_name in self.encoders:
                continue
            if signal_name not in COLS_TO_SAMPLES_PER_EPOCH:
                raise ValueError(f"Column {signal_name} unrecognised. Doesn't have a sampling rate.")
            self.encoders[encoder_name] = SignalEncoder(
                feature_dim, COLS_TO_SAMPLES_PER_EPOCH[signal_name], activation, norm,
                initial_channels, max_channels, causal, chunk_causal, output_norm, use_residual, remat,
            )
        self.sig_to_embedding_idx = {sig: i for i, sig in enumerate(sorted(self.signal_map))}
        self.embedder = nn.Embedding(len(self.signal_map), feature_dim) if embed_signals else None

    def forward(
        self, x: dict[str, torch.Tensor], present: dict[str, torch.Tensor] | None = None
    ) -> dict[str, torch.Tensor]:
        z_dict = {}
        for signal_name, x_BT in x.items():
            mask_B = torch.isinf(x_BT[:, 0])
            if present is not None and signal_name in present:
                mask_B = mask_B | ~present[signal_name]
            x_BT = torch.where(torch.isinf(x_BT), 0.0, x_BT)
            z_BSF = self.encoders[self.signal_map[signal_name]](x_BT)
            z_BSF = torch.where(mask_B[:, None, None], -torch.inf, z_BSF)
            if self.embedder is not None:
                z_BSF = z_BSF + self.embedder.weight[self.sig_to_embedding_idx[signal_name]]
            z_dict[signal_name] = z_BSF
        return z_dict


class MultiModalAttentionEmbedder(nn.Module):
    """Set attention over the modality tokens of each sleep epoch; returns the
    CLS token's output per epoch."""

    def __init__(
        self,
        feature_dim: int,
        layers: int = 4,
        dropout: float = 0.0,
        dim_ff: int = 512,
        activation: str = 'gelu',
        nhead: int = 4,
        register_tokens: int = 0,
        norm_first: bool = True,
    ):
        super().__init__()
        self.feature_dim = feature_dim
        self.register_tokens = nn.Parameter(torch.randn(1, 1, feature_dim, register_tokens + 1))
        self.transformer_encoder = TransformerEncoder(
            feature_dim, nhead, layers, dim_ff, dropout, activation, norm_first
        )

    def forward(self, z_dict: dict[str, torch.Tensor]) -> torch.Tensor:
        signals = sorted(z_dict)
        if not signals:
            raise ValueError('No signals provided to MultiModalAttentionEmbedder.')
        z_stack, m_stack = [], []
        for signal_name in signals:
            z_BSF = z_dict[signal_name]
            m_B = torch.isinf(z_BSF).any(dim=2).any(dim=1)
            z_stack.append(torch.where(m_B[:, None, None], 0.0, z_BSF))
            m_stack.append(m_B)
        z_BSFC = torch.stack(z_stack, dim=-1)
        m_BC = torch.stack(m_stack, dim=-1)  # True where the signal is absent.
        B, S, feat, C = z_BSFC.shape
        if feat != self.feature_dim:
            raise ValueError(f'Feature dimension {feat} does not match feature_dim={self.feature_dim}.')
        R1 = self.register_tokens.shape[-1]
        reg = self.register_tokens.to(z_BSFC.dtype).expand(B, S, feat, R1)
        z_BSFD = torch.cat([reg, z_BSFC], dim=-1)
        D = R1 + C
        # CLS / register tokens are always attendable.
        m_BD = torch.cat([torch.zeros(B, R1, dtype=torch.bool, device=m_BC.device), m_BC], dim=-1)
        z_NDF = z_BSFD.reshape(B * S, feat, D).transpose(1, 2)
        m_ND = m_BD[:, None, :].expand(B, S, D).reshape(B * S, D)
        z_NDF = self.transformer_encoder(z_NDF, key_padding_mask=m_ND)
        return z_NDF[:, 0, :].reshape(B, S, feat)  # CLS token per epoch.


class SequenceCNN(nn.Module):
    """Dilated CNN over the night's epoch sequence, on [B, S, F]."""

    def __init__(
        self,
        feature_dim: int = 128,
        dropout: float = 0.2,
        num_layers: int = 2,
        activation: str = 'gelu',
        norm: str | None = 'layer',
        causal: bool = False,
        num_dilations: int = 6,
        kernel_size: int = 7,
    ):
        super().__init__()
        self.dilated_convs = nn.ModuleList(
            DilatedConvBlock(feature_dim, dropout, activation, norm, kernel_size, causal, num_dilations)
            for _ in range(num_layers)
        )

    def forward(self, x_BSF: torch.Tensor) -> torch.Tensor:
        for block in self.dilated_convs:
            x_BSF = block(x_BSF)
        return x_BSF


class Wav2Sleep(nn.Module):
    """Top-level sleep staging model: dict of [B, T_sig] -> logits [B, S, K]."""

    def __init__(
        self,
        signal_encoders: SignalEncoders,
        epoch_mixer: MultiModalAttentionEmbedder,
        sequence_mixer: SequenceCNN,
        num_classes: int,
    ):
        super().__init__()
        self.signal_encoders = signal_encoders
        self.epoch_mixer = epoch_mixer
        self.sequence_mixer = sequence_mixer
        self.num_classes = num_classes
        self.classifier = nn.Linear(epoch_mixer.feature_dim, num_classes)

    @property
    def valid_signals(self) -> list[str]:
        """The signals the model takes, in its config's order."""
        return list(self.signal_encoders.signal_map)

    @property
    def causal(self) -> bool:
        """Whether the encoders are causal (per epoch, or conv by conv)."""
        return self.signal_encoders.causal

    def forward(
        self, x: dict[str, torch.Tensor], present: dict[str, torch.Tensor] | None = None
    ) -> torch.Tensor:
        z_dict = self.signal_encoders(x, present=present)
        return self.classifier(self.sequence_mixer(self.epoch_mixer(z_dict)))


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init of every parameter (the JAX package's scheme:
    uniform +-1/sqrt(fan_in) conv and dense kernels and weight-norm
    directions, zero biases, unit norm scales and weight-norm magnitudes,
    N(0, 1) register tokens and signal embeddings). The norms' own
    constructors give the other kinds' unit scales and zero biases."""

    def uniform_fan_in(w):
        bound = 1.0 / math.sqrt(w[0].numel())
        w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)

    for m in model.modules():
        if isinstance(m, Conv1D) and hasattr(m, 'weight_v'):
            uniform_fan_in(m.weight_v)
            m.weight_g.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (Conv1D, nn.Linear)):
            uniform_fan_in(m.weight)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiHeadSelfAttention):
            uniform_fan_in(m.in_proj_weight)
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.LayerNorm, ConvLayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, MultiModalAttentionEmbedder):
            m.register_tokens.copy_(torch.randn(m.register_tokens.shape, generator=generator))
    return model


def build_wav2sleep(
    num_classes: int,
    signal_map: dict[str, str],
    encoders: dict,
    epoch_mixer: dict,
    sequence_mixer: dict,
    generator: torch.Generator | None = None,
) -> Wav2Sleep:
    """Build from the sections of a wav2sleep config (the keyword arguments
    of each sub-module) with a seeded init (seed 0 without ``generator``)."""
    model = Wav2Sleep(
        SignalEncoders(signal_map, **encoders),
        MultiModalAttentionEmbedder(**epoch_mixer),
        SequenceCNN(**sequence_mixer),
        num_classes,
    )
    return init_parameters(model, generator if generator is not None else torch.Generator().manual_seed(0))


def flagship_config(feature_dim: int = 128, max_channels: int = 128) -> dict:
    """The flagship cardio architecture of ``__graft_entry__._flagship_model``:
    ECG+PPG+ABD+THX, 4 classes (``max_channels`` narrows it for tests)."""
    return {
        'num_classes': 4,
        'signal_map': {'ABD': 'ABD', 'THX': 'THX', 'ECG': 'ECG', 'PPG': 'PPG'},
        'encoders': {
            'feature_dim': feature_dim, 'activation': 'gelu', 'norm': 'instance', 'causal': False,
            'chunk_causal': False, 'initial_channels': 16, 'max_channels': max_channels,
            'output_norm': False, 'use_residual': True,
        },
        'epoch_mixer': {
            'feature_dim': feature_dim, 'dropout': 0.1, 'activation': 'gelu', 'layers': 2,
            'dim_ff': 512, 'nhead': 8,
        },
        'sequence_mixer': {
            'feature_dim': feature_dim, 'dropout': 0.1, 'activation': 'gelu', 'norm': 'layer',
            'causal': False, 'num_layers': 2, 'kernel_size': 7, 'num_dilations': 6,
        },
    }


def flagship_model(
    feature_dim: int = 128,
    *,
    max_channels: int = 128,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    generator: torch.Generator | None = None,
) -> Wav2Sleep:
    """The flagship model with a seeded random init, in eval mode, on
    ``device`` (the card when None; raises without one) in ``dtype``."""
    device = resolve_device(device)
    cfg = flagship_config(feature_dim, max_channels)
    model = build_wav2sleep(**cfg, generator=generator)
    return model.to(device=device, dtype=dtype).eval()
