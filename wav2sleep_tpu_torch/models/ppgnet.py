"""SleepPPG-Net, the unimodal baseline, as a ``torch.nn.Module``.

Port of ``wav2sleep_tpu/models/ppgnet.py`` (Kotzen et al. 2023, adapting
Sridhar et al. 2020): a fixed ten-hour input of 1,228,800 samples (1,024
per 30 s epoch), 8 stride-2 conv blocks (channels 16..256), a
time-distributed dense layer to ``feature_dim``, two dilated conv blocks and
a linear classifier giving 1,200 per-epoch logits.

Module names give the reference torch ``state_dict`` keys
(``conv_block.model.{i}.conv1.conv.weight``, ``dense.linear.weight``,
``dilated_convs.{i}.conv_layers.{j}.norm.running_mean``,
``classifier.weight``). The convs are plain torch: the JAX package runs no
Pallas kernel in this model.
"""

from __future__ import annotations

import torch
from torch import nn

from .activations import get_activation
from .layers import ConvBlock1D, DilatedConvBlock, rematerialised
from .wav2sleep import init_parameters

WINDOW_CHANNELS = (16, 16, 32, 32, 64, 64, 128, 256)


class _Blocks(nn.Module):
    """The window encoder's blocks, under the reference's ``model`` name."""

    def __init__(self, blocks: list[nn.Module]):
        super().__init__()
        self.model = nn.ModuleList(blocks)


class _Dense(nn.Module):
    """The time-distributed dense layer, under the reference's ``linear`` name."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Promote to the parameters' dtype, as the JAX package's Dense does.
        return self.linear(x.to(torch.promote_types(x.dtype, self.linear.weight.dtype)))


class SleepPPGNet(nn.Module):
    """SleepPPG-Net for sleep staging from one waveform: [B, 1228800] ->
    logits [B, 1200, n_classes].

    ``remat`` recomputes each window block in the backward pass, when the
    module is training and grad is enabled (``layers.rematerialised``).
    """

    INPUT_LENGTH = 1_228_800  # 10 h at 1,024 samples per 30 s epoch.

    def __init__(
        self,
        n_classes: int = 4,
        feature_dim: int = 128,
        dropout: float = 0.2,
        activation: str = 'leaky',
        norm: str = 'batch',
        remat: bool = False,
    ):
        super().__init__()
        self.n_classes = self.num_classes = n_classes
        self.remat = remat
        blocks, cin = [], 1
        for ch in WINDOW_CHANNELS:
            blocks.append(ConvBlock1D(cin, ch, activation=activation, norm=norm))
            cin = ch
        self.conv_block = _Blocks(blocks)
        self.dense = _Dense(4 * WINDOW_CHANNELS[-1], feature_dim)
        self.dilated_convs = nn.ModuleList(
            DilatedConvBlock(feature_dim, dropout, activation, norm) for _ in range(2)
        )
        self.classifier = nn.Linear(feature_dim, n_classes)

    causal = False

    @property
    def valid_signals(self) -> list[str]:
        """The one signal the model takes."""
        return ['PPG']

    def forward(self, x_BT: torch.Tensor) -> torch.Tensor:
        if x_BT.shape[1] != self.INPUT_LENGTH:
            raise ValueError(f'Input tensor had unexpected shape: {tuple(x_BT.shape)}')
        y = x_BT[:, :, None]
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.conv_block.model:
            y = rematerialised(block, y) if remat else block(y)
        # [B, 4800, 256] -> [B, 1200, 1024] -> [B, 1200, F].
        y = get_activation('leaky')(self.dense(y.reshape(y.shape[0], 1200, 4 * WINDOW_CHANNELS[-1])))
        for block in self.dilated_convs:
            y = block(y)
        return self.classifier(y)


def build_ppgnet(generator: torch.Generator | None = None, **kwargs) -> SleepPPGNet:
    """``SleepPPGNet(**kwargs)`` with the seeded init of
    ``wav2sleep.init_parameters`` (seed 0 without ``generator``)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    return init_parameters(SleepPPGNet(**kwargs), generator)
