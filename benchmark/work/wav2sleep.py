"""FLOPs of one wav2sleep forward at a configuration's shapes: every
product (convs, linears, attention), 2 FLOPs a multiply-add; norms,
activations and softmax are left out."""

from __future__ import annotations

from ..reference.model import encoder_channels


def forward_flops(cfg: dict, B: int) -> int:
    S = cfg['epochs_per_night']
    Fd = cfg['feature_dim']
    total = 0
    for spe in cfg['signals'].values():
        T, cin = S * spe, 1
        for ch in encoder_channels(cfg, spe):
            t2 = (T - 1) // 2 + 1
            total += 2 * 3 * cin * ch * T + 2 * 3 * ch * ch * T + 2 * 3 * ch * ch * t2  # conv1, conv2, conv3
            total += 2 * cin * ch * t2  # the 1x1 stride-2 residual
            T, cin = t2, ch
        total += 2 * S * (T // S * cin) * Fd  # the encoder's linear over [S, 4C]
    em = cfg['epoch_mixer']
    D = em['register_tokens'] + 1 + len(cfg['signals'])
    per_set = 2 * D * Fd * 3 * Fd + 2 * 2 * D * D * Fd + 2 * D * Fd * Fd + 2 * 2 * D * Fd * em['dim_ff']
    total += S * em['layers'] * per_set
    sm = cfg['sequence_mixer']
    total += sm['num_layers'] * sm['num_dilations'] * 2 * S * Fd * Fd * sm['kernel_size']
    total += 2 * S * Fd * cfg['num_classes']
    return B * total
