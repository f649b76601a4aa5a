"""Work of the encoders' kernel-3 convs (K1): the calls a forward makes at
a configuration's shapes, their bytes and FLOPs, and the least time the
card could take for them.

The byte and FLOP counts are those of ``chip_smoke.py``'s ``conv_work``:
x, w, bias (and the fused input's mu and inv) read once, y (and the
statistics) written once; 2 FLOPs a multiply-add. A conv qualifies when it
is k=3, pad 1, dilation 1, with 8 <= C_in <= 128 and C_out in
{16, 32, 64, 128}, in a non-causal instance-norm encoder: in each block
conv1 (unless C_in is 1, the entry conv), and conv2 and conv3 (stride 2),
which read the previous conv's norm and activation (``fused``).
"""

from __future__ import annotations

from ..reference.model import encoder_channels
from .peaks import bound_ms

C_OUT = (16, 32, 64, 128)
C_IN = (8, 128)


def conv_work(B, T, ci, co, stride, itemsize, fused: bool, stats: bool = False) -> tuple[int, int]:
    """Bytes and FLOPs of one call."""
    t_out = (T - 1) // stride + 1
    n_bytes = (B * T * ci + 3 * ci * co + co + B * t_out * co) * itemsize
    n_bytes += 2 * B * ci * 4 if fused else 0
    n_bytes += 2 * B * co * 4 if stats else 0
    return n_bytes, 2 * 3 * ci * co * t_out * B


def calls(cfg: dict, B: int) -> list[tuple[int, int, int, int, int, bool]]:
    """(B, T, C_in, C_out, stride, fused) of each K1 call of one forward."""
    out = []
    S = cfg['epochs_per_night']
    for spe in cfg['signals'].values():
        T, cin = S * spe, 1
        for ch in encoder_channels(cfg, spe):
            if C_IN[0] <= cin <= C_IN[1] and ch in C_OUT:
                out.append((B, T, cin, ch, 1, False))
            out.append((B, T, ch, ch, 1, True))
            out.append((B, T, ch, ch, 2, True))
            T, cin = (T - 1) // 2 + 1, ch
    return out


def forward_work(cfg: dict, B: int, itemsize: int) -> tuple[int, int]:
    """Bytes and FLOPs of the K1 calls of one forward of batch ``B``."""
    n_bytes = flops = 0
    for b, t, ci, co, s, fused in calls(cfg, B):
        nb, fl = conv_work(b, t, ci, co, s, itemsize, fused)
        n_bytes, flops = n_bytes + nb, flops + fl
    return n_bytes, flops


def forward_bound_ms(cfg: dict, B: int, dtype: str) -> float:
    """Least time of one forward's K1 calls, each call bound alone."""
    item = 4 if dtype == 'float32' else 2
    return sum(bound_ms(*conv_work(b, t, ci, co, s, item, fused), dtype) for b, t, ci, co, s, fused in calls(cfg, B))
