"""Plain reference of the q8 serving transport's device half: the model
input of a night from its mu-law codes and row metadata.

Per (night, signal) row: the digital value ``sign(q) expm1(|q| log(256) /
127) V / 255``, the affine ``a d + b``, zero from ``n_valid`` on, the
z-score (ddof 1, std floored at 1e-6) over the night's whole epochs
(``n_pad``), ``-inf`` from ``n_pad`` on, and a whole row of ``-inf`` for an
absent signal.
"""

from __future__ import annotations

import math

import torch

MU = 255.0


def q8_serving_input(pool: dict, sig: str, idx: list[int], device) -> torch.Tensor:
    codes = torch.as_tensor(pool['codes'][sig][idx], device=device)
    m = {k: torch.as_tensor(v[idx], device=device) for k, v in pool['meta'][sig].items()}
    q = codes.float()
    d = torch.sign(q) * torch.expm1(q.abs() * (math.log1p(MU) / 127.0)) * (m['vmax'][:, None] / MU)
    v = d * m['a'][:, None] + m['b'][:, None]
    iot = torch.arange(v.shape[1], device=device)[None, :]
    v = torch.where(iot < m['n_valid'][:, None], v, 0.0)
    inside = iot < m['n_pad'][:, None]
    cnt = inside.sum(dim=1, keepdim=True).float()
    mu = torch.where(inside, v, 0.0).sum(dim=1, keepdim=True) / cnt.clamp_min(1.0)
    sd = torch.sqrt(torch.where(inside, (v - mu) ** 2, 0.0).sum(dim=1, keepdim=True) / (cnt - 1).clamp_min(1.0))
    z = (v - mu) / sd.clamp_min(1e-6)
    z = torch.where(inside, z, -torch.inf)
    return torch.where(m['present'][:, None], z, -torch.inf)
