"""Plain PyTorch reference of the published training step: the input
transport's decode, the polarity flip, the modality dropout, the forward
with its dropout, the cross-entropy, the global-norm clip and AdamW.

The step's random draws follow the published recipe's semantics and are
made again here from the run's seed: a seed per epoch and three per step
(``numpy.random.SeedSequence``), a ``torch.Generator`` on the batch's device
for the flip (one ``rand((B, 1))`` per signal, in the batch's order) and
for the modality dropout (``rand((B, C))`` for the keeps, then for the
Gumbel draw of the survivor), and the device's default generator, seeded
with the third, for dropout. Nothing here comes from the program.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import model as ref

LOG256 = math.log(256.0)


def epoch_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def step_seeds(seed: int, step: int) -> tuple[int, int, int]:
    """Seeds of the flip, the modality dropout and dropout at ``step``."""
    return tuple(int(s) for s in np.random.SeedSequence([seed, step]).generate_state(3))


def q8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """The training transport's mu-law int8 codes of each row, against the
    row's own peak, decoded back to f32; an all ``-inf`` row stays so."""
    absent = torch.isinf(x).all(dim=1)
    xd = torch.where(torch.isinf(x), 0.0, x).double()
    peak = xd.abs().amax(dim=1, keepdim=True)
    t = 1.0 + torch.clamp(xd.abs() * (255.0 / torch.where(peak > 0, peak, 1.0)), max=255.0)
    code = torch.round(127.0 * torch.log(t) / LOG256) * torch.sign(xd)
    c = code.float()
    out = torch.sign(c) * torch.expm1(c.abs() * (LOG256 / 127.0)) * (1.0 / 255.0) * peak.float()
    return torch.where(absent[:, None], -torch.inf, out)


def flip(gen: torch.Generator, x: dict) -> dict:
    out = {}
    for n, t in x.items():
        f = torch.rand((t.shape[0], 1), generator=gen, device=t.device) < 0.5
        out[n] = t * torch.where(f, -1.0, 1.0)
    return out


def modality_dropout(gen: torch.Generator, x: dict, dropouts: dict, backups) -> dict:
    """Drop each (night, signal) with its probability; a night that would
    lose every signal keeps one survivor, drawn by Gumbel-max among its
    present backups (or, without backups, its present signals weighted by
    their keep probability); with none, it keeps what it had."""
    names = list(x)
    dev = x[names[0]].device
    B = x[names[0]].shape[0]
    missing = torch.stack([torch.isinf(x[n][:, 0]) for n in names], dim=-1)
    p = torch.tensor([dropouts.get(n, 0.0) for n in names], dtype=torch.float32, device=dev)
    if backups is not None:
        eligible = torch.tensor([n in backups for n in names], device=dev)
        w = (~missing & eligible).float()
    else:
        w = (~missing).float() * (1.0 - p)
    keep = torch.rand((B, len(names)), generator=gen, device=dev) < (1.0 - p)
    u = torch.rand((B, len(names)), generator=gen, device=dev)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    scores = torch.where(w > 0, torch.log(w.clamp_min(1e-30)) + g, -torch.inf)
    survivor = torch.nn.functional.one_hot(scores.argmax(dim=-1), len(names)).bool()
    none_left = (missing | ~keep).all(dim=-1)
    has_backup = w.sum(dim=-1) > 0
    m = torch.where((none_left & has_backup)[:, None], survivor, keep)
    m = torch.where((none_left & ~has_backup)[:, None], ~missing, m)
    return {n: torch.where(m[:, i, None], x[n], -torch.inf) for i, n in enumerate(names)}


class DropoutReplay:
    """Dropout that draws its keep masks from the device's default
    generator, one draw of the tensor's size per call and in the program's
    activation dtype, and scales the kept values by 1/(1 - p) in f32."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def __call__(self, t: torch.Tensor, p: float) -> torch.Tensor:
        keep = torch.nn.functional.dropout(torch.ones(t.shape, dtype=self.dtype, device=t.device), p, True) != 0
        return t * keep * (1.0 / (1.0 - p))


@contextlib.contextmanager
def seeded_default_generator(device: torch.device, seed: int):
    cuda = device.type == 'cuda'
    idx = (device.index if device.index is not None else torch.cuda.current_device()) if cuda else None
    with torch.random.fork_rng(devices=[idx] if cuda else []):
        if cuda:
            torch.cuda.default_generators[idx].manual_seed(seed)
        else:
            torch.random.default_generator.manual_seed(seed)
        yield


def expdecay_lr(lr_max: float, warmup: int, tau: float):
    """Linear warm-up then exponential decay, at the 0-based update count."""

    def lr(count: int) -> float:
        step = count + 1
        return lr_max * step / warmup if step <= warmup else lr_max * math.exp(-(step - warmup) / tau)

    return lr


class AdamWRef:
    """Global-norm clip (scale by clip / |g| where |g| >= clip), then AdamW
    with bias corrections, eps outside the root and decoupled decay."""

    def __init__(self, lr, weight_decay=1e-4, clip=1.0, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.clip, self.b1, self.b2, self.eps = lr, weight_decay, clip, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; returns the gradients as applied."""
        if self.mu is None:
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
        scale = self.clip / norm if self.clip is not None and norm >= self.clip else 1.0
        c = self.count + 1
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        bc1, bc2 = 1.0 - self.b1 ** c, 1.0 - self.b2 ** c
        applied = {}
        for n, p in params.items():
            g = grads[n] * scale
            applied[n] = g
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps) + self.wd * p
            p.sub_(lr * upd)
        self.count += 1
        return applied


def train_step(P: dict, opt: AdamWRef, x: dict, y: torch.Tensor, cfg: dict, seeds: tuple[int, int, int],
               transport: str | None, act_dtype: torch.dtype, precision: str = 'f32',
               rows: slice = slice(None)) -> tuple[float, dict]:
    """One step on the host batch ``x`` ({signal: f32 [B, T]} on the
    device), labels ``y`` [B, S]: decode, flip, modality dropout, forward
    with dropout, loss, gradients, clip, AdamW. ``rows`` keeps a part of the
    batch for the loss (a fault of the harness's tests). Returns (loss,
    the gradients as the optimizer applied them)."""
    dev = y.device
    seed_flip, seed_mask, seed_drop = seeds
    if transport == 'q8':
        x = {n: q8_roundtrip(t) for n, t in x.items()}
    x = flip(torch.Generator(device=dev).manual_seed(seed_flip), x)
    mk = cfg['masker']
    x = modality_dropout(torch.Generator(device=dev).manual_seed(seed_mask), x, mk['dropouts'], mk['backups'])
    leaves = {n: p.detach().requires_grad_(True) for n, p in P.items()}
    with seeded_default_generator(dev, seed_drop), torch.enable_grad(), ref.Arith(precision).flags():
        logits = ref.forward(leaves, x, cfg, precision, dropout=DropoutReplay(act_dtype))
        loss = ref.cross_entropy(logits[rows], y[rows])
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    applied = opt.step(P, dict(zip(P, grads)))
    return float(loss.detach()), applied
