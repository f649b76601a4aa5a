"""Plain PyTorch reference of wav2sleep: its weights' shapes, a seeded init,
the forward pass and the cross-entropy loss.

Written from the published architecture (the wav2sleep paper and the
released configs named in each configuration file), on channels-first
``[B, C, T]`` maps with ``F.conv1d``; it imports nothing of the program under
test. Parameters are a dict keyed by the released torch ``state_dict``
names, so the same tensors load into the program.

``precision`` selects the arithmetic:

- ``'f32'``: float32 throughout, TF32 off (the reference);
- ``'tf32'``: the same with cuDNN's and the matmuls' TF32 on (the control of
  a float32 configuration);
- ``'fp8'``: every operand and every result of a product (conv, linear,
  attention) rounded to float8 e4m3, the sums in float32 (the control of a
  bfloat16 configuration). Under autograd the gradients are rounded too,
  unscaled: a step's gradients lie far under e4m3's least subnormal and
  flush to zero;
- ``'fp8_fwd'``: the forward of ``'fp8'``, the gradients passing each
  rounding unchanged in float32 (a step in fp8 that scales its gradients).

Training mode takes a ``dropout`` callable ``(tensor, p) -> tensor``
(``train.DropoutReplay``): the reference's own dropout draws, made in the
order and at the shapes of the published module tree.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8_MAX = 448.0  # float8 e4m3's largest finite value
NEG_BIG = -1e30  # the attention's key-padding fill


def encoder_channels(cfg: dict, spe: int) -> list[int]:
    """Channels of each block of an encoder over ``spe`` samples an epoch:
    ``log2(spe) - 2`` stride-2 blocks, doubling every other block up to
    ``max_channels``."""
    enc = cfg['encoders']
    n = int(math.log2(spe)) - 2
    return [min(enc['initial_channels'] * 2 ** (i // 2), enc['max_channels']) for i in range(n)]


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the released ``state_dict``'s names."""
    F_ = cfg['feature_dim']
    shapes: dict[str, tuple[int, ...]] = {}
    for sig, spe in cfg['signals'].items():
        pre = f'signal_encoders.encoders.{sig}'
        cin = 1
        chans = encoder_channels(cfg, spe)
        for i, ch in enumerate(chans):
            b = f'{pre}.cnn.{i}'
            shapes[f'{b}.conv1.conv.weight'] = (ch, cin, 3)
            shapes[f'{b}.conv2.conv.weight'] = (ch, ch, 3)
            shapes[f'{b}.conv3.conv.weight'] = (ch, ch, 3)
            shapes[f'{b}.downsample.weight'] = (ch, cin, 1)
            cin = ch
        shapes[f'{pre}.linear.weight'] = (F_, 4 * chans[-1])
        shapes[f'{pre}.linear.bias'] = (F_,)
    em = cfg['epoch_mixer']
    shapes['epoch_mixer.register_tokens'] = (1, 1, F_, em['register_tokens'] + 1)
    for i in range(em['layers']):
        p = f'epoch_mixer.transformer_encoder.layers.{i}'
        shapes[f'{p}.self_attn.in_proj_weight'] = (3 * F_, F_)
        shapes[f'{p}.self_attn.in_proj_bias'] = (3 * F_,)
        shapes[f'{p}.self_attn.out_proj.weight'] = (F_, F_)
        shapes[f'{p}.self_attn.out_proj.bias'] = (F_,)
        for n in ('norm1', 'norm2'):
            shapes[f'{p}.{n}.weight'] = (F_,)
            shapes[f'{p}.{n}.bias'] = (F_,)
        shapes[f'{p}.linear1.weight'] = (em['dim_ff'], F_)
        shapes[f'{p}.linear1.bias'] = (em['dim_ff'],)
        shapes[f'{p}.linear2.weight'] = (F_, em['dim_ff'])
        shapes[f'{p}.linear2.bias'] = (F_,)
    sm = cfg['sequence_mixer']
    for b in range(sm['num_layers']):
        for l in range(sm['num_dilations']):
            p = f'sequence_mixer.dilated_convs.{b}.conv_layers.{l}'
            shapes[f'{p}.conv.weight'] = (F_, F_, sm['kernel_size'])
            shapes[f'{p}.norm.weight'] = (1, F_, 1)
            shapes[f'{p}.norm.bias'] = (1, F_, 1)
    shapes['classifier.weight'] = (cfg['num_classes'], F_)
    shapes['classifier.bias'] = (cfg['num_classes'],)
    return shapes


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded f32 weights, made on ``device`` in two draws: every matrix and
    conv kernel uniform in +-1/sqrt(fan_in) from one ``rand``, the register
    tokens N(0, 1) from one ``randn``; biases 0, norm scales 1. Each row of
    the classifier is centred: the features reaching it share a large
    common part, which would otherwise hand one class every epoch of a
    night whatever the input, and a model whose answer does not depend on
    its input cannot show a wrong one."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = [n for n, s in shapes.items() if len(s) >= 2 and 'register_tokens' not in n and '.norm.' not in n]
    sizes = [math.prod(shapes[n]) for n in mats]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    tokens = torch.randn(shapes['epoch_mixer.register_tokens'], generator=gen, device=device)
    out: dict[str, torch.Tensor] = {}
    for n, part in zip(mats, torch.split(flat, sizes)):
        s = shapes[n]
        bound = 1.0 / math.sqrt(math.prod(s[1:]))
        out[n] = (part * (2 * bound) - bound).reshape(s)
    out['classifier.weight'] -= out['classifier.weight'].mean(dim=1, keepdim=True)
    for n, s in shapes.items():
        if n in out:
            continue
        if 'register_tokens' in n:
            out[n] = tokens
        elif n.endswith('weight'):  # the norms' scales
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    return {n: out[n] for n in shapes}


class Arith:
    """The products of one precision: ``conv`` and ``linear`` and ``einsum``
    on float32 tensors, with their operands and results rounded under 'fp8'."""

    def __init__(self, precision: str = 'f32'):
        if precision not in ('f32', 'tf32', 'fp8', 'fp8_fwd'):
            raise ValueError(f'unknown precision {precision!r}')
        self.precision = precision

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision not in ('fp8', 'fp8_fwd'):
            return t
        r = t.clamp(-F8_MAX, F8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
        return t + (r - t).detach() if self.precision == 'fp8_fwd' and t.requires_grad else r

    def conv(self, x, w, stride=1, padding=0, dilation=1, bias=None):
        return self.q(F.conv1d(self.q(x), self.q(w), bias, stride=stride, padding=padding, dilation=dilation))

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def einsum(self, eq, a, b):
        return self.q(torch.einsum(eq, self.q(a), self.q(b)))

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for 'tf32', off otherwise, for the block only."""
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        on = self.precision == 'tf32'
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _instance_norm(x, eps):
    mu = x.mean(dim=2, keepdim=True)
    var = (x - mu).square().mean(dim=2, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _block(P, b, h, eps, ar: Arith):
    """One encoder block: three k=3 convs (the third at stride 2), each with
    instance norm and GELU, plus the 1x1 stride-2 residual."""
    y = F.gelu(_instance_norm(ar.conv(h, P[f'{b}.conv1.conv.weight'], padding=1), eps))
    y = F.gelu(_instance_norm(ar.conv(y, P[f'{b}.conv2.conv.weight'], padding=1), eps))
    y = F.gelu(_instance_norm(ar.conv(y, P[f'{b}.conv3.conv.weight'], stride=2, padding=1), eps))
    return F.gelu(y + ar.conv(h, P[f'{b}.downsample.weight'], stride=2))


def _encoder(P, pre, x_BT, cfg, spe, ar: Arith):
    """One signal's CNN encoder: [B, T] -> [B, S, F]. Under autograd each
    block keeps only its input and runs again in the backward, so that a
    full-night batch fits the card."""
    eps = cfg['encoders']['norm_eps']
    B, T = x_BT.shape
    h = x_BT[:, None, :]
    for i in range(len(encoder_channels(cfg, spe))):
        b = f'{pre}.cnn.{i}'
        if torch.is_grad_enabled():
            h = checkpoint(_block, P, b, h, eps, ar, use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(P, b, h, eps, ar)
    S = T // spe
    # [B, C, 4S] -> [B, S, 4C], each epoch's four positions then its channels.
    z = h.transpose(1, 2).reshape(B, S, -1)
    return F.gelu(ar.linear(z, P[f'{pre}.linear.weight'], P[f'{pre}.linear.bias']))


def _attention(P, p, x, mask, cfg, ar: Arith, dropout):
    N, D, Fd = x.shape
    nh = cfg['epoch_mixer']['nhead']
    hd = Fd // nh
    q, k, v = ar.linear(x, P[f'{p}.in_proj_weight'], P[f'{p}.in_proj_bias']).chunk(3, dim=-1)
    q, k, v = (t.reshape(N, D, nh, hd).transpose(1, 2) for t in (q, k, v))
    s = ar.einsum('nhqd,nhkd->nhqk', q, k) / math.sqrt(hd)
    s = s.masked_fill(mask[:, None, None, :], NEG_BIG)
    a = torch.softmax(s, dim=-1)
    if dropout is not None:
        a = dropout(a, cfg['epoch_mixer']['dropout'])
    o = ar.einsum('nhqk,nhkd->nhqd', a, v).transpose(1, 2).reshape(N, D, Fd)
    return ar.linear(o, P[f'{p}.out_proj.weight'], P[f'{p}.out_proj.bias'])


def _epoch_mixer(P, z: dict, cfg, ar: Arith, dropout):
    em = cfg['epoch_mixer']
    p_drop = em['dropout']
    names = sorted(z)
    zs, ms = [], []
    for n in names:
        t = z[n]
        m = torch.isinf(t).any(dim=2).any(dim=1)
        zs.append(torch.where(m[:, None, None], 0.0, t))
        ms.append(m)
    Z = torch.stack(zs, dim=-1)  # [B, S, F, C]
    M = torch.stack(ms, dim=-1)  # [B, C], True where absent
    B, S, Fd, C = Z.shape
    reg = P['epoch_mixer.register_tokens']
    R1 = reg.shape[-1]
    X = torch.cat([reg.expand(B, S, Fd, R1), Z], dim=-1).reshape(B * S, Fd, R1 + C).transpose(1, 2)
    mask = torch.cat([torch.zeros(B, R1, dtype=torch.bool, device=M.device), M], dim=-1)
    mask = mask[:, None, :].expand(B, S, R1 + C).reshape(B * S, R1 + C)
    drop = dropout if dropout is not None else (lambda t, p: t)
    for i in range(em['layers']):
        p = f'epoch_mixer.transformer_encoder.layers.{i}'
        h = F.layer_norm(X, (Fd,), P[f'{p}.norm1.weight'], P[f'{p}.norm1.bias'], 1e-5)
        X = X + drop(_attention(P, f'{p}.self_attn', h, mask, cfg, ar, dropout), p_drop)
        h = F.layer_norm(X, (Fd,), P[f'{p}.norm2.weight'], P[f'{p}.norm2.bias'], 1e-5)
        h = drop(F.gelu(ar.linear(h, P[f'{p}.linear1.weight'], P[f'{p}.linear1.bias'])), p_drop)
        X = X + drop(ar.linear(h, P[f'{p}.linear2.weight'], P[f'{p}.linear2.bias']), p_drop)
    return X[:, 0, :].reshape(B, S, Fd)


def _sequence_mixer(P, x_BSF, cfg, ar: Arith, dropout):
    sm = cfg['sequence_mixer']
    k = sm['kernel_size']
    Fd = x_BSF.shape[-1]
    h = x_BSF.transpose(1, 2)  # [B, F, S]
    for b in range(sm['num_layers']):
        out = h
        for l in range(sm['num_dilations']):
            p = f'sequence_mixer.dilated_convs.{b}.conv_layers.{l}'
            d = 2 ** l
            y = ar.conv(out, P[f'{p}.conv.weight'], padding=(k // 2) * d, dilation=d)
            y = F.layer_norm(y.transpose(1, 2), (Fd,), P[f'{p}.norm.weight'].reshape(Fd),
                             P[f'{p}.norm.bias'].reshape(Fd), 1e-5).transpose(1, 2)
            out = F.gelu(y)
        if dropout is not None:
            out = dropout(out.transpose(1, 2), sm['dropout']).transpose(1, 2)
        h = F.gelu(out + h)
    return h.transpose(1, 2)


def forward(P: dict, x: dict[str, torch.Tensor], cfg: dict, precision: str = 'f32', dropout=None) -> torch.Tensor:
    """Logits [B, S, K] of the model input ``x`` ({signal: f32 [B, T]}, a
    whole row of ``-inf`` for an absent signal). ``dropout`` None is
    evaluation."""
    ar = Arith(precision)
    with ar.flags():
        z = {}
        for sig in cfg['signals']:  # the encoders run in the configuration's order
            t = x[sig]
            absent = torch.isinf(t[:, 0])
            t = torch.where(torch.isinf(t), 0.0, t)
            e = _encoder(P, f'signal_encoders.encoders.{sig}', t, cfg, cfg['signals'][sig], ar)
            z[sig] = torch.where(absent[:, None, None], -torch.inf, e)
        h = _epoch_mixer(P, z, cfg, ar, dropout)
        h = _sequence_mixer(P, h, cfg, ar, dropout)
        return ar.linear(h, P['classifier.weight'], P['classifier.bias'])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the epochs whose label is >= 0, in float32."""
    K = logits.shape[-1]
    lg = logits.reshape(-1, K).float()
    y = labels.reshape(-1).long()
    valid = y >= 0
    nll = F.cross_entropy(lg, torch.where(valid, y, 0), reduction='none')
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
