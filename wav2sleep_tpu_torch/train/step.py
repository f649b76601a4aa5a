"""The training and evaluation steps on one card.

Port of ``wav2sleep_tpu/train/step.py``. A step decodes a q8/q16 batch on the
device, flips polarities and drops modalities, runs the forward and the
backward, clips the global gradient norm, applies AdamW to the f32 master
parameters (optionally after averaging ``accumulate_steps`` micro-steps'
gradients) and folds the weight EMA. It returns the loss, the confusion
matrix and the raw gradients' global norm.

The optimizer is the port's own code with optax's semantics, which differ
from torch's defaults in three places: the clip scales by ``max_norm /
|g|`` with no epsilon; the schedule is read at the 0-based count of applied
updates; and accumulation applies the clip and AdamW to the mean of the
micro-steps' gradients, on the k-th micro-step only. The EMA folds only on
applied steps, and ``ema_start_step`` counts optimizer steps.

Batch norm's running statistics are the model's buffers: each micro-step's
forward in train mode updates them once (a rematerialised block's recompute
leaves them alone), in f32 under a bf16 step too, as JAX's
``mutable=['batch_stats']`` does. The eval step normalizes with them, for
the model's parameters and for the EMA's alike. SleepPPG-Net
(``family='ppgnet'``) takes its one signal as a tensor.

Randomness: the flip, the masker and dropout draw from seeds derived from
the run's seed and the step (``step_seeds``, the counterpart of JAX's
``fold_in``), so a step is reproducible and the global RNG streams are left
as they were. In f32 the forward and the backward run in full f32
(``utils.full_f32``): under torch's default flags cuDNN would run the f32
convs in TF32. The forward and the optimizer run inside ``record_function``
spans (``train_step/forward``, ``train_step/optimizer``) that
``profile_train`` reads; the backward runs on autograd's own thread.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..ops.q8_transport import dequant_batch, is_encoded_batch
from ..utils import full_f32
from .masker import SignalMasker, invert_signals
from .metrics import confusion_matrix, cross_entropy_ignore_index


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@dataclass
class OptState:
    """AdamW's state: the moments (one tensor per parameter), ``count``
    applied updates (the schedule's 0-based count), the LR scale a plateau
    controller sets, and under accumulation the micro-step and the running
    mean of the micro-steps' gradients."""

    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0
    lr_scale: float = 1.0
    mini_step: int = 0
    acc_grads: list[torch.Tensor] | None = None


class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw)``, optionally inside
    ``MultiSteps``, on lists of f32 tensors updated in place."""

    def __init__(self, learning_rate: float | Callable[[int], float], weight_decay: float,
                 grad_clip: float | None, b1: float, b2: float, eps: float, accumulate_steps: int):
        if accumulate_steps < 1:
            raise ValueError(f'accumulate_steps must be >= 1, got {accumulate_steps}')
        self.learning_rate, self.weight_decay, self.grad_clip = learning_rate, weight_decay, grad_clip
        self.b1, self.b2, self.eps, self.accumulate_steps = b1, b2, eps, accumulate_steps

    def init(self, params: list[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]  # noqa: E731
        return OptState(mu=zeros(), nu=zeros(), acc_grads=zeros() if self.accumulate_steps > 1 else None)

    def lr(self, state: OptState) -> float:
        """The learning rate of the next applied update."""
        lr = self.learning_rate(state.count) if callable(self.learning_rate) else self.learning_rate
        return lr * state.lr_scale

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: OptState, params: list[torch.Tensor]) -> bool:
        """Take one micro-step's gradients; update ``params`` and ``state`` in
        place. Returns whether the update was applied."""
        if self.accumulate_steps > 1:
            # The running mean in Welford's form, acc += (g - acc) / (n + 1),
            # as MultiSteps keeps it.
            delta = torch._foreach_sub(grads, state.acc_grads)
            torch._foreach_div_(delta, state.mini_step + 1)
            torch._foreach_add_(state.acc_grads, delta)
            state.mini_step = (state.mini_step + 1) % self.accumulate_steps
            if state.mini_step:
                return False
            grads = state.acc_grads
        if self.grad_clip is not None:
            # (g / |g|) * max_norm where |g| >= max_norm, else g, with no
            # host sync: dividing and multiplying by 1 leave g as it is.
            g_norm = global_norm(grads)
            keep = g_norm < self.grad_clip
            grads = torch._foreach_div(grads, torch.where(keep, 1.0, g_norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.grad_clip))
        b1, b2, c = self.b1, self.b2, state.count + 1
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        # The bias corrections 1 - b**c in f32 from f32(b), as optax computes
        # them: 1 - f32(0.999) is 1.3e-5 from f32(0.001).
        bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(c)) for b in (b1, b2))
        mu_hat = torch._foreach_div(state.mu, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(upd, -self.lr(state)))
        if state.acc_grads is not None:
            torch._foreach_zero_(state.acc_grads)
        state.count += 1
        return True


def make_optimizer(
    learning_rate: float | Callable[[int], float],
    weight_decay: float = 1e-4,
    grad_clip: float | None = 1.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    accumulate_steps: int = 1,
) -> AdamW:
    """AdamW with decoupled weight decay scaled by the LR, eps outside the
    sqrt and decay on every parameter; the global-norm clip first; with
    ``accumulate_steps > 1`` the update applies every k-th micro-step to the
    mean gradient. ``learning_rate`` is a float or a function of the 0-based
    count of applied updates; the state's ``lr_scale`` multiplies it."""
    return AdamW(learning_rate, weight_decay, grad_clip, b1, b2, eps, accumulate_steps)


@dataclass
class TrainState:
    """``params`` are the model's own (f32) parameters, by name, updated in
    place by the step; ``ema_params`` are detached copies or None;
    ``batch_stats`` are the model's running statistics (its buffers), by
    name, updated in place by the forward, or None for a model without."""

    step: int
    params: dict[str, nn.Parameter]
    opt_state: OptState
    ema_params: dict[str, torch.Tensor] | None = None
    batch_stats: dict[str, torch.Tensor] | None = None


def init_train_state(model: nn.Module, opt: AdamW, ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    low = sorted(n for n, p in params.items() if p.dtype != torch.float32)
    if low:
        raise TypeError(f'the training step keeps f32 master parameters; not f32: {low[:3]}')
    ema_params = {n: p.detach().clone() for n, p in params.items()} if ema else None
    return TrainState(0, params, opt.init(list(params.values())), ema_params, dict(model.named_buffers()) or None)


def _model_input(x: dict[str, torch.Tensor], family: str):
    """The model's input: the dict, or SleepPPG-Net's one signal."""
    if family == 'ppgnet':
        if len(x) != 1:
            raise ValueError(f'{list(x)=} but expected unimodal input!')
        return next(iter(x.values()))
    return x


def step_seeds(seed: int, step: int) -> tuple[int, int, int]:
    """The flip's, the masker's and dropout's seeds at ``step`` of a run
    seeded with ``seed``."""
    return tuple(int(s) for s in np.random.SeedSequence([seed, step]).generate_state(3))


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def _seeded_dropout(device: torch.device, seed: int):
    """Dropout on ``device`` draws from ``seed`` inside the block; the
    global streams are restored after it."""
    cuda = device.type == 'cuda'
    index = (device.index if device.index is not None else torch.cuda.current_device()) if cuda else None
    with torch.random.fork_rng(devices=[index] if cuda else []):
        if cuda:
            torch.cuda.default_generators[index].manual_seed(seed)
        else:
            torch.random.default_generator.manual_seed(seed)
        yield


def make_train_step(
    model: nn.Module,
    opt: AdamW,
    num_classes: int,
    masker: SignalMasker | None = None,
    flip_polarity: bool = True,
    label_smoothing: float = 0.0,
    ema_decay: float | None = None,
    ema_start_step: int = 0,
    compute_dtype: torch.dtype | None = None,
    family: str = 'wav2sleep',
) -> Callable:
    """``train_step(state, (x, y), seed) -> (state, metrics)``.

    ``x`` is ``{signal: [B, T]}`` on the device, or an encoded batch
    (``ops.q8_transport``); ``y`` is [B, S] with -1 for ignored epochs.
    ``compute_dtype=torch.bfloat16`` runs the forward and the backward on
    bf16 copies of the parameters (cast inside the loss), so the gradients
    and the update stay f32. The state is updated in place and returned.
    """
    low = compute_dtype is not None and compute_dtype != torch.float32

    def loss_and_grads(state: TrainState, x: dict, y: torch.Tensor):
        leaves = list(state.params.values())
        with record_function('train_step/forward'):
            if low:
                cast = {n: p.to(compute_dtype) for n, p in state.params.items()}
                xin = _model_input({k: v.to(compute_dtype) for k, v in x.items()}, family)
                logits = torch.func.functional_call(model, cast, (xin,))
            else:
                logits = model(_model_input(x, family))
            loss = cross_entropy_ignore_index(logits.reshape(-1, num_classes), y.reshape(-1), label_smoothing)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), logits.detach(), list(grads)

    def train_step(state: TrainState, batch, seed: int):
        x, y = batch
        if is_encoded_batch(x):
            # Decode before the augmentations: mu-law is odd-symmetric, so
            # flipping the decode equals flipping before the encode.
            x = dequant_batch(x)
        dev = y.device
        seed_flip, seed_mask, seed_drop = step_seeds(seed, state.step)
        if flip_polarity:
            x = invert_signals(_generator(dev, seed_flip), x)
        if masker is not None:
            x = masker(_generator(dev, seed_mask), x)
        model.train()
        with contextlib.nullcontext() if low else full_f32(), _seeded_dropout(dev, seed_drop):
            loss, logits, grads = loss_and_grads(state, x, y)
        with record_function('train_step/optimizer'), torch.no_grad():
            grad_norm = global_norm(grads)
            leaves = list(state.params.values())
            applied = opt.update(grads, state.opt_state, leaves)
            # ``count - 1`` optimizer steps came before this applied one.
            if applied and state.ema_params is not None and ema_decay is not None \
                    and state.opt_state.count - 1 >= ema_start_step:
                ema = list(state.ema_params.values())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(leaves, 1.0 - ema_decay))
        state.step += 1
        return state, {'loss': loss, 'cmat': confusion_matrix(logits, y, num_classes), 'grad_norm': grad_norm}

    return train_step


def make_eval_step(model: nn.Module, num_classes: int, family: str = 'wav2sleep') -> Callable:
    """``eval_step(params, (x, y), present=None) -> {'loss', 'cmat', 'preds'}``
    with ``params`` the model's (``state.params``) or the EMA's, and the
    model's running statistics either way; ``present`` masks modalities
    ({signal: bool [B]}, the wav2sleep family only)."""

    @torch.inference_mode()
    def eval_step(params: dict[str, torch.Tensor], batch, present: dict | None = None):
        x, y = batch
        if is_encoded_batch(x):
            x = dequant_batch(x)
        model.eval()
        with full_f32():
            if family == 'ppgnet':
                logits = torch.func.functional_call(model, params, (_model_input(x, family),))
            else:
                logits = torch.func.functional_call(model, params, (x,), {'present': present})
        loss = cross_entropy_ignore_index(logits.reshape(-1, num_classes), y.reshape(-1))
        return {'loss': loss, 'cmat': confusion_matrix(logits, y, num_classes), 'preds': logits.argmax(dim=-1)}

    return eval_step
