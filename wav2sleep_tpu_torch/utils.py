"""Small helpers shared by the port's modules."""

from __future__ import annotations

import contextlib
import queue
import random
import subprocess

import numpy as np
import torch


def stop_aware_put(q, stop, item, poll: float = 0.2) -> bool:
    """Bounded-queue put that gives up once ``stop`` is set, so an abandoned
    consumer releases a producer blocked on a full queue. Returns False when
    it gave up."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


@contextlib.contextmanager
def full_f32():
    """cuDNN convs and matmuls in full f32 for the block: torch's default
    runs cuDNN convs in TF32, 10 mantissa bits. The flags are process-wide,
    so they are set for the block only and restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device``, or the card (``cuda``) when it is None or ``'auto'`` (the
    JAX package's API default). Raises when the device asked for, or
    defaulted to, is a card and there is none: an entry point never falls
    back to the CPU unless the caller asks for it."""
    dev = torch.device('cuda' if device is None or device == 'auto' else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def fix_seeds(seed: int = 42) -> None:
    """Seed Python's, numpy's and torch's global generators (the model's
    init and host-side shuffles draw from them)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
