"""K1: kernel-3 1-D convolution with an optional fused norm + activation on its input.

Replaces ``wav2sleep_tpu/ops/pallas_conv.py::_conv_kernel`` (the Pallas TPU
kernel behind ``sd_conv``, ``sd_conv_blocks`` and ``sd_conv_blocks_fused``)
with a CUDA C++ kernel for sm_90a, ``csrc/conv_k3.cu``. On channels-last
``[B, T, C]`` tensors it computes::

    y[b, t, o] = bias[o] + sum_j sum_c w[j, c, o] * phi(x)[b, stride*t + j - 1, c]

where ``phi`` is the identity or ``act((x - mu[b, c]) * inv[b, c])`` — the
previous layer's instance norm and activation, read in with the input so the
normalized map never goes to device memory — and out-of-range positions of
``phi(x)`` are zero. Sums run in f32; ``y`` has ``x``'s dtype.

The TPU kernel's space-to-depth weight embedding existed for the 128-lane
MXU and is not carried over. What bounds the CUDA kernel on an H100, and how
its tiles are laid out, is noted at the top of ``csrc/conv_k3.cu``: it is a
CUDA-core kernel, bound by f32 FMA issue at the encoders' shapes.

The library is compiled with ``nvcc`` on first use, from ``csrc/`` only, into
``build/kernels/`` at the repository root, and loaded with ``ctypes``.
``conv_k3`` launches it for CUDA tensors and raises on anything it does not
take; for CPU tensors it runs ``conv_k3_reference``, the plain PyTorch version
that the tests and the on-card check compare the kernel with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from ..models.activations import get_activation
from .block_domain import apply_norm_act

# Kernel launches made by ``conv_k3`` (CUDA tensors only).
LAUNCHES = 0

SUPPORTED_C_OUT = (16, 32, 64, 128)

# Activation codes of csrc/conv_k3.cu.
_ACT_CODES = {None: 0, 'linear': 0, 'gelu': 1, 'relu': 2, 'leaky': 3, 'silu': 4, 'swish': 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'conv_k3.cu'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build in this process (ptxas register and
# shared-memory report); empty when the library came from the build cache.
BUILD_LOG = ''


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build conv_k3')


def build() -> ctypes.CDLL:
    """Compile ``csrc/conv_k3.cu`` (once per source and flags) and load it."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        source = _SOURCE.read_bytes()
        tag = hashlib.sha256(source + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f'libw2s_conv_k3_{tag}.so'
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f'{lib_path.name}.{os.getpid()}.tmp')
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(_SOURCE)],
                capture_output=True, text=True, check=False,
            )
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'nvcc failed building conv_k3 (exit {proc.returncode}):\n{BUILD_LOG}')
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.w2s_conv_k3.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.w2s_conv_k3.restype = ctypes.c_int
        _lib = lib
        return lib


def output_length(t_in: int, stride: int) -> int:
    return (t_in - 1) // stride + 1


def conv_k3_reference(x, w, bias=None, mu=None, inv=None, stride: int = 1, act: str | None = None):
    """Plain PyTorch version of the kernel: ``phi`` in f32, then ``F.conv1d``.

    ``phi(x)`` is rounded to ``x``'s dtype before the conv (the kernel keeps
    it in f32), so in bf16 the two differ by a few bf16 ulps of ``y``.
    """
    phi = x if mu is None else apply_norm_act(x, mu, inv, get_activation(act or 'linear'))
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv1d(phi.transpose(1, 2), w.permute(2, 1, 0).to(x.dtype), b, stride=stride, padding=1)
    return y.transpose(1, 2)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f'conv_k3: {name} is on {t.device}, x on {device}')
    if t.dtype != dtype:
        raise TypeError(f'conv_k3: {name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'conv_k3: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'conv_k3: {name} must be contiguous')


def _launch(x, w, bias, mu, inv, stride, act):
    global LAUNCHES
    if x.device.type != 'cuda':
        raise ValueError(f'conv_k3 kernel needs a CUDA tensor, got {x.device}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'conv_k3: x dtype {x.dtype} not supported (float32, bfloat16)')
    if x.dim() != 3:
        raise ValueError(f'conv_k3: x must be [B, T, C_in], got {tuple(x.shape)}')
    B, T, c_in = x.shape
    if w.dim() != 3:
        raise ValueError(f'conv_k3: w must be [3, C_in, C_out], got {tuple(w.shape)}')
    c_out = w.shape[2]
    if c_out not in SUPPORTED_C_OUT:
        raise ValueError(f'conv_k3: C_out={c_out} not in {SUPPORTED_C_OUT}')
    if stride not in (1, 2):
        raise ValueError(f'conv_k3: stride {stride} not in (1, 2)')
    if not 1 <= B <= 65535 or T < 1 or c_in < 1:
        raise ValueError(f'conv_k3: unsupported x shape {tuple(x.shape)}')
    _check('x', x, x.device, x.dtype, x.shape)
    _check('w', w, x.device, x.dtype, (3, c_in, c_out))
    if bias is not None:
        _check('bias', bias, x.device, x.dtype, (c_out,))
    if mu is not None:
        _check('mu', mu, x.device, torch.float32, (B, c_in))
        _check('inv', inv, x.device, torch.float32, (B, c_in))
    t_out = output_length(T, stride)
    y = torch.empty((B, t_out, c_out), dtype=x.dtype, device=x.device)
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.w2s_conv_k3(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if mu is None else mu.data_ptr(),
            None if inv is None else inv.data_ptr(),
            y.data_ptr(), B, T, t_out, c_in, c_out, stride, _ACT_CODES[act],
            _DTYPE_CODES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f'conv_k3 launch failed: error {rc} at x {tuple(x.shape)} {x.dtype}, C_out {c_out}, stride {stride}')
    LAUNCHES += 1
    return y


class _ConvK3(torch.autograd.Function):
    """The kernel forward; the backward is autograd of ``conv_k3_reference``."""

    @staticmethod
    def forward(ctx, x, w, bias, mu, inv, stride, act):
        ctx.save_for_backward(x, w, bias, mu, inv)
        ctx.conf = (stride, act)
        if x.device.type == 'cpu':
            return conv_k3_reference(x, w, bias, mu, inv, stride, act)
        return _launch(x, w, bias, mu, inv, stride, act)

    @staticmethod
    def backward(ctx, g):
        stride, act = ctx.conf
        with torch.enable_grad():
            inputs = [
                None if t is None else t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:5])
            ]
            y = conv_k3_reference(*inputs, stride, act)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        out = [next(grads) if t is not None and t.requires_grad else None for t in inputs]
        return (*out, None, None)


def conv_k3(x, w, bias=None, mu=None, inv=None, stride: int = 1, act: str | None = None):
    """``y = conv1d_k3(phi(x)) + bias``, pad 1, on channels-last tensors.

    x: [B, T, C_in] f32 or bf16; w: [3, C_in, C_out] in x's dtype, C_out in
    {16, 32, 64, 128}; bias: [C_out] or None; mu, inv: f32 [B, C_in] or both
    None (phi is then the identity); stride 1 or 2; act: an activation name
    of ``models/activations.py`` applied after the norm. Returns
    [B, (T - 1) // stride + 1, C_out].
    """
    if (mu is None) != (inv is None):
        raise ValueError('conv_k3: mu and inv must be given together')
    if act not in _ACT_CODES:
        raise ValueError(f'conv_k3: unsupported activation {act!r}')
    return _ConvK3.apply(x, w, bias, mu, inv, stride, act)
