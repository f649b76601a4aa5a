"""K1 and K2: kernel-3 1-D convolution with an optional fused norm + activation on its input.

K1 (``conv_k3``) replaces ``wav2sleep_tpu/ops/pallas_conv.py::_conv_kernel``
(the Pallas TPU kernel behind ``sd_conv``, ``sd_conv_blocks`` and
``sd_conv_blocks_fused``) with a CUDA C++ kernel for sm_90a,
``csrc/conv_k3.cu``. On channels-last ``[B, T, C]`` tensors it computes::

    y[b, t, o] = bias[o] + sum_j sum_c w[j, c, o] * phi(x)[b, stride*t + j - 1, c]

where ``phi`` is the identity or ``act((x - mu[b, c]) * inv[b, c])`` — the
previous layer's instance norm and activation, read in with the input so the
normalized map never goes to device memory — and out-of-range positions of
``phi(x)`` are zero. Sums run in f32; ``y`` has ``x``'s dtype.

K2 (``conv_k3_stats``) replaces ``pallas_conv.py::_conv_stats_kernel``: the
same conv, which also returns the per-(batch, channel) instance-norm
statistics ``(mu, 1/sqrt(var + eps))`` of ``y`` as stored, from an epilogue
of the same kernel, so the norm that follows never reads ``y`` again. Its
plain version is ``conv_k3_reference`` followed by ``block_stats``.

The TPU kernel's space-to-depth weight embedding existed for the 128-lane
MXU and is not carried over. On an H100 every bf16 shape of the encoders is
bound by HBM bytes (24 to 192 FLOPs a byte, under the ~295 where the bf16
tensor cores stop being bound by memory), so the bf16 kernel is Hopper's
warp-specialised loop: a TMA ring of x windows feeding ``wgmma`` in two
consumer warpgroups of persistent blocks, the weights staged once per
block, y stored by TMA; f32 keeps a CUDA-core loop, which is exact against
the plain version. The layout and the reasons are noted at the top of
``csrc/conv_k3.cu``, Hopper's building blocks in ``csrc/hopper.cuh``.

The library is compiled with ``nvcc`` on first use (``ops/cuda_build.py``)
into ``build/kernels/`` at the repository root, and loaded with ``ctypes``.
Both wrappers launch it for CUDA tensors and raise on anything it does not
take; for CPU tensors they run their plain versions, which the tests and the
on-card check compare the kernels with.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from ..models.activations import get_activation
from .block_domain import apply_norm_act, block_stats
from .cuda_build import compile_library

# Launches of the k=3 conv kernel on CUDA tensors: ``LAUNCHES`` counts every
# one, K1's (``conv_k3``) and K2's (``conv_k3_stats``); ``STATS_LAUNCHES``
# counts K2's, those with the statistics epilogue.
LAUNCHES = 0
STATS_LAUNCHES = 0

SUPPORTED_C_OUT = (16, 32, 64, 128)
# C_in the kernels take: a bf16 tile of 128 input channels and the weights
# of 128 -> 128 fill the shared memory of one block.
C_IN_RANGE = (8, 128)

# Activation codes of csrc/conv_k3.cu.
_ACT_CODES = {None: 0, 'linear': 0, 'gelu': 1, 'relu': 2, 'leaky': 3, 'silu': 4, 'swish': 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build in this process (ptxas register and
# shared-memory report); empty when the library came from the build cache.
BUILD_LOG = ''


def build() -> ctypes.CDLL:
    """Compile ``csrc/conv_k3.cu`` (once per source and flags) and load it."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, BUILD_LOG = compile_library('conv_k3.cu')
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.w2s_conv_k3.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        lib.w2s_conv_k3.restype = i32
        lib.w2s_conv_k3_tile.argtypes = [i32] * 4
        lib.w2s_conv_k3_tile.restype = i32
        lib.w2s_conv_k3_stats.argtypes = [ptr] * 9 + [i32] * 8 + [ctypes.c_float, ptr]
        lib.w2s_conv_k3_stats.restype = i32
        lib.w2s_conv_k3_smem.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
        lib.w2s_conv_k3_smem.restype = i32
        _lib = lib
        return lib


def output_length(t_in: int, stride: int) -> int:
    return (t_in - 1) // stride + 1


def conv_k3_reference(x, w, bias=None, mu=None, inv=None, stride: int = 1, act: str | None = None):
    """Plain PyTorch version of K1: ``phi`` in f32, then ``F.conv1d``.

    ``phi(x)`` is rounded to ``x``'s dtype before the conv, as the kernel
    and the JAX kernel round it, so in bf16 the two differ by the order of
    their f32 sums and the one rounding of ``y``.
    """
    phi = x if mu is None else apply_norm_act(x, mu, inv, get_activation(act or 'linear'))
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv1d(phi.transpose(1, 2), w.permute(2, 1, 0).to(x.dtype), b, stride=stride, padding=1)
    return y.transpose(1, 2)


def conv_k3_stats_reference(x, w, bias=None, mu=None, inv=None, stride: int = 1, act: str | None = None,
                            eps: float = 1e-5):
    """Plain PyTorch version of K2: ``conv_k3_reference`` then ``block_stats``."""
    y = conv_k3_reference(x, w, bias, mu, inv, stride, act)
    return (y, *block_stats(y, eps))


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f'conv_k3: {name} is on {t.device}, x on {device}')
    if t.dtype != dtype:
        raise TypeError(f'conv_k3: {name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'conv_k3: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'conv_k3: {name} must be contiguous')


def _validate(x, w, bias, mu, inv, stride):
    """Raise on anything the kernel does not take; return (B, T, C_in, C_out)."""
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
    if not 1 <= B <= 65535 or T < 1:
        raise ValueError(f'conv_k3: unsupported x shape {tuple(x.shape)}')
    if not C_IN_RANGE[0] <= c_in <= C_IN_RANGE[1]:
        raise ValueError(f'conv_k3: C_in={c_in} outside {C_IN_RANGE[0]}..{C_IN_RANGE[1]}')
    _check('x', x, x.device, x.dtype, x.shape)
    _check('w', w, x.device, x.dtype, (3, c_in, c_out))
    if bias is not None:
        _check('bias', bias, x.device, x.dtype, (c_out,))
    if mu is not None:
        _check('mu', mu, x.device, torch.float32, (B, c_in))
        _check('inv', inv, x.device, torch.float32, (B, c_in))
    return B, T, c_in, c_out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_device(x):
    """x's device entered only when it is not the current one (entering it
    costs the host more than the launch), and its current raw stream."""
    index = x.device.index
    here = index == torch.cuda.current_device()
    return contextlib.nullcontext() if here else torch.cuda.device(index), torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def _tile(c_out: int, c_in: int, stride: int, dtype_code: int) -> int:
    """Output times of K2's statistics tile (``w2s_conv_k3_tile``)."""
    return build().w2s_conv_k3_tile(c_out, c_in, stride, dtype_code)


def bf16_plan(c_out: int, c_in: int, stride: int) -> dict:
    """The bf16 kernel's launch plan for these channels and stride, as the
    library computes it: output times a tile, dynamic shared memory bytes
    and ring stages (0 for all if unsupported)."""
    lib = build()
    stages = ctypes.c_int(0)
    smem = lib.w2s_conv_k3_smem(c_out, c_in, stride, ctypes.byref(stages))
    return {'tile': lib.w2s_conv_k3_tile(c_out, c_in, stride, 1), 'smem': smem, 'stages': stages.value}


def _launch(x, w, bias, mu, inv, stride, act):
    global LAUNCHES
    B, T, c_in, c_out = _validate(x, w, bias, mu, inv, stride)
    t_out = output_length(T, stride)
    y = torch.empty((B, t_out, c_out), dtype=x.dtype, device=x.device)
    lib = build()
    device, stream = _on_device(x)
    with device:
        rc = lib.w2s_conv_k3(
            x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(mu), _ptr(inv), y.data_ptr(),
            B, T, t_out, c_in, c_out, stride, _ACT_CODES[act], _DTYPE_CODES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f'conv_k3 launch failed: error {rc} at x {tuple(x.shape)} {x.dtype}, C_out {c_out}, stride {stride}')
    LAUNCHES += 1
    return y


def _launch_stats(x, w, bias, mu, inv, stride, act, eps):
    global LAUNCHES, STATS_LAUNCHES
    B, T, c_in, c_out = _validate(x, w, bias, mu, inv, stride)
    t_out = output_length(T, stride)
    lib = build()
    n_tiles = -(-t_out // _tile(c_out, c_in, stride, _DTYPE_CODES[x.dtype]))
    dev = x.device
    y = torch.empty((B, t_out, c_out), dtype=x.dtype, device=dev)
    part = torch.empty((2, B, c_out, n_tiles), dtype=torch.float32, device=dev)
    mu_out = torch.empty((B, c_out), dtype=torch.float32, device=dev)
    inv_out = torch.empty((B, c_out), dtype=torch.float32, device=dev)
    device, stream = _on_device(x)
    with device:
        rc = lib.w2s_conv_k3_stats(
            x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(mu), _ptr(inv), y.data_ptr(),
            part.data_ptr(), mu_out.data_ptr(), inv_out.data_ptr(),
            B, T, t_out, c_in, c_out, stride, _ACT_CODES[act], _DTYPE_CODES[x.dtype], float(eps), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f'conv_k3_stats launch failed: error {rc} at x {tuple(x.shape)} {x.dtype}, C_out {c_out}, stride {stride}'
        )
    LAUNCHES += 1
    STATS_LAUNCHES += 1
    return y, mu_out, inv_out


def _reference_grads(ref, ctx, grads_out, n_inputs=5):
    """Gradients of ``ref`` (a plain version) at the saved inputs."""
    with torch.enable_grad():
        inputs = [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:n_inputs])
        ]
        outs = ref(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, grads_out, allow_unused=True))
    return [next(grads) if t is not None and t.requires_grad else None for t in inputs]


class _ConvK3(torch.autograd.Function):
    """K1 forward; the backward is autograd of ``conv_k3_reference``."""

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
        grads = _reference_grads(lambda *a: conv_k3_reference(*a, stride, act), ctx, (g,))
        return (*grads, None, None)


class _ConvK3Stats(torch.autograd.Function):
    """K2 forward; the backward is autograd of ``conv_k3_stats_reference``."""

    @staticmethod
    def forward(ctx, x, w, bias, mu, inv, stride, act, eps):
        ctx.save_for_backward(x, w, bias, mu, inv)
        ctx.conf = (stride, act, eps)
        if x.device.type == 'cpu':
            return conv_k3_stats_reference(x, w, bias, mu, inv, stride, act, eps)
        return _launch_stats(x, w, bias, mu, inv, stride, act, eps)

    @staticmethod
    def backward(ctx, gy, gmu, ginv):
        stride, act, eps = ctx.conf
        grads = _reference_grads(
            lambda *a: conv_k3_stats_reference(*a, stride, act, eps), ctx, (gy, gmu, ginv)
        )
        return (*grads, None, None, None)


def _check_args(mu, inv, act):
    if (mu is None) != (inv is None):
        raise ValueError('conv_k3: mu and inv must be given together')
    if act not in _ACT_CODES:
        raise ValueError(f'conv_k3: unsupported activation {act!r}')


def conv_k3(x, w, bias=None, mu=None, inv=None, stride: int = 1, act: str | None = None):
    """``y = conv1d_k3(phi(x)) + bias``, pad 1, on channels-last tensors.

    x: [B, T, C_in] f32 or bf16; w: [3, C_in, C_out] in x's dtype, C_out in
    {16, 32, 64, 128}; bias: [C_out] or None; mu, inv: f32 [B, C_in] or both
    None (phi is then the identity); stride 1 or 2; act: an activation name
    of ``models/activations.py`` applied after the norm. Returns
    [B, (T - 1) // stride + 1, C_out].
    """
    _check_args(mu, inv, act)
    return _ConvK3.apply(x, w, bias, mu, inv, stride, act)


def conv_k3_stats(x, w, bias=None, mu=None, inv=None, stride: int = 1, act: str | None = None,
                  eps: float = 1e-5):
    """``conv_k3`` that also returns ``y``'s instance-norm statistics:
    ``(y, mu, inv)`` with mu, inv f32 [B, C_out], the mean over time and
    ``1/sqrt(var + eps)`` (biased variance) of ``y`` as stored in its dtype."""
    _check_args(mu, inv, act)
    return _ConvK3Stats.apply(x, w, bias, mu, inv, stride, act, eps)
