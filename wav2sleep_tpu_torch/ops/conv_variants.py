"""The K1 bisection ladder: ``scripts/profile_pallas_variants.py``'s five
Pallas kernels as CUDA C++ kernels for sm_90a (``csrc/conv_variants.cu``;
V2, V3, V4 and V7 in ``csrc/conv_variants_wgmma.cuh``).

The JAX script bisects the cost of the k=3 conv kernel at its hot shape
(B = 8, 153,600 rows of 128 bf16 channels) by timing stripped-down
versions of it. Each function here keeps its JAX name and computes what
its Pallas kernel computes, on x ``[B, nb, 128]`` bf16 and weights in bf16,
with f32 sums and one rounding of y to bf16:

- ``copy`` (V0, ``k_copy`` ``:79``): ``y = x``, the pipeline floor.
- ``mm1f`` (V2, ``k_mm1f`` ``:85``): ``y = x @ W0``.
- ``mm3`` (V3, ``k_mm3`` ``:93``): ``y = x @ W0 + x @ W1 + x @ W2``.
- ``mm3s`` (V4, ``k_mm3s`` ``:106``): per tile of ``tb`` rows, ``x @ W1``,
  plus ``x @ W0`` shifted down one row, plus ``x @ W2`` shifted up one row,
  0 shifted in at both edges of every tile: a k=3 conv with zero padding at
  every tile edge, shifted on the f32 outputs.
- ``v7`` (V7, ``k_v7`` ``:136``): per tile t, ``[xp[b, 8t], x[:-1]] @ W0 +
  x @ W1 + [x[1:], xn[b, 8t]] @ W2``: K1's formulation with halo rows,
  shifted on the bf16 inputs. With the true neighbours as halos
  (``true_halos``) it is K1 (``conv_k3``) at 128 -> 128, stride 1, no bias.

``tb`` is the function's tile length (the JAX kernel's block of rows), not
the CUDA kernel's tiling: V4's zero edges and V7's halo rows sit at every
multiple of ``tb``. V2 and V3 are row-wise, so ``tb`` is checked but plays
no part in them. W uses K1's layout, ``[3, C_in, C_out]`` applied as
``x @ W[j]``.

The kernels: V0 one 16-byte vector per thread in short-lived blocks of
1024 threads (at ``Tensor.copy_``'s rate, which no persistent design
reached); V2, V3, V4 and V7 Hopper's
``wgmma`` (B read from shared memory once per warpgroup) fed by a TMA ring
over the flat ``[B * nb, 128]`` rows, with TMA stores of y, in persistent
blocks. V3 runs its three products into one f32 accumulator rather than
summing the weights, since the ladder bisects K1's three taps; V4 shifts
two of them by a row in registers (tiles of 64 rows that write 62, so
each has the neighbour rows it needs). V7 shifts on the input side, as
K1 does: its tiles are cut from each function tile (64 rows and a partial
last one of ``tb % 64``), each loaded as a 66-row window with its
neighbour rows, tap j's operand starting j rows into the window; the halo
rows are written over the window's edge rows in shared memory.

Like ``ops/conv_k3.py``: for CUDA tensors the wrappers launch the kernel and
count it in ``LAUNCHES``; for CPU tensors they run the plain versions
(``*_reference``), which the tests and the on-card check hold the kernels
to. Both raise on anything the kernels do not take. The library is built
with ``nvcc`` on first use into ``build/kernels/`` and loaded with
``ctypes``. No serving path runs these kernels: ``python -m
wav2sleep_tpu_torch.profile_variants`` times them.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from .cuda_build import compile_library

D = 128
NAMES = ('copy', 'mm1f', 'mm3', 'mm3s', 'v7')
# Modes of w2s_conv_variant (csrc/conv_variants.cu): the JAX script's rung numbers.
MODES = {'copy': 0, 'mm1f': 2, 'mm3': 3, 'mm3s': 4, 'v7': 7}
# Kernel launches per function, CUDA tensors only.
LAUNCHES = dict.fromkeys(NAMES, 0)

_lib = None
_lib_lock = threading.Lock()
# nvcc's output of the last build in this process (the ptxas report); empty
# when the library came from the build cache.
BUILD_LOG = ''


def build() -> ctypes.CDLL:
    """Compile ``csrc/conv_variants.cu`` (once per source and flags) and load it."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, BUILD_LOG = compile_library('conv_variants.cu')
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.w2s_conv_variant.argtypes = [i32] + [ptr] * 5 + [i32] * 3 + [ptr]
        lib.w2s_conv_variant.restype = i32
        _lib = lib
        return lib


# ------------------------------------------------------------- plain ----

def _products(x, w):
    """``x @ w[j]`` for each tap, in f32 from the bf16 values."""
    xf = x.float()
    return [xf @ wj.float() for wj in w]


def copy_reference(x, tb: int):
    return x.clone()


def mm1f_reference(x, w0, tb: int):
    return (x.float() @ w0.float()).to(torch.bfloat16)


def mm3_reference(x, w, tb: int):
    d0, d1, d2 = _products(x, w)
    return ((d0 + d1) + d2).to(torch.bfloat16)


def mm3s_reference(x, w, tb: int):
    B, nb, _ = x.shape
    d0, d1, d2 = (d.view(B, nb // tb, tb, D) for d in _products(x, w))
    zero = d0.new_zeros(B, nb // tb, 1, D)
    o = d1 + torch.cat([zero, d0[:, :, :-1]], 2)
    o = o + torch.cat([d2[:, :, 1:], zero], 2)
    return o.view(B, nb, D).to(torch.bfloat16)


def v7_reference(x, xp, xn, w, tb: int):
    B, nb, _ = x.shape
    xt = x.view(B, nb // tb, tb, D)
    xm1 = torch.cat([xp[:, 0::8, None], xt[:, :, :-1]], 2)
    xp1 = torch.cat([xt[:, :, 1:], xn[:, 0::8, None]], 2)
    w0, w1, w2 = (wj.float() for wj in w)
    o = xm1.float() @ w0 + xt.float() @ w1
    o = o + xp1.float() @ w2
    return o.view(B, nb, D).to(torch.bfloat16)


def true_halos(x, tb: int):
    """V7's halo inputs that make it K1: row 8t of xp is x's row t tb - 1 and
    row 8t of xn its row (t + 1) tb, zero past either end (the other rows of
    each block of 8 are zero)."""
    B, nb, _ = x.shape
    n_t = nb // tb
    xp = x.new_zeros(B, n_t * 8, D)
    xn = x.new_zeros(B, n_t * 8, D)
    xp[:, 8::8] = x[:, tb - 1:nb - 1:tb]
    xn[:, 0:(n_t - 1) * 8:8] = x[:, tb::tb]
    return xp, xn


def agree(got, want, tol: float) -> tuple[bool, float]:
    """Whether ``|got - want| <= tol (|want| + rms(want))`` everywhere, and
    the max ``|got - want|``."""
    ref = want.float()
    diff = (got.float() - ref).abs()
    ok = bool((diff <= tol * (ref.abs() + ref.square().mean().sqrt())).all())
    return ok, float(diff.max())


# ---------------------------------------------------------- wrappers ----

def _validate(name, x, tb, w, xp, xn):
    """Raise on anything the kernel does not take: x [B, nb, 128] bf16, tb
    a positive multiple of 8 dividing nb, and w (and V7's xp, xn) of their
    shapes, in x's dtype, on x's device; all contiguous (16-byte aligned
    on the card)."""
    if x.dim() != 3 or x.shape[2] != D:
        raise ValueError(f'{name}: x must be [B, nb, {D}], got {tuple(x.shape)}')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'{name}: x has dtype {x.dtype}, expected torch.bfloat16')
    B, nb, _ = x.shape
    if not 1 <= B <= 65535 or nb < 1:
        raise ValueError(f'{name}: unsupported x shape {tuple(x.shape)}')
    if tb < 1 or tb % 8:
        raise ValueError(f'{name}: tb={tb} is not a positive multiple of 8')
    if nb % tb:
        raise ValueError(f'{name}: nb={nb} is not a multiple of tb={tb}')
    tensors = [('x', x, x.shape)]
    if w is not None:
        tensors.append(('w', w, (D, D) if name == 'mm1f' else (3, D, D)))
    if xp is not None:
        tensors += [('xp', xp, (B, nb // tb * 8, D)), ('xn', xn, (B, nb // tb * 8, D))]
    for arg, t, shape in tensors:
        if t.device != x.device:
            raise ValueError(f'{name}: {arg} is on {t.device}, x on {x.device}')
        if t.dtype != x.dtype:
            raise TypeError(f'{name}: {arg} has dtype {t.dtype}, expected {x.dtype}')
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {arg} must be contiguous')
        if t.device.type == 'cuda' and t.data_ptr() % 16:
            raise ValueError(f'{name}: {arg} must be 16-byte aligned')


def _run(name, reference, x, tb, w=None, xp=None, xn=None):
    _validate(name, x, tb, w, xp, xn)
    B, nb = x.shape[:2]
    args = [a for a in (xp, xn, w) if a is not None]
    if x.device.type == 'cpu':
        return reference(x, *args, tb)
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: the kernel needs a CUDA tensor, got {x.device}')
    y = torch.empty_like(x)
    lib = build()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    # The launch goes to x's device, on its current stream. Host time per
    # call is kept down: the device is entered only when it is not the
    # current one, and the stream is read as its raw handle, with no
    # Stream object.
    index = x.device.index
    here = index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(index):
        rc = lib.w2s_conv_variant(
            MODES[name], x.data_ptr(), ptr(w), ptr(xp), ptr(xn), y.data_ptr(), B, nb, tb,
            torch._C._cuda_getCurrentRawStream(index),
        )
    if rc != 0:
        raise RuntimeError(f'{name} launch failed: error {rc} at x {tuple(x.shape)}, tb {tb}')
    LAUNCHES[name] += 1
    return y


def copy(x, tb: int):
    """V0: ``y = x``. x: [B, nb, 128] bf16; tb divides nb (the JAX kernel's block)."""
    return _run('copy', copy_reference, x, tb)


def mm1f(x, w0, tb: int):
    """V2: ``bf16(x @ w0)``, f32 sums. w0: [128, 128] bf16."""
    return _run('mm1f', mm1f_reference, x, tb, w0)


def mm3(x, w, tb: int):
    """V3: ``bf16(x @ w[0] + x @ w[1] + x @ w[2])``, f32 sums. w: [3, 128, 128] bf16."""
    return _run('mm3', mm3_reference, x, tb, w)


def mm3s(x, w, tb: int):
    """V4: per tile of tb rows, ``x @ w[1]`` plus ``x @ w[0]`` shifted down
    one row plus ``x @ w[2]`` shifted up one row, 0 at the tile edges."""
    return _run('mm3s', mm3s_reference, x, tb, w)


def v7(x, xp, xn, w, tb: int):
    """V7: per tile t of tb rows, ``[xp[:, 8t], x[:-1]] @ w[0] + x @ w[1] +
    [x[1:], xn[:, 8t]] @ w[2]``. xp, xn: [B, (nb // tb) * 8, 128] bf16."""
    return _run('v7', v7_reference, x, tb, w, xp, xn)
