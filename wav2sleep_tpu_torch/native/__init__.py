"""The port's native host library: EDF decode + resample and the f64 causal EMA.

C++ sources under ``native/src`` (copies of the JAX package's host kernels
that the port uses) are compiled with ``g++`` on first use into
``build/native/`` at the repository root and bound with ``ctypes``. The
library's file name carries a hash of the sources, the flags and the host
CPU, since ``-march=native`` bakes the build host's instruction set into it.

``build()`` compiles and loads, and raises if it cannot. ``get_lib()``
returns the library, or None where it cannot be built: the extractors then
take their numpy paths, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np
import numpy.ctypeslib as npc

logger = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent / 'src'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
CFLAGS = ('-O3', '-march=native', '-std=c++17', '-shared', '-fPIC')

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob('*.cpp'))


def _host_cpu() -> str:
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return ''


def _lib_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.read_bytes())
    h.update(' '.join((*CFLAGS, platform.machine(), _host_cpu())).encode())
    return BUILD_DIR / f'libw2s_host_{h.hexdigest()[:16]}.so'


def build() -> ctypes.CDLL:
    """Compile (once per sources, flags and host CPU) and load the library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a temporary name and rename into place: another
            # process may have the previous file mapped.
            tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
            proc = subprocess.run(
                ['g++', *CFLAGS, '-o', str(tmp), *map(str, _sources())],
                capture_output=True, text=True, timeout=300, check=False,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'g++ failed building the native host library:\n{proc.stderr}')
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        _configure(lib)
        _lib = lib
        return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, or None where it cannot be built or loaded."""
    global _failed
    if _lib is not None or _failed:
        return _lib
    try:
        return build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        logger.warning(f'Native host library unavailable ({e}); using the numpy paths.')
        _failed = True
        return None


def _configure(lib: ctypes.CDLL) -> None:
    f64 = npc.ndpointer(dtype=np.float64, flags='C_CONTIGUOUS')
    f32 = npc.ndpointer(dtype=np.float32, flags='C_CONTIGUOUS')
    i16 = npc.ndpointer(dtype=np.int16, flags='C_CONTIGUOUS')
    i8 = npc.ndpointer(dtype=np.int8, flags='C_CONTIGUOUS')
    u8 = npc.ndpointer(dtype=np.uint8, flags='C_CONTIGUOUS')
    d, i64 = ctypes.c_double, ctypes.c_int64

    lib.w2s_ema_normalize_f32.argtypes = [f32, i64, d, d, d, d, d, d, d, f32, ctypes.c_void_p]
    lib.w2s_ema_normalize_f32.restype = None
    lib.w2s_decode_resample.argtypes = [i16, i64, i64, i64, i64, d, d, d, d, d, d, f64, i64, f32]
    lib.w2s_decode_resample.restype = None
    lib.w2s_resample_q8.argtypes = [i16, i64, i64, i64, i64, d, d, i64, i8, ctypes.POINTER(d)]
    lib.w2s_resample_q8.restype = i64
    lib.w2s_resample_q16.argtypes = [i16, i64, i64, i64, i64, d, d, i64, i16]
    lib.w2s_resample_q16.restype = i64
    lib.w2s_resample_dpcm4.argtypes = [i16, i64, i64, i64, i64, d, d, i64, i64, f64, u8, ctypes.POINTER(d)]
    lib.w2s_resample_dpcm4.restype = i64
