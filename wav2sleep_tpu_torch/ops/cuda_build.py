"""Build a kernel source of ``csrc/`` into a shared library with ``nvcc``.

Each ``.cu`` file has a plain C interface and is compiled on first use, for
sm_90a, into ``build/kernels/`` at the repository root, under a name that
carries a hash of every file in ``csrc/`` and of the flags (an edit to the
source or to a header it includes builds anew; an unchanged tree is
reused). The caller loads it with ``ctypes``. Sources are independent, so
several builds may run at once (one ``nvcc`` each).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels')


def library_path(source_name: str) -> Path:
    """Where the build of ``csrc/<source_name>`` goes: named by a hash of
    the source's name, every file under ``csrc/`` (so an edited header
    counts) and the flags."""
    digest = hashlib.sha256(f'{source_name}\0{" ".join(NVCC_FLAGS)}'.encode())
    for path in sorted(p for p in CSRC.rglob('*') if p.is_file()):
        digest.update(f'\0{path.relative_to(CSRC).as_posix()}\0'.encode() + path.read_bytes())
    return BUILD_DIR / f'lib{Path(source_name).stem}_{digest.hexdigest()[:16]}.so'


def compile_library(source_name: str) -> tuple[Path, str]:
    """Compile ``csrc/<source_name>`` unless its build is cached; returns
    the library's path and nvcc's output (the ptxas register and
    shared-memory report; empty when the library came from the cache)."""
    source = CSRC / source_name
    lib_path = library_path(source_name)
    if lib_path.exists():
        return lib_path, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f'{lib_path.name}.{os.getpid()}.tmp')
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(source)], capture_output=True, text=True, check=False
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed building {source_name} (exit {proc.returncode}):\n{log}')
    os.replace(tmp, lib_path)
    return lib_path, log
