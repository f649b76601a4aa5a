"""Build a kernel source of ``csrc/`` into a shared library with ``nvcc``.

Each ``.cu`` file has a plain C interface and is compiled on first use, for
sm_90a, into ``build/kernels/`` at the repository root, under a name that
carries a hash of every file in ``csrc/`` and of the flags (an edit to the
source or to a header it includes builds anew; an unchanged tree is
reused). The caller loads it with ``ctypes``. Sources are independent, so
several builds may run at once (one ``nvcc`` each). ``ptxas_report`` reads
nvcc's register and spill report per kernel, and ``sass_counts`` counts
instructions per kernel in a built library's machine code (``sass``).
"""

from __future__ import annotations

import hashlib
import os
import re
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
    shared-memory report, kept beside the library for a cached build)."""
    source = CSRC / source_name
    lib_path = library_path(source_name)
    log_path = lib_path.with_name(f'{lib_path.name}.log')
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f'{lib_path.name}.{os.getpid()}.tmp')
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(source)], capture_output=True, text=True, check=False
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed building {source_name} (exit {proc.returncode}):\n{log}')
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, log


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of nvcc's ``-Xptxas -v`` output: its
    registers, static shared memory and spilled bytes (stores + loads)."""
    report = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r'Used (\d+) registers', chunk)
        smem = re.search(r'(\d+) bytes smem', chunk)
        spills = [int(v) for v in re.findall(r'(\d+) bytes spill (?:stores|loads)', chunk)]
        report[name] = {'registers': int(regs.group(1)) if regs else 0,
                        'smem_bytes': int(smem.group(1)) if smem else 0, 'spill_bytes': sum(spills)}
    return report


def sass(lib_path: Path) -> str:
    """``cuobjdump -sass`` of a built library: its kernels' machine code."""
    tool = Path(_nvcc()).resolve().with_name('cuobjdump')
    proc = subprocess.run([str(tool), '-sass', str(lib_path)], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f'cuobjdump -sass {lib_path.name} failed (exit {proc.returncode}):\n{proc.stderr}')
    return proc.stdout


def sass_counts(listing: str, opcodes) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of a ``cuobjdump -sass`` listing: how many
    of its instructions have each opcode (``HGMMA`` counts ``HGMMA.64x128x16...``,
    ``LDG.E.128`` counts ``LDG.E.128.CONSTANT``)."""
    parts = re.split(r'Function : (\S+)', listing)
    return {name: {op: len(re.findall(rf'\b{re.escape(op)}\b', body)) for op in opcodes}
            for name, body in zip(parts[1::2], parts[2::2])}
