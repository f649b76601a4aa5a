"""The torch port and chip_smoke.py import (and chip_smoke builds its q8
nights) with JAX, flax, optax, pandas, pyarrow and yaml unavailable, so the
port never depends on them, and no file of the port imports JAX or flax."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'wav2sleep_tpu_torch'
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'pyarrow', 'yaml')

_PROBE = f'''
import importlib, pkgutil, sys
BLOCKED = {BLOCKED!r}
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
        return None

sys.meta_path.insert(0, Blocker())
import wav2sleep_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(wav2sleep_tpu_torch.__path__, 'wav2sleep_tpu_torch.'))
for m in mods:
    importlib.import_module(m)
import chip_smoke
chip_smoke.SyntheticQ8Nights(1, 0.05)  # builds and encodes its nights
leaked = sorted(n for n in sys.modules if n.split('.')[0] in BLOCKED)
print('IMPORTED', len(mods), 'LEAKED', leaked)
'''


def test_port_imports_without_jax_pandas_yaml():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get('PYTHONPATH', ''))
    proc = subprocess.run(
        [sys.executable, '-c', _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert 'LEAKED []' in proc.stdout, proc.stdout
    n = int(proc.stdout.split('IMPORTED')[1].split()[0])
    assert n >= 9, proc.stdout  # every module of the package was reached


def test_no_port_file_imports_jax_or_flax():
    pattern = re.compile(r'^\s*(import jax|from jax)\b|\bflax\b', re.M)
    files = [p for p in PORT.rglob('*') if p.suffix in ('.py', '.cu')] + [ROOT / 'chip_smoke.py']
    assert len(files) >= 10
    offenders = [str(p.relative_to(ROOT)) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders
    # chip_smoke.py reaches the JAX package only through the port.
    direct = re.compile(r'^\s*(import|from)\s+wav2sleep_tpu\b', re.M)
    assert not direct.search((ROOT / 'chip_smoke.py').read_text())
