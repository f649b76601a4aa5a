"""Nothing the benchmark loads is of the JAX stack or the JAX package, by
whole top-level module names (the port's name begins with the JAX
package's)."""

import ast
import json
import subprocess
import sys

from benchmark import harness
from benchmark.tests.bench_tiny import REPO


def test_names_are_compared_whole(monkeypatch):
    for name in ('wav2sleep_tpu_torch', 'wav2sleep_tpu_torchvision', 'jaxtyping', 'flaxen'):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_modules()) & {'wav2sleep_tpu_torch', 'jaxtyping', 'flaxen'}
    monkeypatch.setitem(sys.modules, 'wav2sleep_tpu.models', sys)
    assert 'wav2sleep_tpu' in harness.forbidden_modules()


def test_no_file_of_the_benchmark_imports_them():
    for path in (REPO / 'benchmark').rglob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ''] if isinstance(node, ast.ImportFrom) and not node.level else []
            assert not {n.split('.')[0] for n in names} & set(harness.FORBIDDEN), (path, names)


def test_a_run_loads_none_of_them(tmp_path):
    code = (
        'import json, sys, time; sys.path.insert(0, sys.argv[1]); import torch; torch.set_num_threads(2);'
        'from benchmark.tests.bench_tiny import tiny_root, run; from benchmark import harness;'
        'root = tiny_root(sys.argv[2]);'
        'r = [run(root, c) for c in ("wav2sleep.serve-q8", "wav2sleep.train-f32")];'
        'print(json.dumps(harness.forbidden_modules()))'
    )
    out = subprocess.run([sys.executable, '-c', code, str(REPO), str(tmp_path)], capture_output=True, text=True,
                         timeout=600, env={'OMP_NUM_THREADS': '2', 'PATH': '/usr/bin:/bin', 'HOME': str(tmp_path)},
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
