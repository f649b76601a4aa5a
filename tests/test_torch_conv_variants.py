"""The K1 bisection ladder (``wav2sleep_tpu_torch.ops.conv_variants``) against
``scripts/profile_pallas_variants.py``'s own Pallas kernels, run in interpret
mode on the CPU.

The script defines its kernels inside ``main()``, so the ``k_*`` definitions
are taken verbatim from its source with ``ast``, run with ``jnp`` in scope,
and wrapped in ``pl.pallas_call(..., interpret=True)`` with the script's
BlockSpecs: grid ``(B, nT)``, x and y blocks ``(1, TB, 128)``, weights
``(128, 128)``, halos ``(1, 8, 128)``. On the CPU the port's wrappers run
their plain versions; the kernels themselves are checked on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Also: V7 with
true-neighbour halos is K1's plain version, the wrappers' refusals, and the
profiling entry point on the CPU.
"""

import ast
import importlib.util
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wav2sleep_tpu_torch import card_clock, profile_variants
from wav2sleep_tpu_torch.ops import conv_variants as cv
from wav2sleep_tpu_torch.ops.conv_k3 import conv_k3_reference

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

SCRIPT = Path(__file__).resolve().parents[1] / 'scripts' / 'profile_pallas_variants.py'
D = 128
# bf16: |port - Pallas| <= TOL (|y| + rms(y)). Both sum exact bf16 products
# in f32, in their own orders, and round y to bf16 once (1 ulp, 2**-8 to
# 2**-7 of |y|): the identity gate of test_torch_conv_k3.py::test_bf16_matches_pallas.
TOL = 2.0**-7
CASES = [(B, tb) for B in (1, 2) for tb in (8, 16, 24)]  # nT = 3 tiles of tb rows
JAX_NAMES = {'copy': 'k_copy', 'mm1f': 'k_mm1f', 'mm3': 'k_mm3', 'mm3s': 'k_mm3s', 'v7': 'k_v7'}


@functools.cache
def _script_kernels() -> dict:
    """The ``k_*`` functions of the script's ``main()``, compiled as written."""
    tree = ast.parse(SCRIPT.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == 'main')
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name.startswith('k_')]
    namespace = {'jnp': jnp}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SCRIPT), 'exec'), namespace)
    return {d.name: namespace[d.name] for d in defs}


def _pallas(name, B, nb, tb, *args):
    """The script's kernel ``name`` through ``pl.pallas_call`` with its
    BlockSpecs (``call`` :63, ``call_v7`` :146), interpreted."""
    vmem = dict(memory_space=pltpu.VMEM)
    row = pl.BlockSpec((1, tb, D), lambda b, t: (b, t, 0), **vmem)
    halo = pl.BlockSpec((1, 8, D), lambda b, t: (b, t, 0), **vmem)
    weight = pl.BlockSpec((D, D), lambda b, t: (0, 0), **vmem)
    n_w = {'k_copy': 0, 'k_mm1f': 1}.get(name, 3)
    in_specs = [row, *([halo, halo] if name == 'k_v7' else []), *[weight] * n_w]
    return pl.pallas_call(
        _script_kernels()[name], grid=(B, nb // tb), in_specs=in_specs, out_specs=row,
        out_shape=jax.ShapeDtypeStruct((B, nb, D), jnp.bfloat16), interpret=True,
    )(*args)


def _inputs(B, tb, seed, n_t=3):
    """x, w, xp, xn as bf16 torch tensors, from a numpy seed; halos random."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    nb = n_t * tb
    return (bf(rng.normal(size=(B, nb, D))), bf(rng.normal(size=(3, D, D)) * 0.1),
            bf(rng.normal(size=(B, n_t * 8, D))), bf(rng.normal(size=(B, n_t * 8, D))))


def _j(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # exact: the values are bf16


def _call(name, x, w, xp, xn, tb):
    """The port's wrapper and the script's kernel on the same inputs."""
    B, nb, _ = x.shape
    port = {'copy': lambda: cv.copy(x, tb), 'mm1f': lambda: cv.mm1f(x, w[0], tb), 'mm3': lambda: cv.mm3(x, w, tb),
            'mm3s': lambda: cv.mm3s(x, w, tb), 'v7': lambda: cv.v7(x, xp, xn, w, tb)}[name]()
    weights = [] if name == 'copy' else [_j(w[0])] if name == 'mm1f' else [_j(w[j]) for j in range(3)]
    halos = [_j(xp), _j(xn)] if name == 'v7' else []
    want = _pallas(JAX_NAMES[name], B, nb, tb, _j(x), *halos, *weights)
    return port, torch.from_numpy(np.asarray(want, np.float32))


@pytest.mark.parametrize('name', cv.NAMES)
@pytest.mark.parametrize('B,tb', CASES)
def test_plain_matches_pallas(name, B, tb):
    """V7's halos are random, so reading row t of xp / xn instead of row 8t
    would fail."""
    x, w, xp, xn = _inputs(B, tb, seed=B * 100 + tb)
    got, want = _call(name, x, w, xp, xn, tb)
    assert got.shape == want.shape == (B, 3 * tb, D) and got.dtype == torch.bfloat16
    if name == 'copy':
        assert torch.equal(got.float(), want)
    else:
        ok, err = cv.agree(got, want, TOL)
        assert ok, err


@pytest.mark.parametrize('B,tb', [(2, 72), (1, 200)])
def test_v7_plain_matches_pallas_over_partial_tiles(B, tb):
    """V7 at function tiles that are not a multiple of the card kernel's
    64-row tiles (one full tile and a partial one of 8; three full and one
    of 8), with random halos, against the script's ``k_v7``."""
    x, w, xp, xn = _inputs(B, tb, seed=B * 1000 + tb)
    got, want = _call('v7', x, w, xp, xn, tb)
    assert got.shape == want.shape == (B, 3 * tb, D) and got.dtype == torch.bfloat16
    ok, err = cv.agree(got, want, TOL)
    assert ok, err


@pytest.mark.parametrize('B,tb', [(1, 8), (2, 24), (2, 2048)])
def test_v7_with_true_halos_is_k1(B, tb):
    x, w, _, _ = _inputs(B, tb, seed=tb, n_t=3 if tb < 2048 else 2)
    xp, xn = cv.true_halos(x, tb)
    n_t = x.shape[1] // tb
    for t in range(n_t):
        assert torch.equal(xp[:, 8 * t], x[:, t * tb - 1] if t else torch.zeros_like(x[:, 0]))
        assert torch.equal(xn[:, 8 * t], x[:, (t + 1) * tb] if t < n_t - 1 else torch.zeros_like(x[:, 0]))
    ok, err = cv.agree(cv.v7(x, xp, xn, w, tb), conv_k3_reference(x, w), TOL)
    assert ok, err


def test_profile_inputs_are_the_jax_scripts():
    """``profile_variants.inputs`` draws x, then W x 0.1, from
    ``default_rng(0)`` and rounds them to bf16 as the JAX script does."""
    B, nb = 1, 48
    x, w = profile_variants.inputs(B, nb, 'cpu')
    rng = np.random.default_rng(0)
    xj = jnp.asarray(rng.normal(size=(B, nb, D)), jnp.bfloat16)
    wj = jnp.asarray(rng.normal(size=(3, D, D)) * 0.1, jnp.bfloat16)
    assert torch.equal(x.float(), torch.from_numpy(np.asarray(xj, np.float32)))
    assert torch.equal(w.float(), torch.from_numpy(np.asarray(wj, np.float32)))


@pytest.mark.parametrize('name', cv.NAMES)
def test_wrappers_refuse_what_the_kernels_do_not_take(name):
    x, w, xp, xn = _inputs(1, 16, seed=3)

    def call(x=x, w=w, xp=xp, xn=xn, tb=16):
        return {'copy': lambda: cv.copy(x, tb), 'mm1f': lambda: cv.mm1f(x, w[0] if w.dim() == 3 else w, tb),
                'mm3': lambda: cv.mm3(x, w, tb), 'mm3s': lambda: cv.mm3s(x, w, tb),
                'v7': lambda: cv.v7(x, xp, xn, w, tb)}[name]()

    with pytest.raises(ValueError, match=r'\[B, nb, 128\]'):
        call(x=x[..., :64].contiguous())
    with pytest.raises(ValueError, match='multiple of tb'):
        call(tb=32)
    for tb in (12, 0):
        with pytest.raises(ValueError, match='multiple of 8'):
            call(tb=tb)
    with pytest.raises(TypeError, match='dtype'):
        call(x=x.float())
    wide = torch.zeros(1, 48, 2 * D, dtype=torch.bfloat16)
    wide[..., :D] = x
    with pytest.raises(ValueError, match='contiguous'):
        call(x=wide[..., :D])
    if name == 'copy':
        return
    with pytest.raises(TypeError, match='w has dtype'):
        call(w=w.float())
    with pytest.raises(ValueError, match='w is on meta'):
        call(w=w.to('meta'))
    with pytest.raises(ValueError, match='w has shape'):
        call(w=w[:, :64, :].contiguous() if name == 'mm1f' else w[:2])
    if name == 'v7':
        with pytest.raises(ValueError, match='xp has shape'):
            call(xp=xp[:, :8])
        with pytest.raises(ValueError, match='xn is on meta'):
            call(xn=xn.to('meta'))


def test_profile_run_prints_the_jax_keys(capsys):
    out = profile_variants.run(B=1, nb=48, tb=16, k=2, reps=1, device='cpu')
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ('copy_ms', 'mm1_f32acc_ms', 'mm3_ms', 'mm3_shift_ms', 'v7_full_ms', 'bound_ms', 'k1_ms', 'conv1d_ms',
            'tensor_copy_ms', 'tensor_copy_fresh_ms', 'matmul_ms', 'einsum_ms')
    assert line == out and all(isinstance(line[k], float) for k in keys) and 'both_ms' not in line
    assert line['device'] == 'cpu' and line['shape'] == 'B=1 nb=48 D=128 TB=16 bf16'
    assert not any('parsem' in k for k in line)
    assert line['bound_ms'] == pytest.approx(2 * 48 * D * 2 / 3.35e12 * 1e3)


def test_profile_times_both_ways_only_on_the_card():
    with pytest.raises(ValueError, match='needs the card'):
        profile_variants.run(B=1, nb=48, tb=16, k=2, reps=1, device='cpu', both=True)


def test_profile_entry_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_variants.run(B=1, nb=48, tb=16, k=2, reps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_variants.main(['--tb', '16'])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', SCRIPT.parents[1] / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('name', cv.NAMES)
@pytest.mark.parametrize('tb', (8, 16, 24))
def test_library_calls_compute_the_functions(name, tb):
    """chip_smoke.py's one-call library counterpart of each rung (V7 with
    true halos) against the plain version, within the bound it is held to
    on the card: copy equal, the others within BF16_TOL of |y| + rms."""
    smoke = _chip_smoke()
    B, nb = 2, 3 * tb
    x, w = profile_variants.inputs(B, nb, 'cpu')
    call, to_y = smoke.variant_library_calls(torch, torch.nn.functional, x, w, tb)[name]
    xp, xn = cv.true_halos(x, tb)
    want = {'copy': lambda: cv.copy_reference(x, tb), 'mm1f': lambda: cv.mm1f_reference(x, w[0], tb),
            'mm3': lambda: cv.mm3_reference(x, w, tb), 'mm3s': lambda: cv.mm3s_reference(x, w, tb),
            'v7': lambda: cv.v7_reference(x, xp, xn, w, tb)}[name]()
    got = to_y(call())
    assert got.shape == want.shape
    if name == 'copy':
        assert torch.equal(got, want)
    else:
        ok, err = cv.agree(got, want, smoke.BF16_TOL)
        assert ok, err


# Mangled names of the kernels that phase 10 reads the SASS of, by rung.
_KERNELS = {
    'copy': '_ZN49_GLOBAL__N__c51223d3_16_conv_variants_cu_22afb78011copy_kernelEPKhPhm',
    **{name: f'_ZN8wgmma_mm15mm_wgmma_kernelILi{n}EEEv14CUtensorMap_stS1_iNS_7FastDivE'
       for name, n in (('mm1f', 1), ('mm3', 3), ('mm3s', 4))},
    'v7': '_ZN8wgmma_mm15v7_wgmma_kernelE14CUtensorMap_stS0_S0_S0_PK13__nv_bfloat16S3_iNS_7FastDivEi',
}
_OPS = {'HGMMA': 'HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;\n', 'UTMALDG': 'UTMALDG.2D [UR8], [UR4] ;\n',
        'UTMASTG': 'UTMASTG.2D [UR4], [UR6] ;\n', 'LDG.E.128': 'LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;\n',
        'STG.E.128': 'STG.E.128 desc[UR4][R6.64], R4 ;\n'}
# Each kernel's opcodes, as counts: V0 one 16-byte load and store, V2 8
# wgmma k-steps, V3, V4 and V7 24 (V7's 16 stores: 2 for a full tile, 14
# for the unrolled 8-row boxes of a partial one).
_COUNTS = {'copy': {'LDG.E.128': 1, 'STG.E.128': 1}, 'mm1f': {'HGMMA': 8, 'UTMALDG': 4, 'UTMASTG': 2},
           'mm3': {'HGMMA': 24, 'UTMALDG': 8, 'UTMASTG': 2}, 'mm3s': {'HGMMA': 24, 'UTMALDG': 8, 'UTMASTG': 2},
           'v7': {'HGMMA': 24, 'UTMALDG': 8, 'UTMASTG': 16}}


def _sass_listing(missing: tuple[str, str] | None, extra: tuple[str, str] | None = None) -> tuple[str, str]:
    """A ptxas report and a SASS listing of the ladder's kernels, without
    ``missing`` = (rung, opcode) and with one more ``extra``."""
    ptxas = ''.join(f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
                    f'    0 bytes stack frame, {4 * (name == "mm3")} bytes spill stores, 0 bytes spill loads\n'
                    f'ptxas info    : Used {80 + i} registers, used 1 barriers\n'
                    for i, (name, fn) in enumerate(_KERNELS.items()))
    sass = ''.join(f'\t\tFunction : {fn}\n' + ''.join(
        _OPS[op] * (n + ((name, op) == extra)) for op, n in _COUNTS[name].items() if (name, op) != missing)
        for name, fn in _KERNELS.items())
    return ptxas, sass


@pytest.mark.parametrize('missing', [None, 'HGMMA', 'UTMALDG', 'UTMASTG', 'mm3s:HGMMA', 'mm3s:UTMALDG',
                                     'mm3s:UTMASTG', 'copy:LDG.E.128', 'copy:STG.E.128', 'copy:LDG.E.128+',
                                     'copy:STG.E.128+', 'v7:HGMMA', 'v7:UTMALDG', 'v7:UTMASTG'])
def test_chip_smoke_requires_wgmma_and_tma_in_the_sass(monkeypatch, missing):
    """Phase 10's proof of each rung's route: V2, V3, V4 and V7 on wgmma
    and TMA (V7 with V3's 24 HGMMA), V0 on one 16-byte load and store (a
    vector per thread, no loop).
    The counts and ptxas's registers join their kernels-line entries, and a
    kernel without one of its opcodes fails the run (``missing``: an opcode
    V2 lacks, or rung:opcode), as does a V0 with a second load or store
    (rung:opcode+)."""
    smoke = _chip_smoke()
    from wav2sleep_tpu_torch.ops import cuda_build

    gap = None if missing is None else tuple(missing.split(':')) if ':' in missing else ('mm1f', missing)
    extra = gap is not None and gap[1].endswith('+')
    ptxas, sass = _sass_listing(None, (gap[0], gap[1][:-1])) if extra else _sass_listing(gap)
    monkeypatch.setattr(cv, 'BUILD_LOG', ptxas)
    monkeypatch.setattr(cuda_build, 'sass', lambda path: sass)
    if missing:
        error = "has .* in its SASS; its route needs" if extra else "lacks an opcode of its route"
        with pytest.raises(AssertionError, match=f"{gap[0]}'s kernel {error}"):
            smoke.sass_evidence(cv, cuda_build)
        return
    assert smoke.sass_evidence(cv, cuda_build) == {
        'copy': {'sass_ldg_e_128': 1, 'sass_stg_e_128': 1, 'registers': 80, 'spill_bytes': 0},
        'mm1f': {'sass_hgmma': 8, 'sass_utmaldg': 4, 'sass_utmastg': 2, 'registers': 81, 'spill_bytes': 0},
        'mm3': {'sass_hgmma': 24, 'sass_utmaldg': 8, 'sass_utmastg': 2, 'registers': 82, 'spill_bytes': 4},
        'mm3s': {'sass_hgmma': 24, 'sass_utmaldg': 8, 'sass_utmastg': 2, 'registers': 83, 'spill_bytes': 0},
        'v7': {'sass_hgmma': 24, 'sass_utmaldg': 8, 'sass_utmastg': 16, 'registers': 84, 'spill_bytes': 0},
    }


def test_card_clock_reads_nvidia_smi_and_needs_the_card(monkeypatch):
    """The samples of ``card_clock`` as nvidia-smi prints them, and its
    refusal without a card (it measures the card's own clock)."""
    assert card_clock.parse('1980 MHz, 460.07 W\n1380 MHz, 705.17 W\n\n') == [(1980.0, 460.07), (1380.0, 705.17)]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='needs an NVIDIA card'):
        card_clock.run()
