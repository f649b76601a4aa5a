"""The port's data-parallel layer in one process, against the JAX
package's: ``parallel.mesh`` (axis names, sizes, errors and their texts, the
row blocks), the q16, q8 and q4 pipelines over two CPU devices against one
device and against JAX's pipelines on a 2-device CPU mesh (exact
hypnograms), and the serving CLI's ``--data-parallel`` with its refusals.
The two-rank runs over ``torch.distributed`` are in
``tests/test_torch_parallel_step.py`` and ``tests/test_torch_parallel_fit.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import wav2sleep_tpu
from wav2sleep_tpu import parallel as jparallel
from wav2sleep_tpu import pipeline as jpipe
from wav2sleep_tpu.checkpoint import save_checkpoint_folder as jax_save_folder
from wav2sleep_tpu.parallel import mesh as jmesh
from wav2sleep_tpu_torch import parallel as tparallel
from wav2sleep_tpu_torch import pipeline as tpipe
from wav2sleep_tpu_torch import serve
from wav2sleep_tpu_torch.parallel import mesh as tmesh

from .test_torch_pipeline import model_pair  # noqa: F401 - a fixture
from .test_torch_serve import CONFIGS
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_transports import HOURS, SIGNALS, write_nights

ROOT = Path(__file__).resolve().parents[1]
PIPES = {'q16': (tpipe.StreamingPipelineQ16, jpipe.StreamingPipelineQ16),
         'q8': (tpipe.StreamingPipelineQ8, jpipe.StreamingPipelineQ8),
         'q4': (tpipe.StreamingPipelineQ4, jpipe.StreamingPipelineQ4)}


def test_version_is_the_jax_packages():
    import wav2sleep_tpu_torch

    assert wav2sleep_tpu_torch.__version__ == wav2sleep_tpu.__version__


def test_public_names_cover_the_jax_packages():
    assert set(jparallel.__all__) <= set(tparallel.__all__)
    assert (tmesh.DATA_AXIS, tmesh.MODEL_AXIS) == (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize('n, data, model', [(2, None, 1), (4, 2, 2), (4, None, 2), (2, 3, 1), (4, 3, 1), (3, None, 2)])
def test_make_mesh_sizes_and_errors_match_jax(n, data, model):
    want = _error(lambda: jmesh.make_mesh(jax.devices()[:n], data=data, model=model))
    got = _error(lambda: tmesh.make_mesh(['cpu'] * n, data=data, model=model))
    assert got == want
    if want is None:
        j, t = jmesh.make_mesh(jax.devices()[:n], data=data, model=model), tmesh.make_mesh(['cpu'] * n, data, model)
        assert t.shape == dict(j.shape) and t.size == j.devices.size
        assert t.devices == tuple(torch.device('cpu') for _ in range(n)) and not t.per_process_batches


@pytest.mark.parametrize('batch', [8, 6, 5, 1])
def test_local_batch_size_and_row_blocks_match_jax(batch):
    jm_, tm = jmesh.make_mesh(jax.devices()[:2], data=2), tmesh.make_mesh(['cpu', 'cpu'])
    want = _error(lambda: jmesh.local_batch_size(batch, jm_))
    assert _error(lambda: tmesh.local_batch_size(batch, tm)) == want
    if want is not None:
        assert want == f'global_batch={batch} not divisible by data-parallel size 2'
        return
    x = {'ECG': np.arange(batch * 3, dtype=np.float32).reshape(batch, 3)}
    y = np.arange(batch * 2, dtype=np.float32).reshape(batch, 2)
    sharded = jmesh.shard_batch(jm_, (x, y))
    first = sorted(sharded[1].addressable_shards, key=lambda s: s.index[0].start or 0)[0].data
    xs, ys = tmesh.shard_batch(tm, (x, y))  # rank 0 without a group
    np.testing.assert_array_equal(ys, np.asarray(first))
    np.testing.assert_array_equal(xs['ECG'], x['ECG'][: batch // 2])
    assert tmesh.global_batch_from_local(tm, (xs, ys)) == (xs, ys)
    assert tmesh.batch_rows(tm, batch // 2) == (0, batch)


def test_no_group_without_torchruns_environment(monkeypatch):
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT', 'LOCAL_RANK'):
        monkeypatch.delenv(key, raising=False)
    assert tmesh.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh(['cpu'])
    tree = {'w': torch.ones(3)}
    assert tmesh.replicate(mesh, tree)['w'] is tree['w']  # nothing sent, nothing copied
    assert tmesh.backend_for(['cpu', 'cpu']) == tmesh.backend_for(['cuda:0', 'cuda:0']) == 'gloo'
    assert tmesh.backend_for(['cuda:0', 'cuda:1']) == 'nccl'
    assert (tmesh.batch_sharding(mesh), tmesh.replicated(mesh)) == (('data',), ())


# ---------------------------------------------------------------- serving


@pytest.fixture(scope='module')
def nights(tmp_path_factory):
    folder = tmp_path_factory.mktemp('dp_nights')
    return [fp for fp in write_nights(folder) if not fp.endswith('bad.edf')] + write_nights(
        tmp_path_factory.mktemp('dp_nights2'))[:2]


@pytest.mark.parametrize('transport', list(PIPES))
def test_two_device_pipeline_is_one_device_and_jaxs_mesh(model_pair, nights, transport):  # noqa: F811
    """Exact hypnograms: the port over devices=['cpu', 'cpu'] (a replica
    each, a block of 2 of each batch of 4, the last batch short) equals the
    port on one device and JAX's pipeline on a 2-device CPU mesh, which
    equals JAX on one device."""
    jmodel, variables, tmodel = model_pair
    tcls, jcls = PIPES[transport]
    kw = dict(batch_size=4, max_length_hours=HOURS, precision='float32')
    one = dict(tcls(tmodel, list(SIGNALS), device='cpu', **kw).run(nights))
    pipe = tcls(tmodel, list(SIGNALS), devices=['cpu', 'cpu'], **kw)
    two = dict(pipe.run(nights))
    assert len(pipe._replicas) == 2 and pipe._replicas[1][1] is not pipe.forward
    mesh = jmesh.make_mesh(jax.devices()[:2], data=2, model=1)
    jax_two = dict(jcls(jmodel, variables, list(SIGNALS), mesh=mesh, **kw).run(nights))
    jax_one = dict(jcls(jmodel, variables, list(SIGNALS), **kw).run(nights))
    assert list(two) == list(one) == list(jax_two) == nights
    for fp in nights:
        np.testing.assert_array_equal(two[fp], one[fp])
        np.testing.assert_array_equal(jax_two[fp], jax_one[fp])
        np.testing.assert_array_equal(two[fp], jax_two[fp])


def test_batch_must_divide_over_the_devices_as_in_jax(model_pair):  # noqa: F811
    jmodel, variables, tmodel = model_pair
    mesh = jmesh.make_mesh(jax.devices()[:2], data=2, model=1)
    with pytest.raises(ValueError) as want:
        jpipe.StreamingPipelineQ16(jmodel, variables, list(SIGNALS), batch_size=3, mesh=mesh)
    for cls, _ in PIPES.values():
        with pytest.raises(ValueError) as got:
            cls(tmodel, list(SIGNALS), batch_size=3, devices=['cpu', 'cpu'])
        assert str(got.value) == str(want.value) == 'batch_size=3 must divide evenly over the data axis (2)'


def _jax_cli():
    spec = importlib.util.spec_from_file_location('jax_serve_cli', ROOT / 'scripts' / 'serve.py')
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


@pytest.fixture(scope='module')
def served(model_pair, tmp_path_factory):  # noqa: F811
    _, variables, _ = model_pair
    root = tmp_path_factory.mktemp('dp_serve')
    edfs, ckpt = root / 'edfs', str(root / 'ckpt')
    edfs.mkdir()
    write_nights(edfs)
    jax_save_folder(ckpt, CONFIGS['small'], variables, torch_compat=True)
    common = ['--input-folder', str(edfs), '--model-folder', ckpt, '--precision', 'float32',
              '--batch-size', '2', '--max-length-hours', str(HOURS), '--device', 'cpu']
    return root, common


def _outputs(folder):
    return {p.name: p.read_bytes() for p in sorted(Path(folder).iterdir())}


def test_serve_data_parallel_writes_the_same_bytes(served):
    root, common = served
    serve.main([*common, '--output-folder', str(root / 'one')])
    serve.main([*common, '--output-folder', str(root / 'two'), '--data-parallel', '2'])
    serve.main([*common, '--output-folder', str(root / 'q8'), '--data-parallel', '2', '--transport', 'q8'])
    one, two = _outputs(root / 'one'), _outputs(root / 'two')
    assert len(one) == 4 and two == one
    assert sorted(_outputs(root / 'q8')) == sorted(one)


@pytest.mark.parametrize('transport', ['raw', 'f32'])
def test_serve_data_parallel_refusals_match_jax(served, monkeypatch, tmp_path, transport):
    """raw and f32 refuse --data-parallel with the JAX script's SystemExit
    text; more replicas than cards raise, before any output."""
    root, common = served
    base = [*common[:-2], '--output-folder', str(tmp_path / 'out')]
    args = [*base, '--transport', transport, '--data-parallel', '2']
    want = _jax_cli()
    with pytest.raises(SystemExit) as jax_exit:
        want.make_pipeline(None, transport, list(SIGNALS), want.build_parser().parse_args(args), mesh=object())
    with pytest.raises(SystemExit) as port_exit:
        serve.main([*args, '--device', 'cpu'])
    assert str(port_exit.value) == str(jax_exit.value) == '--data-parallel requires --transport q8, q16 or q4'
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'is_available', lambda: True)
        m.setattr(torch.cuda, 'device_count', lambda: 1)
        with pytest.raises(ValueError, match='--data-parallel 2 but 1 CUDA device is visible'):
            serve.main([*base, '--data-parallel', '2'])
    assert not (tmp_path / 'out').exists()
