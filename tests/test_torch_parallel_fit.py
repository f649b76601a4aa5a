"""``Trainer.fit`` over two ranks (``gloo`` on the CPU, one torch thread a
rank, a timeout on the group and on the launch), under each launch contract
of ``parallel.mesh``, against the equivalent one-process run, as
``tests/train/test_multihost.py`` and ``tests/train/test_trainer_mesh.py``
hold the JAX trainer: the final eval matrix within JAX's 2e-3 mesh gate;
every rank with the same numbers; a checkpoint that rank 0 wrote restored
on both ranks to the same state; only rank 0 writing ``metrics.jsonl``.
Also ``python -m wav2sleep_tpu_torch.preprocessing.ingest --shard-hosts``
in two processes under torchrun's environment: disjoint shards whose union
is the one-process corpus.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from wav2sleep_tpu_torch.data.dataset import batch_iterator
from wav2sleep_tpu_torch.parallel import mesh as pmesh
from wav2sleep_tpu_torch.train.datamodule import shard_train_files

from . import torch_parallel_workers as workers
from .test_torch_ingest import CARDIO, _edf, _tree, _xml
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_trainer import write_corpus
from .train.test_trainer_smoke import MODEL_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 300  # seconds, for the group's collectives and the launch
MESH_GATE = 2e-3  # tests/train/test_trainer_mesh.py's gate on the eval matrix
KW = dict(flip_polarity=True)  # the flip draws for the global batch


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('corpus')
    write_corpus(root)
    return root


@pytest.fixture(scope='module')
def weights():
    model = workers.build(MODEL_CFG, None)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _fit(corpus, log_dir, weights, per_process_batches):
    return pmesh.spawn(workers.fit_rank, ['cpu', 'cpu'], args=(str(corpus), str(log_dir), MODEL_CFG, weights, KW),
                       timeout=LAUNCH_TIMEOUT, deadline=LAUNCH_TIMEOUT, threads=1, per_process_batches=per_process_batches)


def _check(ranks, single, log_dir):
    """Both ranks agree with each other and with the one-process run."""
    r0, r1 = ranks
    assert r0['final'] == r1['final'] and r0['val'] == r1['val'] and r0['steps'] == r1['steps'] == single.state.step
    final = single.final
    assert set(r0['final']) == set(final) and 'val_ECG_loss_mesa' in final
    for key, v in final.items():
        np.testing.assert_allclose(r0['final'][key], v, rtol=MESH_GATE, atol=MESH_GATE, err_msg=key)
    for k, p in r0['params'].items():
        np.testing.assert_array_equal(r1['params'][k], p)
        np.testing.assert_array_equal(r0['restored'][k], p)  # rank 0's checkpoint, restored on each rank
        np.testing.assert_array_equal(r1['restored'][k], p)
    assert r0['epoch'] == r1['epoch'] == 2
    np.testing.assert_allclose(r0['val']['val_loss'], r0['final']['val_loss'], rtol=1e-5, atol=1e-6)
    for k, v in r0['preds'].items():
        np.testing.assert_array_equal(r1['preds'][k], v)
        assert v.shape == r0['preds']['labels'].shape
    # Rank 0 alone wrote the logs: each epoch's rows once.
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    assert [r['step'] for r in rows if 'train_loss' in r] == [0, 1]
    assert not os.path.exists(os.path.join(log_dir, 'restored1', 'metrics.jsonl'))


def _single(corpus, log_dir, weights, loader=None):
    tr = workers.port_trainer(corpus, log_dir, MODEL_CFG, weights, **KW)
    if loader is not None:
        tr.datamodule.train_loader = loader
    tr.final = tr.fit()
    return tr


def test_fit_one_launch_two_ranks_is_the_one_process_fit(corpus, weights, tmp_path):
    """One launch over two devices: each global batch of 4 split in rank
    order, each rank reading its own rows' nights from the one-card shuffle."""
    ranks = _fit(corpus, tmp_path / 'mesh', weights, per_process_batches=False)
    single = _single(corpus, tmp_path / 'single', weights)
    _check(ranks, single, tmp_path / 'mesh')
    _, loader = single.datamodule.test_loaders()[0]
    for k, v in single.predict(loader).items():
        np.testing.assert_array_equal(ranks[0]['preds'][k], v)


def test_fit_one_process_per_host_is_the_one_process_fit(corpus, weights, tmp_path):
    """torchrun's contract: each rank loads a batch of 4 from its shard of the
    files (``shard_train_files``); the one-process run takes the global
    batch [rank 0's rows, rank 1's rows], as tests/train/test_multihost.py
    builds it. The eval loaders are not sharded: each rank evaluates every
    batch and the sums count each night twice, which leaves the loss and the
    accuracy and kappa as they are."""
    ranks = _fit(corpus, tmp_path / 'hosts', weights, per_process_batches=True)
    probe = workers.port_trainer(corpus, tmp_path / 'probe', MODEL_CFG, weights, **KW)
    dm = probe.datamodule

    def two_host_loader(epoch):
        its = [iter(batch_iterator(dm._make_dataset(shard_train_files(dm._train_fps, dm.seed + epoch, 2, h)),
                                   batch_size=dm.batch_size, num_threads=1, pad_to_epochs=dm.pad_to_epochs))
               for h in (0, 1)]
        for (x0, y0), (x1, y1) in zip(*its):
            yield {k: np.concatenate([x0[k], x1[k]]) for k in x0}, np.concatenate([y0, y1])

    single = workers.port_trainer(corpus, tmp_path / 'single', MODEL_CFG, weights, **KW)
    single.datamodule.batch_size = 8  # the global batch of two hosts' 4
    single.datamodule.train_loader = two_host_loader
    single.final = single.fit()
    _check(ranks, single, tmp_path / 'hosts')


def _night(root, sid, rng):
    mesa = os.path.join(root, 'mesa', 'polysomnography')
    _xml(os.path.join(mesa, 'annotations-events-nsrr', f'{sid}-nsrr.xml'), (0, 1, 2, 3, 5, 0))
    _edf(os.path.join(mesa, 'edfs', f'{sid}.edf'), 720, rng)


def test_ingest_shard_hosts_under_torchrun(tmp_path):
    """Two processes with torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) join one group and write disjoint
    halves of the work list; their union is the one-process ingest, file
    for file and byte for byte."""
    raw = tmp_path / 'raw'
    rng = np.random.default_rng(0)
    for i in range(5):
        _night(str(raw), f'mesa-sleep-{i:04d}', rng)
    cmd = [sys.executable, '-m', 'wav2sleep_tpu_torch.preprocessing.ingest', '--folder', str(raw / 'mesa'),
           '--columns', *CARDIO]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1',
               MASTER_ADDR='localhost', MASTER_PORT=str(pmesh.free_port()), WORLD_SIZE='2')
    procs = [subprocess.Popen([*cmd, '--output-folder', str(tmp_path / f'host{r}'), '--shard-hosts'], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK='0'), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert 'torch.distributed backend gloo on cpu' in out
    subprocess.run([*cmd, '--output-folder', str(tmp_path / 'one')], cwd=ROOT, env=env, check=True,
                   capture_output=True, timeout=LAUNCH_TIMEOUT)
    shards = [_tree(tmp_path / f'host{r}') for r in range(2)]
    assert all(shards) and not set(shards[0]) & set(shards[1])
    assert sorted(shards[0] + shards[1]) == _tree(tmp_path / 'one')
    for r, names in enumerate(shards):
        for name in names:
            assert (tmp_path / f'host{r}' / name).read_bytes() == (tmp_path / 'one' / name).read_bytes()


def test_train_cli_num_devices_spawns_the_ranks(corpus, monkeypatch, tmp_path):
    """``python -m wav2sleep_tpu_torch.train num_devices=2 device=cpu``: one
    command spawns two gloo ranks that train together; rank 0's metrics come
    back, and rank 0 alone wrote the run folder (one train row an epoch,
    the export, final_metrics.json)."""
    from wav2sleep_tpu_torch.train import __main__ as cli

    from .test_torch_train_cli import NARROW

    monkeypatch.setenv('WAV2SLEEP_DATA', str(corpus))
    run_dir = tmp_path / 'run'
    final = cli.main(['device=cpu', *NARROW, 'num_devices=2', 'epochs=1', 'test=false', f'run_dir={run_dir}'])
    assert 'val_loss' in final and np.isfinite(final['val_loss'])
    with open(run_dir / 'metrics.jsonl') as f:
        rows = [json.loads(line) for line in f]
    assert [r['step'] for r in rows if 'train_loss' in r] == [0]
    assert (run_dir / 'model' / 'config.yaml').exists()
    with open(run_dir / 'final_metrics.json') as f:
        assert json.load(f) == pytest.approx(final)
