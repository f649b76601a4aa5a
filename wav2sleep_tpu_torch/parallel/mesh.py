"""Data-parallel groups on ``torch.distributed``.

The port's counterpart of ``wav2sleep_tpu/parallel/mesh.py``. The port runs
one process per device, PyTorch's idiom, so a rank stands where a device of
the JAX package's mesh stands, and the ranks together compute the step that
JAX computes on the sharded global batch: parameters replicated, the batch
split over the ``data`` axis, gradients summed across the group.

Two launch contracts, the JAX package's two:

- **one launch, N devices** (JAX's one process over a mesh): ``spawn`` starts
  a rank per device and forms the group itself. Each loader batch is the
  global batch; a rank takes its rows in rank order (``shard_batch``).
- **one process per host** (JAX's ``jax.distributed`` pods): torchrun starts
  the ranks and ``maybe_initialize_distributed`` joins them from its
  environment. Each rank loads its own rows (``global_batch_from_local``).

``Mesh.per_process_batches`` says which one a group runs. Every group is
made with an explicit ``timeout``, so a rank that fails stops the others
within it. The backend is chosen once and printed: ``nccl`` when every rank
has a card of its own, ``gloo`` on the CPU or when ranks share a card. It
is never swapped after a failure. ``gloo`` reduces CUDA tensors with
``all_reduce`` and ``broadcast`` only, so the port's collectives on tensors
are those two (a gather is a sum into zeros).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import multiprocessing
import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# A collective that waits longer than this fails its rank (and so the run).
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
# Seconds ``spawn`` waits, after a rank's failure, for the others' reports.
SETTLE_S = 5.0

# Set when this process joins a group: whether each rank loads its own batch.
_PER_PROCESS_BATCHES: bool | None = None
# The group that the training step and batch norm reduce over, while a step
# runs (``active``).
_ACTIVE: 'Mesh | None' = None
# A spawned rank's device (``spawn``).
_PER_RANK_DEVICE: torch.device | None = None


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices, one rank each, in rank order. The
    model axis keeps the JAX package's signature: it is 1 for this model
    family, and the training step refuses another size.

    ``per_process_batches`` is the launch contract: True where each rank
    loads its own rows (torchrun, one process per host), False where every
    rank reads the global batch and keeps its rows (``spawn``)."""

    devices: tuple[torch.device, ...]
    data: int
    model: int = 1
    per_process_batches: bool = False

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def data_index(self) -> int:
        """This rank's place on the data axis."""
        return self.rank // self.model

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def backend_for(devices) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    own_cards = all(d.type == 'cuda' for d in devs) and len({d.index for d in devs}) == len(devs)
    return 'nccl' if own_cards else 'gloo'


def init_group(rank: int, world: int, init_method: str, device: torch.device | str, backend: str,
               per_process_batches: bool, timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join a group of ``world`` ranks as ``rank`` over ``backend``, with
    ``device`` as this rank's device; raises when the group does not form."""
    global _PER_PROCESS_BATCHES
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    print(f'rank {rank}/{world}: torch.distributed backend {backend} on {device}', flush=True)
    kwargs = {'device_id': device} if backend == 'nccl' else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, timeout=timeout,
                            **kwargs)
    _PER_PROCESS_BATCHES = per_process_batches


def _env_device() -> torch.device:
    local = int(os.environ.get('LOCAL_RANK', os.environ.get('RANK', '0')))
    return torch.device(f'cuda:{local}') if torch.cuda.is_available() else torch.device('cpu')


def maybe_initialize_distributed(timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the group that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), each
    rank loading its own rows, on ``cuda:LOCAL_RANK`` (the CPU without a
    card). Without that environment it does nothing. A group that does not
    form raises: the run never goes on as duplicate single-card runs.
    Returns whether more than one process runs."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not all(os.environ.get(k) for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')):
        return False
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    device = _env_device()
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    own = device.type == 'cuda' and local_world <= torch.cuda.device_count()
    try:
        init_group(rank, world, 'env://', device, 'nccl' if own else 'gloo', per_process_batches=True,
                   timeout=timeout)
    except Exception as e:
        raise RuntimeError(f'torch.distributed did not form the group of {world} processes that the '
                           f'environment asks for (rank {rank}): {e}') from e
    return world > 1


def make_mesh(devices=None, data: int | None = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over ``devices``, which go to ranks in order:
    every rank's device when a group is formed (gathered from the ranks),
    else every visible card (the CPU without one)."""
    if devices is None:
        if dist.is_initialized():
            here = str(_PER_RANK_DEVICE if _PER_RANK_DEVICE is not None else _env_device())
            gathered: list = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, here)
            devices = gathered
        elif torch.cuda.is_available():
            devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
        else:
            devices = ['cpu']
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f'{data=} * {model=} != {n} devices')
    if dist.is_initialized() and n != dist.get_world_size():
        raise ValueError(f'{n} devices for a group of {dist.get_world_size()} ranks: one device a rank')
    return Mesh(devices, data, model, per_process_batches=bool(_PER_PROCESS_BATCHES))


def batch_sharding(mesh: Mesh) -> tuple[str, ...]:
    """The partition spec of a batch: its leading axis split over the data
    axis, in rank order."""
    return (DATA_AXIS,)


def replicated(mesh: Mesh) -> tuple[str, ...]:
    """The partition spec of a replicated tree: split over no axis."""
    return ()


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n_data = mesh.shape[DATA_AXIS]
    if global_batch % n_data:
        raise ValueError(f'{global_batch=} not divisible by data-parallel size {n_data}')
    return global_batch // n_data


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (arrays or tensors, nested in
    dicts and tuples): block ``data_index`` of ``data`` equal blocks."""
    rows = local_batch_size(int(_leaves(batch)[0].shape[0]), mesh)
    start = mesh.data_index * rows
    return _map(lambda x: x[start : start + rows], batch)


def global_batch_from_local(mesh: Mesh, batch):
    """A rank's own rows are its part of the global batch as they are: the
    global batch is every rank's rows in rank order."""
    return batch


def batch_rows(mesh: Mesh | None, local_rows: int) -> tuple[int, int]:
    """(first row, global rows) of this rank's block of a global batch in
    which every rank holds ``local_rows``."""
    if mesh is None:
        return 0, local_rows
    return mesh.data_index * local_rows, mesh.data * local_rows


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """Two numbers that tell tensors apart: the sum and a position-weighted
    sum, in float64."""
    x = t.detach().reshape(-1).to(torch.float64)
    w = torch.arange(1, x.numel() + 1, dtype=torch.float64, device=x.device) / max(x.numel(), 1)
    return torch.stack([x.sum(), (x * w).sum()])


def replicate(mesh: Mesh, tree):
    """The tree on this rank's device, after one ``all_reduce`` that checks
    it is equal on every rank. The state is equal by construction (a seeded
    init or a restored checkpoint), so nothing is broadcast, as the JAX
    package's ``replicate`` sends nothing; a rank whose state differs raises
    instead of training on."""
    tree = _map(lambda x: x.to(mesh.device) if isinstance(x, torch.Tensor) else x, tree)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    tensors = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    sums = torch.cat([_checksum(t) for t in tensors]) if tensors else torch.zeros(1, dtype=torch.float64)
    both = torch.cat([sums, -sums]).to(mesh.device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, neg_lo = both.chunk(2)
    if not torch.equal(hi, -neg_lo):
        raise RuntimeError(f'rank {mesh.rank}: the replicated state differs across ranks')
    return tree


def barrier(mesh: Mesh | None = None) -> None:
    """Every rank waits for the others (nothing without a group). Called
    once after set-up, while the ranks are in step, it opens the
    communicator before the first collective of training: the JAX
    package's ``warmup_collectives``."""
    if dist.is_initialized():
        dist.barrier()


warmup_collectives = barrier


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed across the group (in place; as it is without one)."""
    if dist.is_initialized():
        dist.all_reduce(t)
    return t


def gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's block of rows, in rank order, on every rank: a sum into
    zeros, which ``gloo`` runs on CUDA tensors too."""
    rows = t.shape[0]
    out = torch.zeros((mesh.data * rows, *t.shape[1:]), dtype=t.dtype, device=t.device)
    start = mesh.data_index * rows
    out[start : start + rows] = t
    return all_reduce_sum(out)


@contextlib.contextmanager
def active(mesh: Mesh | None):
    """Inside the block, the step's reductions (batch norm's statistics) run
    over ``mesh``'s group; ``current()`` reads it. Process-wide, not
    per-thread: autograd's device threads recompute rematerialised blocks."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, mesh if mesh is not None and dist.is_initialized() else None
    try:
        yield
    finally:
        _ACTIVE = saved


def current() -> Mesh | None:
    return _ACTIVE


# ---------------------------------------------------------------- spawn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, devices: list[str], init_method: str, backend: str, timeout_s: float, threads,
               per_process_batches: bool, fn: Callable, args: tuple, results) -> None:
    global _PER_RANK_DEVICE
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        _PER_RANK_DEVICE = torch.device(devices[rank])
        init_group(rank, len(devices), init_method, devices[rank], backend, per_process_batches,
                   timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            with contextlib.suppress(Exception):
                dist.destroy_process_group()
        results.put((rank, 'ok', out))
    except BaseException:  # noqa: BLE001 - reported to the launcher, which raises it
        results.put((rank, 'err', traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable, devices, args: tuple = (), timeout: float = 600.0, deadline: float | None = None,
          threads: int | None = None, per_process_batches: bool = False) -> list[Any]:
    """Run ``fn(*args)`` in one spawned process per device of ``devices``,
    joined in a group; returns each rank's result, by rank. The group runs
    the one-launch contract (every rank reads the global batch and keeps its
    rows) unless ``per_process_batches``, which stands in for torchrun's
    one process per host on one machine.

    ``fn`` is a module-level function; its result must pickle. ``timeout``
    bounds each of the group's collectives, not the run: a rank that fails,
    or hangs in a collective, breaks the others' collectives, and then every
    rank is ended and ``RuntimeError`` raised with the failures'
    tracebacks. ``deadline``, where given, bounds the whole launch in
    seconds. ``threads`` sets each rank's torch thread count; the backend
    is ``backend_for(devices)``."""
    devices = [str(torch.device(d)) for d in devices]
    backend = backend_for(devices)
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    init_method = f'tcp://localhost:{free_port()}'
    procs = [ctx.Process(target=_rank_main, args=(r, devices, init_method, backend, timeout, threads,
                                                  per_process_batches, fn, args, results), daemon=True)
             for r in range(len(devices))]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    errors: dict[int, str] = {}
    t_end = None if deadline is None else time.monotonic() + deadline
    settle = None
    try:
        while len(out) + len(errors) < len(procs):
            now = time.monotonic()
            if settle is not None and now > settle:
                break
            if t_end is not None and now > t_end:
                raise RuntimeError(f'spawned ranks did not finish within {deadline:.0f} s '
                                   f'({sorted(set(range(len(procs))) - set(out))} still running)')
            try:
                rank, kind, payload = results.get(timeout=1.0)
            except queue.Empty:
                if settle is None and any(r not in out and p.exitcode not in (None, 0) for r, p in enumerate(procs)):
                    settle = now + SETTLE_S
                continue
            if kind == 'err':
                errors[rank] = payload
                # The other ranks fail in turn when the group breaks: a few
                # seconds for their reports, then every rank is ended.
                settle = settle or time.monotonic() + SETTLE_S
            else:
                out[rank] = payload
        if len(out) < len(procs):
            lines = [f'rank {r} failed:\n{tb}' for r, tb in sorted(errors.items())]
            lines += [f'rank {r} exited with code {p.exitcode} without a result' for r, p in enumerate(procs)
                      if r not in out and r not in errors and p.exitcode not in (None, 0)]
            raise RuntimeError('\n'.join(lines))
        for p in procs:
            p.join(timeout=60)  # each rank has put its result and exits
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [out[r] for r in range(len(procs))]


def devices_for(n: int, device: torch.device, asked: str) -> list[str]:
    """The devices that a count ``n`` of an entry point asks for: every
    visible card at 0 (``device`` itself where it names one), the first
    ``n`` cards otherwise; ``max(n, 1)`` ranks of ``device`` when it is not
    a card. More than the visible cards raises, naming ``asked``."""
    if device.type != 'cuda':
        return [str(device)] * max(n, 1)
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(f'{asked} but {cards} CUDA device{"s" if cards != 1 else ""} '
                         f'{"are" if cards != 1 else "is"} visible')
    if device.index is not None and n <= 1:
        return [str(device)]
    return [f'cuda:{i}' for i in range(n or cards)]


def seeded_int(*keys: int) -> int:
    """A seed derived from ``keys`` (numpy's ``SeedSequence``)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1)[0])
