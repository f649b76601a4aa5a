"""Host-side task parallelism for ingestion.

The port's copy of ``wav2sleep_tpu/parallel/map.py``. ``parallelise`` is an
order-preserving parallel map with a bounded number of tasks in flight, over
processes. They start by ``spawn``: a caller that holds CUDA or threads (a
trainer, ``chip_smoke.py``) must not ``fork``, and a spawned worker imports
the function anew, so it has to be a module-level function (or a
``functools.partial`` of one). ``shard_across_hosts`` splits
a work list across the processes of a ``torch.distributed`` group.
"""

from __future__ import annotations

import logging
import multiprocessing
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from typing import Callable, Iterable, TypeVar

logger = logging.getLogger(__name__)

X = TypeVar('X')
Y = TypeVar('Y')

START_METHOD = 'spawn'


def parallelise(func: Callable[[X], Y], iterator: Iterable[X], max_parallel: int = 10) -> list[Y]:
    """Parallel map over ``spawn`` processes with bounded in-flight tasks and
    ordered results, with a progress bar when ``tqdm`` imports.

    Args:
        func: single-argument, module-level function (``functools.partial``
            for extra arguments).
        iterator: arguments.
        max_parallel: maximum concurrent tasks (each task gets one process).
    """
    items = list(iterator)
    try:
        from tqdm import tqdm

        progress = tqdm(total=len(items))
    except ImportError:
        progress = None

    results: list = [None] * len(items)
    context = multiprocessing.get_context(START_METHOD)
    with ProcessPoolExecutor(max_workers=max_parallel, mp_context=context) as pool:
        pending = {}
        it = iter(enumerate(items))
        exhausted = False
        while pending or not exhausted:
            while not exhausted and len(pending) < max_parallel:
                try:
                    i, item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending[pool.submit(func, item)] = i
            if not pending:
                break
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                i = pending.pop(fut)
                results[i] = fut.result()
                if progress:
                    progress.update(1)
    if progress:
        progress.close()
    return results


def shard_across_hosts(items: list[X], process_index: int | None = None, process_count: int | None = None) -> list[X]:
    """This process's round-robin share of a global work list: by the rank
    and world size of the ``torch.distributed`` group when one is
    initialised, else all of it (rank 0 of 1)."""
    if process_index is None or process_count is None:
        process_index, process_count = 0, 1
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                process_index, process_count = dist.get_rank(), dist.get_world_size()
        except ImportError:
            pass
    return items[process_index::process_count]
