"""One torch intra-op thread while a port test module runs.

The suite runs on 6 xdist workers (the command in ROADMAP.md). torch's
default is an intra-op thread per core in each worker, so six workers run
six pools as large as the machine, and they spin against each other: on an
8-core host a trainer test of ``tests/test_torch_trainer_ema.py`` that
takes 21 s alone took 500 s beside five copies of itself at torch's
default of 8 threads, and 27 s beside them at one thread each. Each port
test module imports ``one_torch_thread`` (autouse, module scope), which
sets one thread for the module's tests and fixtures and restores the count
after them; the subprocesses of ``tests/test_torch_imports.py`` get
``OMP_NUM_THREADS=1``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_port_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
