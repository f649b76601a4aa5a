"""The port's trainer on the CPU: the EMA offloaded to the host equals the
in-graph EMA, without and with accumulation (``train.loop``). Split from
``tests/test_torch_trainer.py``, whose corpus and trainer builder it uses,
so that the test run spreads the fits over its workers."""

import numpy as np
import pytest

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_trainer import corpus, port_trainer  # noqa: F401 - corpus is a fixture


@pytest.mark.parametrize('accumulate', [1, 2])
def test_offloaded_ema_equals_the_in_graph_ema(corpus, tmp_path, accumulate):
    kw = dict(epochs=2, ema_decay=0.8, ema_start_step=1, accumulate_grad_batches=accumulate,
              metric_fetch_every=1 if accumulate == 1 else 16, stage_ring=2, dm_kw=dict(batch_size=2))
    graph = port_trainer(corpus, tmp_path / 'graph', **kw)
    graph.fit()
    host = port_trainer(corpus, tmp_path / 'host', ema_offload=True, **kw)
    host.fit()
    assert host.state.ema_params is None
    for k, v in graph.state.ema_params.items():
        np.testing.assert_allclose(host.host_ema[k], v.numpy(), rtol=0, atol=1e-7)
        assert not np.array_equal(host.host_ema[k], host.state.params[k].detach().numpy()) or v.numel() < 4
