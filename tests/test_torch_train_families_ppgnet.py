"""The port's training step on the full-length SleepPPG-Net (feature_dim
32) against the JAX package's on the CPU: two steps from the same weights
and batch, each JAX step from the port's state, and the eval step
(``test_steps_track_jax``, ``test_eval_step_reads_the_running_statistics``
of ``tests/test_torch_train_families.py`` on this module's trajectory);
remat on against off; step 1's gradient against the f64 one. Split from
``tests/test_torch_train_families.py`` so that the test run spreads files
over its workers.

The module runs torch on ``GATE_THREADS`` intra-op threads, the count its
step-2 gradient-norm gate was set at: the f32 sums of batch norm's backward
split by thread, and SleepPPG-Net's step-2 gradient norm parts from JAX's by
8.14e-4 at 8 threads and 1.92e-3 at one, against the gate's 1e-3. A fixed
count gives the same sums on any machine, whatever its cores or
``OMP_NUM_THREADS``."""

import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu_torch import instantiate as tinstantiate

from .test_torch_families import model_pair
# The two trajectory tests are collected here too, on this module's `trajectory`.
from .test_torch_train_families import (KINDS, _as_torch, _batch, _t, _x0, check_remat, run_trajectory,  # noqa: F401
                                        test_eval_step_reads_the_running_statistics, test_steps_track_jax)


GATE_THREADS = 8


@pytest.fixture(autouse=True, scope='module')
def gate_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(GATE_THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=['ppgnet'])
def trajectory(request):
    """SleepPPG-Net's trajectory (``run_trajectory``)."""
    return run_trajectory(request.param)


@pytest.mark.parametrize('case', ['ppgnet-f32'])
def test_remat_step_equals_the_plain_step(case):
    """See ``test_torch_train_families.check_remat``."""
    check_remat(case)


def test_ppgnet_gradient_against_f64():
    """Where the two stacks part on SleepPPG-Net: step 1's gradients (batch
    norm over 1,228,800 samples a channel in the first window blocks) of
    the port in f32 and of JAX in f32 against the port's in f64. The port's
    gradient and gradient norm are as close to the f64 ones as JAX's
    (within twice its distance); the loss within 1e-5 relative."""
    from wav2sleep_tpu.train.metrics import cross_entropy_ignore_index as jce
    from wav2sleep_tpu_torch.train.metrics import cross_entropy_ignore_index as tce

    cfg = KINDS['ppgnet'][0]
    jmodel, variables, tmodel = model_pair(cfg, _x0('ppgnet'))
    x, y = _batch('ppgnet')

    def jloss(p):
        logits, _ = jmodel.apply({'params': p, 'batch_stats': variables['batch_stats']}, jnp.asarray(x['PPG']),
                                 train=True, mutable=['batch_stats'])
        return jce(logits.reshape(-1, 4), jnp.asarray(y).reshape(-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables['params'])
    grads = {'JAX f32': (float(jl), _as_torch(jg, 'ppgnet', variables['batch_stats']))}
    for dtype in (torch.float32, torch.float64):
        model = tinstantiate.build_model(cfg)
        model.load_state_dict(tmodel.state_dict())
        model.to(dtype).train()
        loss = tce(model(_t(x['PPG']).to(dtype)).reshape(-1, 4), _t(y).reshape(-1))
        g = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        grads[f'port {str(dtype)[6:]}'] = (float(loss.detach()), {n: v.double() for n, v in zip(names, g)})
    l64, g64 = grads.pop('port float64')
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum() for v in g.values())))  # noqa: E731
    dist = {k: float(torch.sqrt(sum(((g[n].double() - g64[n]) ** 2).sum() for n in g64)))
            for k, (_, g) in grads.items()}
    gn = {k: abs(norm(g) - norm(g64)) for k, (_, g) in grads.items()}
    worst = max(g64, key=lambda n: float((grads['port float32'][1][n] - g64[n]).norm()))
    print(f'SleepPPG-Net step 1 against f64 (|g| {norm(g64):.4f}): gradient distance {dist}, |d grad norm| {gn}; '
          f'the largest part in {worst} (f64 |g| {float(g64[worst].norm()):.3f}); losses '
          f'{ {k: v[0] for k, v in grads.items()} }, f64 {l64:.7f}')
    assert dist['port float32'] <= 2 * dist['JAX f32'] and gn['port float32'] <= 2 * gn['JAX f32']
    assert abs(grads['port float32'][0] - l64) <= 1e-5 * l64
