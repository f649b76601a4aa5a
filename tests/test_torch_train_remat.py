"""The port's training step on the CPU, split from
``tests/test_torch_train.py`` (whose models and batches these use) so that
the test run spreads the steps over its workers: the bf16 step within
twice the JAX package's own bf16 error, remat's gradients equal to the
plain step's, the step's seeded randomness, the eval step's decode and
masks, and ``train_bench`` on the CPU."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wav2sleep_tpu.train import metrics as jmetrics
from wav2sleep_tpu_torch import train_bench
from wav2sleep_tpu_torch.models.wav2sleep import build_wav2sleep, flagship_config
from wav2sleep_tpu_torch.ops import q8_transport as q8
from wav2sleep_tpu_torch.train import metrics
from wav2sleep_tpu_torch.train import step as tstep
from wav2sleep_tpu_torch.train.masker import SignalMasker

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_train import _as_torch_params, _batch, _narrow_pair, _port_loss_and_grads, _t


def test_bf16_step_is_within_twice_jaxs_bf16_error():
    """The port's bf16 loss and gradients against its f32 ones (which equal
    JAX's f32 ones, above), within twice the distance of JAX's bf16 step
    from the same f32 values (the method of ROADMAP fault C.2). The model
    has the respiratory encoders only, which keeps XLA's bf16 compile
    short."""
    signals = ('ABD', 'THX')
    jmodel, variables, tmodel = _narrow_pair(signals)
    x, y = _batch(signals=signals)

    def jloss(params):
        p16 = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
        xin = {k: jnp.asarray(v, jnp.bfloat16) for k, v in x.items()}
        logits = jmodel.apply({'params': p16}, xin, train=True, rngs={'dropout': jax.random.PRNGKey(0)})
        return jmetrics.cross_entropy_ignore_index(logits.reshape(-1, 4), jnp.asarray(y).reshape(-1))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables['params'])
    jg = _as_torch_params(jg)
    l32, g32 = _port_loss_and_grads(tmodel, x, y, None)
    l16, g16 = _port_loss_and_grads(tmodel, x, y, torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in g16.values())  # f32 gradients of the f32 masters

    def dist(g):
        return float(torch.sqrt(sum(((g[k] - g32[k]) ** 2).sum() for k in g32)))

    jax_err = (abs(float(jl) - l32), dist(jg))
    port_err = (abs(l16 - l32), dist(g16))
    print(f'bf16 vs f32: loss {port_err[0]:.3e} (JAX {jax_err[0]:.3e}), gradients {port_err[1]:.3e} '
          f'(JAX {jax_err[1]:.3e}), |g| {dist({k: 0 * v for k, v in g32.items()}):.3e}')
    assert 0 < jax_err[1] and port_err[1] <= 2 * jax_err[1]
    assert port_err[0] <= 2 * max(jax_err[0], 2.0**-8 * abs(l32))


@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16])
def test_remat_gives_the_same_gradients(compute_dtype):
    x, y = _batch(seed=3)
    out = []
    for remat in (False, True):
        cfg = flagship_config(32, 32)
        cfg['encoders']['remat'] = remat
        model = build_wav2sleep(**cfg)
        out.append(_port_loss_and_grads(model, x, y, compute_dtype))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6 if compute_dtype is None else 0)


def test_step_randomness_is_seeded_and_leaves_the_global_stream():
    """Dropout, flip and masker draw from (seed, step): one seed gives one
    step twice, another seed another step; the global RNG is untouched."""
    x, y = _batch(B=3, seed=4)
    losses = {}
    for seed in (0, 0, 1):
        model = build_wav2sleep(**flagship_config(32, 32))  # dropout 0.1 in the mixers
        opt = tstep.make_optimizer(1e-3)
        state = tstep.init_train_state(model, opt)
        masker = SignalMasker(train_bench.DROPOUTS, train_bench.BACKUPS)
        step = tstep.make_train_step(model, opt, 4, masker=masker, flip_polarity=True)
        before = torch.random.get_rng_state()
        _, m = step(state, ({k: _t(v) for k, v in x.items()}, _t(y)), seed)
        assert torch.equal(torch.random.get_rng_state(), before)
        losses.setdefault(seed, []).append(float(m['loss']))
    assert losses[0][0] == losses[0][1] and losses[1][0] != losses[0][0]


def test_eval_step_decodes_and_masks():
    tmodel = build_wav2sleep(**flagship_config(32, 32))
    x, y = _batch(seed=5)
    enc = {k: tuple(_t(a) for a in v) for k, v in q8.encode_batch_q16(x).items()}
    present = {'ECG': torch.tensor([False, True])}
    ev = tstep.make_eval_step(tmodel, 4)
    params = dict(tmodel.named_parameters())
    got = ev(params, (enc, _t(y)), present)
    with torch.no_grad():
        logits = tmodel.eval()(q8.dequant_batch(enc), present=present)
    torch.testing.assert_close(got['preds'], logits.argmax(-1))
    torch.testing.assert_close(got['loss'], metrics.cross_entropy_ignore_index(logits.reshape(-1, 4), _t(y).reshape(-1)))
    assert int(got['cmat'].sum()) == int((y >= 0).sum())
    # Other parameters (an EMA) go in by name; the model's own are kept.
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    assert float(ev(zeros, (enc, _t(y)))['preds'].abs().sum()) == 0
    assert torch.equal(ev(params, (enc, _t(y)), present)['preds'], got['preds'])


def test_train_bench_needs_a_card_unless_told_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            train_bench.run(batch=1, epochs_per_night=1, k=2, reps=1)
    train_bench.main(['--device', 'cpu', '--batch', '1', '--epochs-per-night', '1', '--feature-dim', '16',
                      '--precision', 'float32', '--k', '2', '--reps', '1', '--transport', 'q8'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['device'] == 'cpu' and line['card'] is None and line['peak_gib'] is None
    assert np.isfinite(line['loss']) and line['compute_ms_per_step'] > 0 and line['nights_per_hour_e2e'] > 0
    assert line['k1_launches_per_step'] == 0  # the plain versions run on the CPU
