"""The port's trainer (``train.loop``, ``train.checkpointing``,
``train.tuning``) on the CPU: a 2-epoch fit against the JAX package's
``Trainer.fit`` from the same initial weights on the same parquet corpus
(losses, learning rates, confusion matrices, metrics.jsonl, parameters,
predictions), the exported folder in JAX's ``load_model``, and the port's
own behaviour: runs without or with a non-finite validation, the epoch
seeds and the eval transport, bf16 and q8 fits, batch-size tuning. Resume,
early stopping, the EMA on restore and the plateau cut are in
``tests/test_torch_trainer_resume.py``, the offloaded EMA in
``tests/test_torch_trainer_ema.py``; they use this module's corpus and
trainer builder (the test run spreads files over its workers)."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from wav2sleep_tpu import api as japi
from wav2sleep_tpu_torch import instantiate
from wav2sleep_tpu_torch.convert import from_jax_variables
from wav2sleep_tpu_torch.data import parquet
from wav2sleep_tpu_torch.train import step as step_mod
from wav2sleep_tpu_torch.train.datamodule import SleepDataModule
from wav2sleep_tpu_torch.train.loop import Trainer, epoch_seed
from wav2sleep_tpu_torch.train.tuning import tune_batch_size

from .test_torch_train import ADAM_RATIO, PARAM_ATOL, _adam_mu, _noisy, _param_diffs
from .train.test_trainer_smoke import EPOCHS_PER_NIGHT, MODEL_CFG, make_trainer
from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse

LOSS_RTOL = 5e-4  # per-epoch losses, port against JAX
LR_ATOL = 1e-7
TIE_MARGIN = 1e-3  # top-two logit margin under which the two stacks may pick differently
TIMING_KEYS = ('time', 'train_steps_per_sec', 'host_loader_frac')
LR, WARMUP = 3e-3, 5
# The share of elements whose Adam first moments the stacks put over 10%
# apart after some step. tests/test_torch_train.py bounds it at 1% over 3
# steps of the narrow flagship (0.29% there); the smoke model here is a
# sixth of its size and runs 4 steps, and every moment that passes near
# zero between sign changes is flagged: 1.91% measured. Each flagged
# element is still held to Adam's reach, and the other 98% to 1e-4.
FIT_NOISY_SHARE = 0.03
# No single tensor may hide behind the exception: at most 10% of each
# tensor's elements are flagged (6.25% measured, 1 of 16), so a wrong
# gradient on a small tensor (a norm scale, a bias, the classifier) still
# meets the 1e-4 gate. The one exempt slice is the key third of attention's
# in_proj_bias: a constant added to every score of a query leaves its
# softmax unchanged, so that bias's gradient is zero and its moments are
# f32 noise on both stacks (16 of its 16 elements flagged).
FIT_NOISY_TENSOR_SHARE = 0.10


def _gated(name, flags):
    """The flags of ``name`` that the per-tensor cap counts."""
    if name.endswith('self_attn.in_proj_bias'):
        d = flags.numel() // 3
        return torch.cat([flags[:d], flags[2 * d:]])
    return flags


def write_corpus(root, datasets=('mesa', 'shhs'), nights_per_split=4):
    """tests/train/test_trainer_smoke.py's corpus (the same draws), written
    with the port's ``write_night``."""
    rng = np.random.default_rng(0)
    for ds in datasets:
        for split in ('train', 'val', 'test'):
            folder = root / ds / split
            folder.mkdir(parents=True)
            for n in range(nights_per_split):
                labels = rng.integers(0, 4, size=EPOCHS_PER_NIGHT)
                ecg = np.concatenate([(lab + 1.0) * np.sin(np.arange(1024) / 3.0) + 0.05 * rng.normal(size=1024)
                                      for lab in labels]).astype(np.float32)
                thx = np.concatenate([np.full(256, float(lab)) + 0.05 * rng.normal(size=256)
                                      for lab in labels]).astype(np.float32)
                parquet.write_night(str(folder / f'{ds}-night{n}.parquet'),
                                    {'ECG': ecg, 'THX': thx, 'Stage': labels.astype(np.float32)})
    parquet.write_night(str(root / datasets[0] / 'train' / 'bad.issues.parquet'), {'ECG': np.zeros(1024, np.float32)})


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('corpus')
    write_corpus(root)
    return root


def port_trainer(corpus, log_dir, model=None, dm_kw=None, **kw):
    """The port's counterpart of the smoke test's ``make_trainer`` (masker
    and flip off unless given), on the CPU."""
    dm_args = dict(
        columns=['ECG', 'THX'], data_location=str(corpus), train_datasets=['mesa', 'shhs'],
        val_datasets=['mesa', 'shhs'], test_datasets=['mesa'], test=True, batch_size=4, val_batch_size=4,
        test_batch_size=4, num_workers=1, pad_to_epochs=EPOCHS_PER_NIGHT, max_length_hours=1, device='cpu')
    dm = SleepDataModule(**{**dm_args, **(dm_kw or {})})
    args = dict(model=model if model is not None else instantiate.build_model(MODEL_CFG), datamodule=dm,
                num_classes=4, epochs=2, lr=LR, warmup_steps=WARMUP, tau=1000.0, masker=None, flip_polarity=False,
                log_dir=str(log_dir), seed=0, progress_bar=False)
    args.update(kw)
    return Trainer(**args)


def _rows(log_dir):
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def fits(corpus, tmp_path_factory):
    """2 epochs x 2 steps of both trainers from JAX's initial weights (masker
    and flip off, dropout 0), each step's Adam first moments, and both
    trainers after the fit."""
    root = tmp_path_factory.mktemp('fits')
    jt = make_trainer(corpus, root / 'jax', masker=None, flip_polarity=False)
    jt._ensure_state(next(iter(jt.datamodule.train_loader(0))))
    model = instantiate.build_model(MODEL_CFG)
    model.load_state_dict(from_jax_variables({'params': jax.device_get(jt.state.params)}), strict=True)
    pt = port_trainer(corpus, root / 'port', model=model)
    # Both stacks' Adam first moments after every step, by the port's names.
    jmu, pmu = [], []
    jstep, pstep = jt._jit_train, pt._train_step

    def jax_step(*args):
        state, metrics = jstep(*args)
        jmu.append(from_jax_variables({'params': jax.tree_util.tree_map(np.asarray, _adam_mu(state.opt_state))}))
        return state, metrics

    def port_step(*args):
        state, metrics = pstep(*args)
        pmu.append({k: m.detach().clone() for k, m in zip(state.params, state.opt_state.mu)})
        return state, metrics

    jt._jit_train, pt._train_step = jax_step, port_step
    jfinal, pfinal = jt.fit(), pt.fit()
    moments = list(zip(pmu, jmu))
    assert len(moments) == 4
    return dict(jax=jt, port=pt, jfinal=jfinal, pfinal=pfinal, moments=moments, root=root)


def test_fit_losses_and_lr_match_jax(fits):
    jrows, prows = _rows(fits['root'] / 'jax'), _rows(fits['root'] / 'port')
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]  # the same keys, row by row
    n_loss = 0
    for p, j in zip(prows, jrows):
        assert p['step'] == j['step']
        for k, v in j.items():
            if k in TIMING_KEYS or '_eval_seconds_' in k or k.endswith(('_acc', '_kappa')):
                continue
            if 'loss' in k:
                assert p[k] == pytest.approx(v, rel=LOSS_RTOL), k
                n_loss += 1
            elif k == 'lr':
                assert abs(p[k] - v) <= LR_ATOL
            else:
                assert p[k] == v, k  # lr_step
    assert n_loss >= 2 * (1 + 1 + 2 + 2 + 1)  # train, val, per dataset, per subset, both epochs
    assert set(fits['pfinal']) == set(fits['jfinal'])
    for k, v in fits['jfinal'].items():
        assert fits['pfinal'][k] == pytest.approx(v, rel=LOSS_RTOL), k
    assert fits['port'].state.step == int(fits['jax'].state.step) == 4


def test_fit_parameters_within_the_step_gates(fits):
    """The step test's gate (tests/test_torch_train.py): 1e-4 outside the elements whose Adam first moments the
    two stacks put over 10% apart after some step, and those within Adam's
    reach (2 x 1.01 x the summed LR); see FIT_NOISY_SHARE for their share."""
    noisy = _noisy(fits['moments'])
    rest, inside, _ = _param_diffs(fits['port'].state.params, fits['jax'].state.params, noisy)
    share = sum(int(v.sum()) for v in noisy.values()) / sum(v.numel() for v in noisy.values())
    reach = 2 * ADAM_RATIO * sum(LR * (c + 1) / WARMUP for c in range(4))
    print(f'params: max |d| {rest:.3e} outside {share:.2%} noisy elements, {inside:.3e} inside (reach {reach:.2e})')
    per_tensor = {k: float(_gated(k, v).float().mean()) for k, v in noisy.items()}
    worst = max(per_tensor, key=per_tensor.get)
    print(f'  most flagged tensor: {worst} {per_tensor[worst]:.2%} (cap {FIT_NOISY_TENSOR_SHARE:.0%})')
    assert rest <= PARAM_ATOL and inside <= reach and share <= FIT_NOISY_SHARE
    assert per_tensor[worst] <= FIT_NOISY_TENSOR_SHARE, worst


def _logit_margins(trainer, loader):
    """Top-two logit margin of every epoch of the loader's nights, by the
    port's eval forward."""
    out = []
    params = trainer._eval_params()
    trainer.model.eval()
    with torch.no_grad():
        for x, _ in loader:
            logits = torch.func.functional_call(trainer.model, params, ({k: torch.from_numpy(v) for k, v in x.items()},))
            top = logits.topk(2, dim=-1).values
            out.append((top[..., 0] - top[..., 1]).numpy())
    return np.concatenate(out)


def test_predictions_and_confusion_matrices_match_off_near_ties(fits):
    jt, pt = fits['jax'], fits['port']

    def loader(trainer, name):  # a fresh iterator each time
        return dict(trainer.datamodule.val_loaders())[name]

    for name, _ in pt.datamodule.val_loaders():
        ours, theirs = pt.predict(loader(pt, name)), jt.predict(loader(jt, name))
        assert set(ours) == set(theirs) == {'labels', 'preds', 'preds_ECG', 'preds_ECG_THX'}
        clear = _logit_margins(pt, loader(pt, name)) >= TIE_MARGIN
        np.testing.assert_array_equal(ours['labels'], theirs['labels'])
        np.testing.assert_array_equal(ours['preds'][clear], theirs['preds'][clear])
        subsets = tuple(pt._subset_matrix(name, 'val'))
        pstats = pt._run_eval(loader(pt, name), subsets, batch_size=4)
        jstats = jt._run_eval(loader(jt, name), subsets, batch_size=4)
        # A near tie may flip a prediction under any subset: at most two
        # cells of a confusion matrix move per tied epoch.
        ties = int((~clear & (ours['labels'] >= 0)).sum())
        for key in (None, *subsets):
            assert pstats[key][1].sum() == jstats[key][1].sum() > 0
            assert np.abs(pstats[key][1] - jstats[key][1]).sum() <= 2 * ties, (name, key)
            assert pstats[key][0] == pytest.approx(jstats[key][0], rel=LOSS_RTOL)


def test_exported_folder_loads_in_jax(fits, tmp_path):
    pt = fits['port']
    folder = str(tmp_path / 'model')
    pt.export(folder, instantiate.reference_compatible_config(MODEL_CFG))
    jmodel = japi.load_model(folder)
    x, _ = next(iter(pt.datamodule.test_loaders()[0][1]))
    want = jmodel.logits(x)
    pt.model.eval()
    with torch.no_grad():
        got = pt.model({k: torch.from_numpy(v) for k, v in x.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


def test_resuming_past_the_last_epoch_returns_the_last_val_metrics(fits, tmp_path):
    """The deliberate difference from the JAX package (which returns {}):
    a resume at start_epoch >= epochs trains nothing and returns the last
    evaluation's val metrics from metrics.jsonl."""
    root = fits['root'] / 'port'
    pt = port_trainer(fits['port'].datamodule.data_location, root, epochs=2)
    assert pt.fit(resume_from='last') == pytest.approx(fits['pfinal'], rel=0, abs=0)
    assert pt.state.step == 4
    jt = make_trainer(fits['port'].datamodule.data_location, fits['root'] / 'jax', masker=None, flip_polarity=False)
    assert jt.fit(resume_from='last') == {}


# ---------------------------------------------------------------- the port's own behaviour


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


def test_no_validation_trains_every_epoch(corpus, tmp_path):
    trainer = port_trainer(corpus, tmp_path / 'noval', epochs=3, dm_kw=dict(val_datasets=[]))
    assert trainer.fit() == {}
    assert trainer.state.step == 6
    with open(tmp_path / 'noval' / 'checkpoints' / 'last.meta.json') as f:
        assert json.load(f)['val_loss'] is None


def test_non_finite_val_loss_stops(corpus, tmp_path, monkeypatch):
    trainer = port_trainer(corpus, tmp_path / 'nan', epochs=5)
    monkeypatch.setattr(trainer, 'evaluate', lambda mode, epoch=None: {'val_loss': float('nan')})
    trainer.fit()
    assert trainer.current_epoch == 0 and trainer.state.step == 2


def test_epoch_seeds_and_the_eval_transport(corpus, tmp_path):
    assert epoch_seed(0, 0) != epoch_seed(0, 1) != epoch_seed(1, 1)
    lossless = port_trainer(corpus, tmp_path / 'l', epochs=1)
    q16 = port_trainer(corpus, tmp_path / 'q', epochs=1, eval_transport='q16', shadow_eval_transport='q8')
    q16.model.load_state_dict(lossless.model.state_dict())
    a, b = lossless.evaluate('val', 0), q16.evaluate('val', 0)
    assert set(a) == set(b)
    for k in a:
        assert b[k] == pytest.approx(a[k], abs=1e-3), k
    row = _rows(tmp_path / 'q')[-1]
    assert row['val_loss_q8'] == pytest.approx(a['val_loss'], abs=5e-2) and 'val_shadow_eval_seconds' in row
    with pytest.raises(ValueError, match='eval_transport'):
        port_trainer(corpus, tmp_path / 'bad', eval_transport='q4')


def test_bf16_and_q8_fit_on_the_cpu(corpus, tmp_path):
    trainer = port_trainer(corpus, tmp_path / 'bf16', epochs=1, precision='bfloat16', input_transport='q8')
    out = trainer.fit()
    assert np.isfinite(out['val_loss'])
    assert all(p.dtype == torch.float32 for p in trainer.state.params.values())


def test_trainer_needs_a_card_unless_told_cpu(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    trainer_dm = port_trainer(corpus, tmp_path / 'a').datamodule
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(model=instantiate.build_model(MODEL_CFG), datamodule=trainer_dm, device='cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tune_batch_size(instantiate.build_model(MODEL_CFG), ['ECG'], epochs_per_night=2)


# ---------------------------------------------------------------- tuning


def _fake_step_factory(oom_at):
    def make_fake(model, opt, num_classes, **kwargs):
        def fake_step(state, batch, seed):
            b = next(iter(batch[0].values())).shape[0]
            if oom_at is not None and b >= oom_at:
                raise torch.cuda.OutOfMemoryError(f'CUDA out of memory at batch {b}')
            return state, {'loss': torch.zeros(())}

        return fake_step

    return make_fake


@pytest.mark.parametrize('oom_at, start, max_batch, want', [(16, 2, 512, 8), (None, 4, 8, 8), (2, 2, 8, 0)])
def test_tune_batch_size_with_a_fake_step(monkeypatch, oom_at, start, max_batch, want):
    monkeypatch.setattr(step_mod, 'make_train_step', _fake_step_factory(oom_at))
    model = instantiate.build_model(MODEL_CFG)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = tune_batch_size(model, columns=['ECG'], epochs_per_night=2, start=start, max_batch=max_batch,
                          device='cpu')
    assert got == want
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def test_tune_batch_size_propagates_other_errors(monkeypatch):
    def make_broken(model, opt, num_classes, **kwargs):
        def broken(state, batch, seed):
            raise RuntimeError('shapes are wrong')

        return broken

    monkeypatch.setattr(step_mod, 'make_train_step', make_broken)
    with pytest.raises(RuntimeError, match='shapes are wrong'):
        tune_batch_size(instantiate.build_model(MODEL_CFG), ['ECG'], epochs_per_night=2, start=2, max_batch=8,
                        device='cpu')


def test_tune_batch_size_real_probe_with_ema_and_accumulation():
    """One real step with the EMA and the accumulation buffers; the model's
    weights are left as they were."""
    model = instantiate.build_model(MODEL_CFG)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tune_batch_size(model, ['ECG', 'THX'], epochs_per_night=2, start=2, max_batch=2, ema=True,
                           grad_accum=True, device='cpu') == 2
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
