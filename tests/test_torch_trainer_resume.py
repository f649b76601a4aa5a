"""The port's trainer on the CPU: resume (1 + 1 epochs equal 2, the
restored state bit for bit), early stopping and the checkpoint sidecar,
the EMA both ways on restore, and the plateau cut (``train.loop``,
``train.checkpointing``). Split from ``tests/test_torch_trainer.py``, whose
corpus and trainer builder these use, so that the test run spreads the
fits over its workers."""

import json
import logging

import numpy as np
import pytest
import torch

from wav2sleep_tpu_torch import instantiate
from wav2sleep_tpu_torch.train.checkpointing import CheckpointManager

from .test_torch_threads import one_torch_thread  # noqa: F401 - autouse
from .test_torch_trainer import _params, _rows, corpus, port_trainer  # noqa: F401 - corpus is a fixture
from .train.test_trainer_smoke import MODEL_CFG


def test_resume_continues_as_one_run(corpus, tmp_path):
    """1 + 1 epochs equals 2 epochs (accumulation 2 over 3 micro-steps an
    epoch, so the accumulation buffers cross the checkpoint; EMA on; masker
    and flip on, seeded), and the restored state equals the saved one bit
    for bit."""
    from wav2sleep_tpu_torch.train.masker import SignalMasker

    kw = dict(accumulate_grad_batches=2, ema_decay=0.9, ema_start_step=0, flip_polarity=True,
              masker=SignalMasker({'ECG': 0.3, 'THX': 0.3}, backups=['ECG']), dm_kw=dict(batch_size=3))
    whole = port_trainer(corpus, tmp_path / 'whole', epochs=2, **kw)
    whole.fit()
    first = port_trainer(corpus, tmp_path / 'parts', epochs=1, **kw)
    first.fit()
    assert first.state.opt_state.mini_step == 1  # mid-accumulation at the checkpoint
    saved = (_params(first), [m.clone() for m in first.state.opt_state.mu],
             {k: v.clone() for k, v in first.state.ema_params.items()}, first.state.step)
    second = port_trainer(corpus, tmp_path / 'parts', epochs=2, model=instantiate.build_model(
        MODEL_CFG, generator=torch.Generator().manual_seed(5)), **kw)
    assert second.restore('last') == 1
    assert all(torch.equal(a, b) for a, b in zip(saved[0].values(), _params(second).values()))
    assert all(torch.equal(a, b) for a, b in zip(saved[1], second.state.opt_state.mu))
    assert all(torch.equal(a, b) for a, b in zip(saved[2].values(), second.state.ema_params.values()))
    assert second.state.step == saved[3] and second.state.opt_state.mini_step == 1
    second.fit(resume_from='last')
    for k, v in _params(whole).items():
        torch.testing.assert_close(second.state.params[k], v, rtol=0, atol=1e-6)
        torch.testing.assert_close(second.state.ema_params[k], whole.state.ema_params[k], rtol=0, atol=1e-6)
    rows = [r for r in _rows(tmp_path / 'parts') if 'train_loss' in r]
    assert [r['step'] for r in rows] == [0, 1]  # one metrics.jsonl, appended
    assert rows[-1]['train_loss'] == pytest.approx([r for r in _rows(tmp_path / 'whole') if 'train_loss' in r][-1]
                                                   ['train_loss'], rel=1e-6)


def test_early_stopping_and_the_post_update_sidecar(corpus, tmp_path):
    trainer = port_trainer(corpus, tmp_path / 'es', epochs=50, early_stopping_patience=1, lr=0.0)
    out = trainer.fit()
    assert trainer.current_epoch == 1  # lr 0: epoch 1 does not improve, patience 1
    with open(tmp_path / 'es' / 'checkpoints' / 'last.meta.json') as f:
        last = json.load(f)
    with open(tmp_path / 'es' / 'checkpoints' / 'best.meta.json') as f:
        best = json.load(f)
    # lr 0 repeats epoch 0's val_loss: a tie is judged best, as in JAX.
    assert last['epoch'] == best['epoch'] == 1 and last['val_loss'] == best['val_loss']
    assert last['early_stopping'] == trainer.early_stopping.state_dict() == {'best': best['val_loss'], 'wait': 1}
    assert set(last) == {'epoch', 'val_loss', 'grad_clip', 'early_stopping', 'plateau'}
    assert out['val_loss'] == pytest.approx(last['val_loss'])


def test_restore_reconciles_the_ema_both_ways(corpus, tmp_path, caplog):
    with_ema = port_trainer(corpus, tmp_path / 'ema', epochs=1, ema_decay=0.9, ema_start_step=0)
    with_ema.fit()
    plain = port_trainer(corpus, tmp_path / 'plain', epochs=1)
    plain.fit()
    manager = CheckpointManager(str(tmp_path / 'ema' / 'checkpoints'))
    caplog.set_level(logging.WARNING)
    no_ema = port_trainer(corpus, tmp_path / 'x1', epochs=1)
    manager.restore(no_ema, 'last')
    assert no_ema.state.ema_params is None and 'EMA is disabled' in caplog.text
    offload = port_trainer(corpus, tmp_path / 'x2', epochs=1, ema_decay=0.9, ema_offload=True)
    manager.restore(offload, 'last')
    assert 'no host_ema entry' in caplog.text
    for k, v in offload.host_ema.items():
        np.testing.assert_array_equal(v, with_ema.state.params[k].detach().numpy())
    caplog.clear()
    wants_ema = port_trainer(corpus, tmp_path / 'x3', epochs=1, ema_decay=0.9)
    wants_ema.restore(str(tmp_path / 'plain' / 'checkpoints' / 'last'))
    assert 'no in-graph EMA entry' in caplog.text
    for k, v in wants_ema.state.ema_params.items():
        torch.testing.assert_close(v, plain.state.params[k], rtol=0, atol=0)
    offload.fit()  # saves a host_ema
    caplog.clear()
    port_trainer(corpus, tmp_path / 'x4', epochs=1).restore(str(tmp_path / 'x2' / 'checkpoints' / 'last'))
    assert 'ema_offload is disabled' in caplog.text
    with pytest.raises(FileNotFoundError, match='No checkpoint'):
        plain.restore('nowhere/last')


def test_plateau_cuts_the_lr(corpus, tmp_path):
    trainer = port_trainer(corpus, tmp_path / 'plateau', epochs=4, scheduler='plateau', lr=1e-12)
    trainer.fit()
    lrs = [r['lr'] for r in _rows(tmp_path / 'plateau') if 'lr' in r]
    assert lrs == pytest.approx([1e-12, 1e-12, 1e-12, 1e-13], rel=1e-9)
    assert trainer.state.opt_state.lr_scale == pytest.approx(0.1)
    assert trainer.current_lr() == pytest.approx(1e-13)
