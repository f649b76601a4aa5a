"""The EMA-evaluated val_loss of the port's Trainer against the JAX
package's over a few hundred optimizer steps on the CPU, with the EMA at
0.999 from step 50 (the convergence drive's setting):

    env JAX_PLATFORMS=cpu python -m tests.torch_ema_trajectory [--epochs 80] [--seeds 1 2]

The corpus is ``tests/test_torch_trainer.py``'s (8 nights a split and a
dataset, 4 optimizer steps an epoch at batch 4) and the model the trainer
smoke test's. Masker, flip and dropout are off, so the two stacks run the
same arithmetic from the same weights. Arms:

- ``jax``: the JAX Trainer from its init (seed 0);
- ``port_same_init``: the port's Trainer from the same initial weights
  (``convert.from_jax_variables``) and on the same data order;
- for each of ``--seeds``: the JAX Trainer and the port's Trainer, each from
  its own seeded init (the same seed for its data order).

Prints the EMA-evaluated val_loss and the train loss every 5 epochs, the
largest EMA and parameter differences of the same-init pair, and the port's
EMA against the recurrence that the JAX package's step applies (the init
copy until step 50, then ``e <- 0.999 e + 0.001 p`` after each optimizer
step), recomputed in float64 from the port's parameters after every step.
Confusion-matrix figures are not drawn. Takes a few minutes a fit.
"""

import argparse
import json
import os
import pathlib
import shutil
import tempfile

import torch

import jax

from wav2sleep_tpu_torch import instantiate, log
from wav2sleep_tpu_torch.convert import from_jax_variables

from .test_torch_trainer import port_trainer, write_corpus
from .train.test_trainer_smoke import MODEL_CFG, make_trainer

DECAY, START = 0.999, 50


def _val_curve(log_dir) -> dict[int, tuple[float, float]]:
    """{epoch: (train_loss, EMA-evaluated val_loss)} from metrics.jsonl."""
    train, val = {}, {}
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        for line in f:
            row = json.loads(line)
            if 'train_loss' in row:
                train[row['step']] = row['train_loss']
            if 'val_loss' in row:
                val[row['step']] = row['val_loss']
    return {e: (train[e], val[e]) for e in sorted(val)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--epochs', type=int, default=80)
    ap.add_argument('--seeds', type=int, nargs='*', default=[1, 2])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    log.save_confusion_figure = lambda *a: None
    root = pathlib.Path(tempfile.mkdtemp(prefix='ema_trajectory_'))
    try:
        return _run(args, root)
    finally:
        shutil.rmtree(root)


def _run(args, root: pathlib.Path) -> dict:
    corpus = root / 'corpus'
    write_corpus(corpus, nights_per_split=8)
    kw = dict(epochs=args.epochs, ema_decay=DECAY, ema_start_step=START, early_stopping_patience=10 ** 6,
              lr=1e-3, warmup_steps=5, tau=1e9, flip_polarity=False)

    def jax_fit(name, seed):
        jt = make_trainer(corpus, root / name, masker=None, progress_bar=False, seed=seed, **kw)
        jt.metrics_logger.plot_confusion = False
        jt._ensure_state(next(iter(jt.datamodule.train_loader(0))))
        init = from_jax_variables({'params': jax.device_get(jt.state.params)})
        jt.fit()
        return jt, init

    curves = {}
    jt, init = jax_fit('jax', 0)
    curves['jax'] = _val_curve(root / 'jax')

    # The port from the same weights, with the recurrence kept beside it.
    model = instantiate.build_model(MODEL_CFG)
    model.load_state_dict(init, strict=True)
    pt = port_trainer(corpus, root / 'port_same_init', model=model, **kw)
    ema64 = {k: v.double().clone() for k, v in init.items() if k in dict(model.named_parameters())}
    step = pt._train_step

    def recorded_step(state, *a):
        before = state.step
        state, metrics = step(state, *a)
        if before >= START:
            for k, e in ema64.items():
                e.mul_(DECAY).add_(state.params[k].detach().double(), alpha=1 - DECAY)
        return state, metrics

    pt._train_step = recorded_step
    pt.fit()
    curves['port_same_init'] = _val_curve(root / 'port_same_init')
    jema = from_jax_variables({'params': jax.device_get(jt.state.ema_params)})
    jpar = from_jax_variables({'params': jax.device_get(jt.state.params)})
    out = {
        'steps': pt.state.step,
        'max_abs_ema_port_vs_jax': max(float((pt.state.ema_params[k] - v).abs().max()) for k, v in jema.items()),
        'max_abs_params_port_vs_jax': max(float((pt.state.params[k].detach() - v).abs().max())
                                          for k, v in jpar.items()),
        'max_abs_ema_moved_from_init': max(float((v - init[k]).abs().max()) for k, v in jema.items()),
        'max_abs_port_ema_vs_recurrence': max(float((pt.state.ema_params[k].double() - e).abs().max())
                                              for k, e in ema64.items()),
    }
    for seed in args.seeds:
        jax_fit(f'jax_seed{seed}', seed)
        curves[f'jax_seed{seed}'] = _val_curve(root / f'jax_seed{seed}')
        own = instantiate.build_model(MODEL_CFG, generator=torch.Generator().manual_seed(seed))
        port_trainer(corpus, root / f'port_seed{seed}', model=own, seed=seed, **kw).fit()
        curves[f'port_seed{seed}'] = _val_curve(root / f'port_seed{seed}')

    names = list(curves)
    print('epoch  optimizer steps  train_loss (' + ', '.join(names) + ')  EMA val_loss (same order)')
    for e in curves['jax']:
        if e % 5 == 0 or e == max(curves['jax']):
            print(e, 4 * (e + 1), *(f'{curves[n][e][0]:.4f}' for n in names), '|',
                  *(f'{curves[n][e][1]:.4f}' for n in names))
    out['final_ema_val_loss'] = {n: c[max(c)][1] for n, c in curves.items()}
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
