"""What the mu-law int8 (q8) and packed 4-bit (q4) serving transports cost in
quality, on trained weights.

    python -m wav2sleep_tpu_torch.q8_quality [--train-nights 10] [--eval-nights 8] [--hours 6]
        [--train-steps 120] [--feature-dim 128] [--train-transport lossless|q8]
        [--label-noise 0] [--overlap 0] [--device cuda|cpu]

The port's counterpart of ``scripts/q8_quality.py``, with its arguments and
output keys. It writes off-grid synthetic nights (``data.synth.write_nights``:
ECG 125 Hz, PPG 256 Hz, respiration 10 Hz, stage-modulated), trains the
full-width flagship briefly on them with the port's training step (Adam
3e-3, batches of 4 nights, no masker, flip or dropout, as the JAX script's
step), keeping the weights of the best held-out loss (checked every 5
steps), then serves the held-out nights through the lossless f32 decode
path and through the q8 and q4 transports, and compares:

- hypnogram agreement and Cohen's kappa between the two hypnograms,
- the logit perturbation |delta| (mean, p95) against the per-epoch decision
  margin,
- the decision margin of the flipped epochs (flips should sit at near-ties).

A last row repeats q8+bf16 against f32 with random weights (N(0, 0.05) in
every parameter) whose per-class mean logit is taken out: decision margins
far smaller than a trained model's, a deliberately pessimistic bound.

Prints one JSON line per configuration. Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

SIGNALS = ['ABD', 'THX', 'ECG', 'PPG']
NUM_CLASSES = 4


def zscore_host(x: np.ndarray) -> np.ndarray:
    """The pipelines' per-recording z-score (ddof 1, eps 1e-6) on the host."""
    mu = x.mean(axis=-1, keepdims=True)
    std = np.sqrt(np.square(x - mu).sum(axis=-1, keepdims=True) / (x.shape[-1] - 1))
    return (x - mu) / np.maximum(std, 1e-6)


def compare(ref: np.ndarray, test: np.ndarray) -> dict:
    from .stats import cohens_kappa

    ref_pred, pred = ref.argmax(-1), test.argmax(-1)
    agree = pred == ref_pred
    delta = np.abs(test - ref)
    top2 = np.sort(ref, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    cmat = np.histogram2d(ref_pred.ravel(), pred.ravel(), bins=(4, 4), range=((0, 4), (0, 4)))[0]
    return {
        'agreement': float(agree.mean()),
        'kappa_vs_f32': float(cohens_kappa(cmat, n_classes=4)),
        'delta_logit_mean': float(delta.mean()),
        'delta_logit_p95': float(np.quantile(delta, 0.95)),
        'margin_median': float(np.median(margin)),
        'flipped_margin_median': float(np.median(margin[~agree])) if (~agree).any() else 0.0,
    }


def _logits(out, ref: np.ndarray, what: str) -> np.ndarray:
    """A forward's logits on the host, checked finite and of the reference's
    shape: a row built on anything else would mean nothing."""
    test = out.float().cpu().numpy()
    if test.shape != ref.shape or not np.isfinite(test).all():
        raise ValueError(f'{what}: logits of shape {test.shape} (want {ref.shape}), finite {np.isfinite(test).all()}')
    return test


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--train-nights', type=int, default=10)
    parser.add_argument('--eval-nights', type=int, default=8)
    parser.add_argument('--hours', type=float, default=6.0)
    parser.add_argument('--train-steps', type=int, default=120)
    parser.add_argument('--feature-dim', type=int, default=128)
    parser.add_argument('--train-transport', default='lossless', choices=['lossless', 'q8'],
                        help='quantize the TRAINING inputs through the mu-law int8 training transport '
                             '(ops/q8_transport.py) before the training loop, to A/B the end-task cost of '
                             'input_transport=q8 (same seeds either way)')
    parser.add_argument('--label-noise', type=float, default=0.0,
                        help='corpus difficulty: fraction of epoch labels re-scored to a random other stage '
                             '(data/synth.py). Use with --overlap to measure transport deltas below the '
                             'accuracy ceiling')
    parser.add_argument('--overlap', type=float, default=0.0,
                        help='corpus difficulty: 0..1 blend of per-stage physiology toward the mean '
                             '(data/synth.py)')
    parser.add_argument('--device', default=None, help='cuda (the default) or cpu')
    return parser


def _model(feature_dim: int, device):
    """The flagship cardio model (seed 0) with its mixers' dropout at 0:
    the JAX script trains and evaluates its model deterministically."""
    import torch

    from .models.wav2sleep import build_wav2sleep, flagship_config

    cfg = flagship_config(feature_dim)
    cfg['epoch_mixer']['dropout'] = cfg['sequence_mixer']['dropout'] = 0.0
    return build_wav2sleep(**cfg, generator=torch.Generator().manual_seed(0)).to(device)


def setup_and_train(args) -> SimpleNamespace:
    """Write disjoint train and eval corpora, train the flagship with
    held-out model selection, and compute the lossless f32 reference logits.
    Returns what a transport row needs: the selected f32 model and its bf16
    copy, the eval corpus and labels, the q8 extraction, the reference
    logits and the rows' common keys."""
    import torch

    from .data.synth import write_nights
    from .ops.q8_transport import dequant_batch, encode_batch
    from .pipeline import NightDecoder, Q8_META_DTYPE, Q8NightExtractor, grid_length, make_streaming_forward
    from .train.step import init_train_state, make_eval_step, make_optimizer, make_train_step
    from .utils import resolve_device

    device = resolve_device(args.device)
    model = _model(args.feature_dim, device)

    tmp = tempfile.mkdtemp(prefix='w2s_q8q_')
    print('# synthesizing corpus...', file=sys.stderr)
    # Disjoint subfolders: write_nights names files night{i:03d}.edf, so one
    # folder would overwrite train nights with eval waveforms.
    train_dir, eval_dir = os.path.join(tmp, 'train'), os.path.join(tmp, 'eval')
    os.makedirs(train_dir)
    os.makedirs(eval_dir)
    knobs = dict(overlap=args.overlap, label_noise=args.label_noise)
    train_fps, train_y = write_nights(train_dir, args.train_nights, args.hours, seed=0, **knobs)
    eval_fps, eval_y = write_nights(eval_dir, args.eval_nights, args.hours, seed=1, **knobs)
    print('# corpus written; decoding...', file=sys.stderr)
    n_grid = {c: grid_length(c, args.hours) for c in SIGNALS}

    decoder = NightDecoder(SIGNALS, args.hours)

    def decode_all(fps):
        buf = {c: np.empty((len(fps), n_grid[c]), np.float32) for c in SIGNALS}
        for i, fp in enumerate(fps):
            decoder.decode_into(fp, {c: buf[c][i] for c in SIGNALS})
        return buf

    train_f32, eval_f32 = decode_all(train_fps), decode_all(eval_fps)
    train_z = {c: zscore_host(v) for c, v in train_f32.items()}
    if args.train_transport == 'q8':
        # The model sees only quantized inputs, as under the trainer's
        # input_transport='q8'.
        enc = {k: tuple(torch.from_numpy(a) for a in v) for k, v in encode_batch(train_z).items()}
        train_z = {c: v.numpy() for c, v in dequant_batch(enc).items()}

    extractor = Q8NightExtractor(SIGNALS, args.hours)
    B_eval = len(eval_fps)
    q8_buf = {c: np.zeros((B_eval, n_grid[c]), np.int8) for c in SIGNALS}
    meta = {c: np.zeros(B_eval, dtype=Q8_META_DTYPE) for c in SIGNALS}
    for i, fp in enumerate(eval_fps):
        extractor.extract_into(fp, q8_buf, meta, i)

    def q8_args():
        # Operand order: Q8_META_DTYPE's fields.
        return (
            {c: torch.from_numpy(q8_buf[c]).to(device) for c in SIGNALS},
            *({c: torch.from_numpy(np.ascontiguousarray(meta[c][name])).to(device) for c in SIGNALS}
              for name in Q8_META_DTYPE.names),
        )

    # --- train briefly so the logits have a trained model's structure ---
    opt = make_optimizer(3e-3, weight_decay=0.0, grad_clip=None)  # optax.adam(3e-3)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, NUM_CLASSES, masker=None, flip_polarity=False)
    eval_step = make_eval_step(model, NUM_CLASSES)
    eval_batch = ({c: torch.from_numpy(zscore_host(eval_f32[c])).to(device) for c in SIGNALS},
                  torch.from_numpy(eval_y.astype(np.float32)).to(device))

    # Held-out model selection: keep the best-generalizing weights. Trained
    # to convergence on a few synthetic nights a model memorizes them and
    # becomes overconfident and input-sensitive; a real model sits at a
    # held-out loss near 0.8, the regime selection keeps.
    rng = np.random.default_rng(0)
    n_train = len(train_fps)
    best = {'loss': float('inf'), 'params': None, 'step': -1}
    t0 = time.time()
    for i in range(args.train_steps):
        idx = rng.choice(n_train, size=min(4, n_train), replace=False)
        x = {c: torch.from_numpy(np.ascontiguousarray(train_z[c][idx])).to(device) for c in SIGNALS}
        y = torch.from_numpy(train_y[idx].astype(np.float32)).to(device)
        state, metrics = step(state, (x, y), 0)
        if i % 5 == 0 or i == args.train_steps - 1:
            el = float(eval_step(state.params, eval_batch)['loss'])
            if el < best['loss']:
                best = {'loss': el, 'params': {k: p.detach().clone() for k, p in state.params.items()}, 'step': i}
            print(f'# step {i} train_loss={float(metrics["loss"]):.4f} eval_loss={el:.4f} '
                  f'({time.time() - t0:.0f}s)', file=sys.stderr)
    if best['params'] is None:
        raise SystemExit(f'--train-steps {args.train_steps} trained no model '
                         '(need >= 1 step to select evaluation weights).')
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(best['params'][k])
    model.eval()
    del state, best['params']

    fwd_f32 = make_streaming_forward(model, precision='float32', output='logits')
    train_logits = fwd_f32({c: torch.from_numpy(train_f32[c]).to(device) for c in SIGNALS}).cpu().numpy()
    train_acc = float((train_logits.argmax(-1) == train_y).mean())

    epochs = int(args.eval_nights * args.hours * 120)
    ref = fwd_f32({c: torch.from_numpy(eval_f32[c]).to(device) for c in SIGNALS}).cpu().numpy()
    f32_acc = float((ref.argmax(-1) == eval_y).mean())
    base = {
        'nights': args.eval_nights,
        'epochs': epochs,
        'label_noise': args.label_noise,
        'overlap': args.overlap,
        'train_transport': args.train_transport,
        'train_steps': args.train_steps,
        'selected_step': best['step'],
        'eval_loss': round(best['loss'], 4),
        'train_acc': round(train_acc, 4),
        'f32_eval_acc': round(f32_acc, 4),
    }
    # bf16 rows evaluate bf16 WEIGHTS, not only bf16 activations: f32
    # parameters would promote every matmul back to f32 and leave out the
    # bf16 matmul noise the row exists to bound (api.load_model's
    # precision='bfloat16' casts the same way).
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    return SimpleNamespace(
        device=device, model=model, model_bf16=model_bf16, n_grid=n_grid, tmp=tmp,
        eval_fps=eval_fps, eval_y=eval_y, eval_f32=eval_f32, epochs=epochs, q8_args=q8_args,
        ref=ref, f32_acc=f32_acc, base=base,
    )


def rows(args) -> list[dict]:
    """The script's JSON rows: q8+f32, q8+bf16, q4+f32 and q4+bf16 against
    the f32 lossless path on the trained weights, then the random-init
    bound. The synthetic corpus is removed after."""
    ns = setup_and_train(args)
    try:
        return _rows(args, ns)
    finally:
        shutil.rmtree(ns.tmp, ignore_errors=True)


def _rows(args, ns: SimpleNamespace) -> list[dict]:
    import torch

    from .pipeline import (
        Q8_META_DTYPE,
        Q4NightExtractor,
        make_streaming_forward,
        make_streaming_forward_q4,
        make_streaming_forward_q8,
        q4_row_len,
    )

    device, n_grid, eval_y, ref, f32_acc, base = ns.device, ns.n_grid, ns.eval_y, ns.ref, ns.f32_acc, ns.base
    out = []
    for name, model in (('float32', ns.model), ('bfloat16', ns.model_bf16)):
        test = _logits(make_streaming_forward_q8(model, precision=name, output='logits')(*ns.q8_args()), ref,
                       f'q8+{name}')
        q8_acc = float((test.argmax(-1) == eval_y).mean())
        out.append({
            'config': f'trained model: q8+{name} vs f32 lossless',
            **base,
            'q8_eval_acc': round(q8_acc, 4),
            'acc_delta': round(q8_acc - f32_acc, 5),
            **{k: round(v, 5) for k, v in compare(ref, test).items()},
        })

    # --- the q4 rung: the same trained weights over the packed 4-bit transport ---
    B_eval = len(ns.eval_fps)
    q4_ext = Q4NightExtractor(SIGNALS, n_grid, args.hours)
    q4_buf = {c: np.zeros((B_eval, q4_row_len(n_grid[c])), np.uint8) for c in SIGNALS}
    meta4 = {c: np.zeros(B_eval, dtype=Q8_META_DTYPE) for c in SIGNALS}
    for i, fp in enumerate(ns.eval_fps):
        q4_ext.extract_into(fp, q4_buf, meta4, i)
    q4_args = (
        {c: torch.from_numpy(q4_buf[c]).to(device) for c in SIGNALS},
        *({c: torch.from_numpy(np.ascontiguousarray(meta4[c][name])).to(device) for c in SIGNALS}
          for name in Q8_META_DTYPE.names),
    )
    for name, model in (('float32', ns.model), ('bfloat16', ns.model_bf16)):
        test = _logits(make_streaming_forward_q4(model, n_grid, precision=name, output='logits')(*q4_args), ref,
                       f'q4+{name}')
        q4_acc = float((test.argmax(-1) == eval_y).mean())
        out.append({
            'config': f'trained model: q4+{name} vs f32 lossless',
            **base,
            'q4_eval_acc': round(q4_acc, 4),
            'acc_delta': round(q4_acc - f32_acc, 5),
            **{k: round(v, 5) for k, v in compare(ref, test).items()},
        })

    # --- pessimistic bound: random init, per-class bias centred out ---
    rng = np.random.default_rng(0)
    rand = _model(args.feature_dim, device).eval()
    with torch.no_grad():
        for p in rand.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape), scale=0.05).astype(np.float32)))
    ref_r = make_streaming_forward(rand, precision='float32', output='logits')(
        {c: torch.from_numpy(ns.eval_f32[c]).to(device) for c in SIGNALS}).cpu().numpy()
    rand_bf16 = rand.to(torch.bfloat16)
    test_r = _logits(make_streaming_forward_q8(rand_bf16, precision='bfloat16', output='logits')(*ns.q8_args()), ref_r,
                     'random-init q8+bfloat16')
    bias = ref_r.mean(axis=(0, 1), keepdims=True)
    out.append({
        'config': 'random-init bias-centered (pessimistic): q8+bfloat16 vs f32 lossless',
        'nights': args.eval_nights,
        'epochs': ns.epochs,
        **{k: round(v, 5) for k, v in compare(ref_r - bias, test_r - bias).items()},
    })
    return out


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    out = rows(args)
    for row in out:
        print(json.dumps(row), flush=True)
    return out


if __name__ == '__main__':
    main()
