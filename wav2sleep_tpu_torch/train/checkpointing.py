"""Training checkpoints (best + last), with resume hardening.

The port's counterpart of ``wav2sleep_tpu/train/checkpointing.py``, with its
layout and rules: ``<root>/last`` and ``<root>/best`` (directories), each
with a ``<name>.meta.json`` sidecar holding ``epoch``, ``val_loss``,
``grad_clip``, ``early_stopping`` and ``plateau``; the write goes to
``<name>.tmp`` first and is renamed into place; a bare name resolves under
the root and anything with a separator is a path.

A checkpoint holds the whole ``TrainState`` (the parameters, AdamW's moments
and count, the accumulation buffers and micro-step, the LR scale, the
in-graph EMA, batch norm's running statistics, the step), the run's seed
(the counterpart of the JAX package's PRNG key) and the offloaded EMA, as
one ``torch.save`` file of CPU tensors, ints and floats (``state.pt``) that
``torch.load(weights_only=True)`` reads. Restoring copies the tensors into
the trainer's own on its device. The JAX package's orbax checkpoints are
not read (orbax needs JAX).

Over a data-parallel group rank 0 writes and a barrier follows, so no rank
restores a half-written checkpoint; every rank restores the same files, and
``parallel.mesh.replicate`` checks that they hold the same state (the JAX
package's rank-zero writes between barriers).
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import numpy as np
import torch

from ..parallel import mesh as pmesh
from .step import TrainState

logger = logging.getLogger(__name__)

STATE_FILE = 'state.pt'


def _cpu(tensors):
    """CPU copies of a dict or list of tensors (None stays None)."""
    if tensors is None:
        return None
    if isinstance(tensors, dict):
        return {k: v.detach().to('cpu', copy=True) for k, v in tensors.items()}
    return [t.detach().to('cpu', copy=True) for t in tensors]


def state_tree(state: TrainState) -> dict:
    """The training state as CPU tensors, ints and floats."""
    opt = state.opt_state
    return {
        'step': state.step,
        'params': _cpu(state.params),
        'opt_state': {
            'mu': _cpu(opt.mu),
            'nu': _cpu(opt.nu),
            'count': opt.count,
            'lr_scale': opt.lr_scale,
            'mini_step': opt.mini_step,
            'acc_grads': _cpu(opt.acc_grads),
        },
        'ema_params': _cpu(state.ema_params),
        'batch_stats': _cpu(state.batch_stats),
    }


@torch.no_grad()
def _copy_into(dst: list[torch.Tensor], src: list[torch.Tensor], what: str) -> None:
    if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
        raise ValueError(f'checkpoint {what} do not fit this model: '
                         f'{[tuple(s.shape) for s in src][:3]}... against {[tuple(d.shape) for d in dst][:3]}...')
    for d, s in zip(dst, src):
        d.copy_(s)


def _copy_named(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f'checkpoint {what} do not match this model: missing '
                         f'{sorted(set(dst) - set(src))[:3]}, unexpected {sorted(set(src) - set(dst))[:3]}')
    _copy_into([dst[k] for k in dst], [src[k] for k in dst], what)


def load_state_tree(state: TrainState, tree: dict) -> None:
    """Copy a saved state into ``state``'s own tensors, in place (they stay
    the model's parameters and buffers, on their device)."""
    _copy_named(state.params, tree['params'], 'parameters')
    opt, saved = state.opt_state, tree['opt_state']
    _copy_into(opt.mu, saved['mu'], 'first moments')
    _copy_into(opt.nu, saved['nu'], 'second moments')
    if (opt.acc_grads is None) != (saved['acc_grads'] is None):
        raise ValueError('checkpoint was saved with another gradient-accumulation setting '
                         f'(accumulation buffers {"present" if saved["acc_grads"] is not None else "absent"})')
    if opt.acc_grads is not None:
        _copy_into(opt.acc_grads, saved['acc_grads'], 'accumulation buffers')
    opt.count, opt.lr_scale, opt.mini_step = int(saved['count']), float(saved['lr_scale']), int(saved['mini_step'])
    if state.batch_stats is not None:
        _copy_named(state.batch_stats, tree['batch_stats'] or {}, 'running statistics')
    if state.ema_params is not None:
        _copy_named(state.ema_params, tree['ema_params'], 'EMA weights')
    state.step = int(tree['step'])


class CheckpointManager:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.root, f'{name}.meta.json')

    def save(self, trainer, epoch: int, val_loss: float, is_best: bool) -> None:
        tree = {'state': state_tree(trainer.state), 'seed': trainer.seed}
        if trainer.host_ema is not None:
            tree['host_ema'] = {k: torch.from_numpy(v) for k, v in trainer.host_ema.items()}
        meta = {
            'epoch': epoch,
            'val_loss': float(val_loss) if np.isfinite(val_loss) else None,
            'grad_clip': trainer.grad_clip,
            'early_stopping': trainer.early_stopping.state_dict(),
            'plateau': trainer.plateau.state_dict() if trainer.plateau else None,
        }
        if getattr(trainer, 'primary', True):
            self._write('last', tree, meta)
            if is_best:
                self._write('best', tree, meta)
        if getattr(trainer, 'mesh', None) is not None:
            pmesh.barrier()

    def _write(self, name: str, tree: dict, meta: dict) -> None:
        """Write to ``<name>.tmp``, then swap it into place and write the sidecar."""
        path = os.path.join(self.root, name)
        tmp = path + '.tmp'
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        with open(self._meta_path(name), 'w') as f:
            json.dump(meta, f)

    def resolve(self, which: str) -> str:
        """A bare name (``last``, ``best``) under the root; anything with a
        separator, or absolute, as the path it names."""
        if os.path.isabs(which) or os.sep in which:
            return os.path.abspath(which)
        return os.path.join(self.root, which)

    def restore(self, trainer, which: str = 'last') -> int:
        """Restore into ``trainer``; returns the epoch to resume from."""
        path = self.resolve(which)
        if not os.path.exists(path):
            raise FileNotFoundError(f'No checkpoint at {path}')
        trainer.ensure_state()
        tree = torch.load(os.path.join(path, STATE_FILE), map_location='cpu', weights_only=True)
        saved = tree['state']
        state = trainer.state
        if state.ema_params is None and saved['ema_params'] is not None:
            logger.warning('Checkpoint carries an in-graph EMA but EMA is disabled for this run; '
                           'the EMA weights were ignored.')
        elif state.ema_params is not None and saved['ema_params'] is None:
            logger.warning('Checkpoint has no in-graph EMA entry (saved without EMA); '
                           'initialized the EMA from the restored parameters.')
            saved = {**saved, 'ema_params': saved['params']}
        load_state_tree(state, saved)
        trainer.seed = int(tree['seed'])
        if trainer.host_ema is not None:
            host = tree.get('host_ema')
            if host is None:
                logger.warning('Checkpoint has no host_ema entry (saved without ema_offload); initialized '
                               'the offloaded EMA from the restored parameters.')
                host = saved['params']
            trainer.host_ema = {k: host[k].numpy().copy() for k in trainer.host_ema}
        elif 'host_ema' in tree:
            logger.warning('Checkpoint carries an offloaded EMA but ema_offload is disabled; '
                           'the EMA weights were ignored.')
        if getattr(trainer, 'mesh', None) is not None:
            pmesh.replicate(trainer.mesh, state_tree(state))
        return self._resume_epoch(trainer, path + '.meta.json')

    def _resume_epoch(self, trainer, meta_path: str) -> int:
        """Apply the sidecar (epoch, early-stop and plateau state); returns
        the epoch to resume from."""
        epoch = 0
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            epoch = int(meta.get('epoch', -1)) + 1
            if meta.get('grad_clip') != trainer.grad_clip:
                logger.warning(
                    '=' * 70
                    + f'\nGRADIENT CLIPPING MISMATCH DETECTED!\n'
                    f'  Checkpoint trained with: gradient_clip={meta.get("grad_clip")}\n'
                    f'  Current config has:      gradient_clip={trainer.grad_clip}\n'
                    'This can cause training instability (increasing training loss)!\n' + '=' * 70
                )
            if meta.get('early_stopping'):
                trainer.early_stopping.load_state_dict(meta['early_stopping'])
            if meta.get('plateau') and trainer.plateau is not None:
                trainer.plateau.load_state_dict(meta['plateau'])
        path = meta_path[: -len('.meta.json')]
        logger.info(f'Restored checkpoint from {path}; resuming at epoch {epoch}.')
        return epoch
