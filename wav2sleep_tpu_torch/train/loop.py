"""Training orchestration on one card: epochs, the eval matrix, checkpoints,
early stopping, export.

The port's counterpart of ``wav2sleep_tpu/train/loop.py``:

- the port's training step (``train.step``) over batches that a threaded
  host loader reads from parquet (``train.datamodule``), staged through a
  ring of pinned host slots: the bf16 cast or the q8 encode is written into
  a slot, the slot is copied to the card without blocking, and a CUDA event
  recorded after the copy must have completed before the slot is written
  again (``StagingRing``); the step's loss and confusion matrix stay on the
  card and are read every ``metric_fetch_every`` steps;
- the per-(dataset, signal-subset) evaluation matrix: each batch is copied
  to the card once and evaluated under the full modality set and every
  subset through presence masks, read every ``eval_fetch_every`` batches,
  over the lossless rows or the q16/q8 eval transport;
- the weight EMA, in the step or offloaded to host memory (folded in order
  at each read, on applied optimizer steps only);
- val_loss early stopping, the plateau LR controller, best/last checkpoints
  and resume (``train.checkpointing``), and export of the deployable folder
  that ``api.load_model`` reads.

Randomness: the step draws its flip, masker and dropout seeds from the
run's ``seed`` and the epoch (``epoch_seed``) and the step count; the seed is
saved in the checkpoint, as the JAX package saves its PRNG key.

Over a data-parallel group (``mesh``, ``parallel.mesh``; one rank per
device, each with its own ``StagingRing`` on its device) the step runs over
the group (``train.step``); a batch short of its size is padded to the data
axis as the JAX trainer pads it, the per-process share included; the eval
matrix's sums (loss times count, counts, confusion matrices) and the
predictions are summed or gathered across the ranks, so every rank gets the
same numbers and takes the same early-stopping and plateau decisions; only
rank 0 writes ``metrics.jsonl``, the confusion figures, the checkpoints and
the export.

The epoch's parts run in program spans (``tracing``: ``trainer/load``,
``trainer/stage`` and its claim, write and ship, ``trainer/step``,
``trainer/drain``), recorded while the recorder is on or torch's profiler
records on the epoch's thread.

One deliberate difference from the JAX package: a run resumed at or past
its last epoch returns the last epoch's val metrics from ``metrics.jsonl``
(the JAX ``fit`` returns ``{}`` there).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..log import log_aux_metrics, mlflow_module
from ..ops.q8_transport import encode_batch, encode_batch_q16
from ..parallel import mesh as pmesh
from ..settings import CCSHS, CFS, CHAT, ECG, MESA, PPG, SHHS, THX, TRAIN, VAL
from ..utils import resolve_device
from .datamodule import SleepDataModule
from .masker import SignalMasker, validate_batch
from .scheduler import PlateauController, exp_warmup_schedule
from .step import TrainState, init_train_state, make_eval_step, make_optimizer, make_train_step

logger = logging.getLogger(__name__)

TRANSPORT_CODES = {'q8': (encode_batch, torch.int8), 'q16': (encode_batch_q16, torch.int16)}


def epoch_seed(seed: int, epoch: int) -> int:
    """The training step's seed in ``epoch`` of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


@dataclass
class EarlyStopping:
    """val_loss early stopping (the reference's ResettableEarlyStopping)."""

    patience: int = 5
    min_delta: float = 0.0
    best: float = float('inf')
    wait: int = 0

    def update(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if metric < self.best - self.min_delta:
            self.best = metric
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.patience

    def reset(self) -> None:
        self.best = float('inf')
        self.wait = 0

    def state_dict(self) -> dict:
        return {'best': self.best, 'wait': self.wait}

    def load_state_dict(self, s: dict) -> None:
        self.best, self.wait = s['best'], s['wait']


class MetricsLogger:
    """JSON-lines metric log (``<log_dir>/metrics.jsonl``), confusion-matrix
    PNGs (best effort), and MLflow when ``MLFLOW_TRACKING_URI`` is set and
    ``mlflow`` imports; with ``enabled`` False (a rank other than 0) it
    writes nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        os.makedirs(log_dir, exist_ok=True)
        self.fp = os.path.join(log_dir, 'metrics.jsonl')
        self._mlflow = mlflow_module() if enabled else None
        if self._mlflow is not None:
            try:
                self._mlflow.enable_system_metrics_logging()
            except Exception as e:  # noqa: BLE001 - optional observability
                logger.debug(f'mlflow system metrics unavailable: {e}')

    def log(self, metrics: dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        with open(self.fp, 'a') as f:
            f.write(json.dumps({'step': step, 'time': time.time(), **metrics}) + '\n')
        if self._mlflow is not None:
            self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_confusion(self, cmat: np.ndarray, epoch: int, prefix: str) -> dict[str, float]:
        """Accuracy and kappa of one confusion matrix, logged (with its
        figure, ``<prefix>_conf_mats/<epoch:04d>.png``) and returned."""
        if not self.enabled:
            return {}
        return log_aux_metrics(cmat, epoch, prefix, artifact_dir=self.log_dir)

    def last_val_metrics(self) -> dict[str, float]:
        """The val metrics of the last evaluation in the log (its timings
        and shadow-transport losses left out), or {} when there is none."""
        last: dict = {}
        if os.path.exists(self.fp):
            with open(self.fp) as f:
                for line in f:
                    row = json.loads(line)
                    if f'{VAL}_loss' in row:
                        last = row
        timing = ('step', 'time', f'{VAL}_shadow_eval_seconds', *(f'{VAL}_loss_{t}' for t in TRANSPORT_CODES))
        return {k: float(v) for k, v in last.items()
                if k not in timing and not k.startswith(f'{VAL}_eval_seconds_')}


class StagingRing:
    """``depth`` host slots for host-to-device copies. A slot holds one
    buffer per (name, dtype, shape), made once (pinned when the device is a
    card) and reused; ``claim`` hands out the next slot after the event
    recorded behind its last copy has completed, so the host never writes a
    buffer that a copy still reads."""

    def __init__(self, depth: int, device: torch.device):
        self.device = device
        self._pin = device.type == 'cuda'
        self._slots: list[dict] = [{} for _ in range(max(2, depth))]
        self._copied: list[torch.cuda.Event | None] = [None] * len(self._slots)
        self._next = 0

    def claim(self) -> int:
        j = self._next
        self._next = (j + 1) % len(self._slots)
        if self._copied[j] is not None:
            self._copied[j].synchronize()
            self._copied[j] = None
        return j

    def buffer(self, j: int, name, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
        key = (name, dtype, tuple(shape))
        buf = self._slots[j].get(key)
        if buf is None:
            buf = self._slots[j][key] = torch.empty(shape, dtype=dtype, pin_memory=self._pin)
        return buf

    def ship(self, j: int, tensors):
        """Copy slot ``j``'s ``tensors`` (a dict of tensors or of tuples of
        tensors) to the device without blocking; the slot is free again once
        the copies are done."""
        out = {k: tuple(t.to(self.device, non_blocking=True) for t in v) if isinstance(v, tuple)
               else v.to(self.device, non_blocking=True) for k, v in tensors.items()}
        if self._pin:
            self._copied[j] = torch.cuda.Event()
            self._copied[j].record()
        return out

    def release(self) -> None:
        """Wait for every copy in flight."""
        for j, ev in enumerate(self._copied):
            if ev is not None:
                ev.synchronize()
                self._copied[j] = None


@dataclass
class Trainer:
    model: nn.Module
    datamodule: SleepDataModule
    num_classes: int = 4
    family: str = 'wav2sleep'
    # Optimizer and schedule (the reference's defaults: AdamW lr 1e-3, weight
    # decay 1e-4, warm-up 2000, tau 10000, clip 1.0, 50 epochs).
    lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 2000
    tau: float = 10_000.0
    scheduler: str = 'expdecay'  # 'expdecay' | 'plateau' | 'none'
    grad_clip: float = 1.0
    accumulate_grad_batches: int = 1
    epochs: int = 50
    label_smoothing: float = 0.0
    # Augmentation
    masker: Optional[SignalMasker] = None
    flip_polarity: bool = True
    # Weight EMA (off by default, as in the reference)
    ema_decay: Optional[float] = None
    ema_start_step: int = 2000
    # Keep the EMA in host memory (the reference EMACallback's
    # offload_to_cpu): a parameter-sized copy to pinned host memory per
    # applied step, folded at the metric reads, for one parameter-sized
    # buffer less on the card.
    ema_offload: bool = False
    # Early stopping
    early_stopping_patience: int = 5
    reset_early_stopping: bool = False
    precision: str = 'float32'  # 'float32' | 'bfloat16' (f32 master parameters)
    # Training input transport: None ships the rows at the compute
    # precision; 'q8' ships mu-law int8 codes and per-row peaks, decoded in
    # the step (ops/q8_transport.py).
    input_transport: Optional[str] = None
    seed: int = 42
    log_dir: str = 'runs/default'
    progress_bar: bool = True  # tqdm, when it imports
    # Pipeline depth: the metrics of the steps are read every K steps, so up
    # to ``stage_ring`` copies run under the card's compute.
    metric_fetch_every: int = 16
    stage_ring: int = 4
    eval_fetch_every: int = 16
    # Eval input transport: None ships the loader's f32 rows (lossless);
    # 'q16' linear int16 codes (~1e-4 absolute error on z-scored rows);
    # 'q8' the mu-law train rung. predict and export are always lossless.
    eval_transport: Optional[str] = None
    # When set, every val epoch also runs the val loaders (no subsets) under
    # this transport and logs ``val_loss_<transport>``; selection keeps the
    # primary val_loss.
    shadow_eval_transport: Optional[str] = None
    # The card when None and the data module's device is; raises without one.
    device: torch.device | str | None = None
    # The data-parallel group (``parallel.mesh.make_mesh``), or None: this
    # rank's device is the mesh's.
    mesh: Optional[pmesh.Mesh] = None

    state: TrainState = field(default=None, repr=False)
    current_epoch: int = 0

    def __post_init__(self):
        if self.input_transport not in (None, 'q8'):
            raise ValueError(f'unknown input_transport {self.input_transport!r} (None or "q8")')
        for name in ('eval_transport', 'shadow_eval_transport'):
            if getattr(self, name) not in (None, 'q16', 'q8'):
                raise ValueError(f'unknown {name} {getattr(self, name)!r} (None, "q16" or "q8")')
        if self.precision not in ('float32', 'bfloat16'):
            raise ValueError(f'precision must be float32 or bfloat16, got {self.precision!r}')
        if self.mesh is not None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device if self.device is not None else self.datamodule.device)
        self.model.to(self.device)
        self.primary = self.mesh is None or self.mesh.is_primary
        self.metrics_logger = MetricsLogger(self.log_dir, enabled=self.primary)
        self.early_stopping = EarlyStopping(patience=self.early_stopping_patience)
        self.plateau = PlateauController(base_lr=self.lr) if self.scheduler == 'plateau' else None
        schedule = exp_warmup_schedule(self.lr, self.warmup_steps, self.tau) if self.scheduler == 'expdecay' else self.lr
        self.opt = make_optimizer(schedule, weight_decay=self.weight_decay, grad_clip=self.grad_clip,
                                  accumulate_steps=self.accumulate_grad_batches)
        self.unified = self.family == 'wav2sleep' and len(self.model.signal_encoders.encoders) > 1
        self._train_step = make_train_step(
            self.model, self.opt, num_classes=self.num_classes, masker=self.masker if self.unified else None,
            flip_polarity=self.flip_polarity, label_smoothing=self.label_smoothing,
            ema_decay=None if self.ema_offload else self.ema_decay, ema_start_step=self.ema_start_step,
            compute_dtype=torch.bfloat16 if self.precision == 'bfloat16' else None, family=self.family,
            mesh=self.mesh,
        )
        self._eval_step = make_eval_step(self.model, self.num_classes, family=self.family)
        self.ring = StagingRing(self.stage_ring, self.device)
        self.host_ema: dict[str, np.ndarray] | None = None  # the offloaded EMA
        self._ema_pending: list = []  # parameter snapshots awaiting the fold
        self._ema_free: list = []  # snapshot buffers to reuse
        self._presence: dict = {}

    # ------------------------------------------------------------------
    def ensure_state(self) -> None:
        """The training state over the model's own parameters (made once)."""
        if self.state is not None:
            return
        self.state = init_train_state(self.model, self.opt, ema=self.ema_decay is not None and not self.ema_offload)
        if self.mesh is not None:
            # Every rank starts from the same seeded state: checked, not sent.
            pmesh.replicate(self.mesh, [self.state.params, self.state.batch_stats])
            pmesh.warmup_collectives(self.mesh)
        if self.ema_decay is not None and self.ema_offload and self.host_ema is None:
            self.host_ema = {k: p.detach().cpu().numpy().copy() for k, p in self.state.params.items()}
        n_params = sum(p.numel() for p in self.state.params.values())
        logger.info(f'Initialized model with {n_params:,} parameters.')

    def _pad_batch(self, x, y, target: int | None):
        """Pad a short batch to ``target`` rows by repeating its real rows,
        with ignore labels (-1): the loss and the confusion matrix skip them,
        per-row norms do not couple rows, and a batch-norm model's train
        statistics see real rows, not zeros. Returns (x, y, real_rows)."""
        B = int(y.shape[0])
        if target is None or B >= target:
            return x, y, B
        pad_idx = np.arange(target - B) % B
        x = {k: np.concatenate([v, v[pad_idx]], axis=0) for k, v in x.items()}
        y = np.concatenate([y, np.full((target - B, *y.shape[1:]), -1, y.dtype)], axis=0)
        return x, y, B

    def _batch_target(self, B: int, configured: int | None, whole: bool = False) -> int | None:
        """The rows a batch of ``B`` real rows is padded to: the configured
        loader batch size (one batch shape per phase); a loader's ``whole``
        batch over a group that splits batches is rounded up to the data
        axis, as the JAX trainer rounds each loading process's share of it
        (a process that loads its own rows holds a share of 1)."""
        target = max(B, int(configured)) if configured is not None else B
        if whole and self._split():
            n_data = self.mesh.shape[pmesh.DATA_AXIS]
            target = -(-target // n_data) * n_data
        return None if target == B else target

    def _split(self) -> bool:
        """Whether a rank keeps its block of each loader batch (one launch
        over N devices) rather than the whole of it."""
        return self.mesh is not None and not self.mesh.per_process_batches

    def _stage(self, x: dict, y: np.ndarray, batch_size: int | None, transport: str | None = None,
               dtype: torch.dtype = torch.float32, rank_rows: bool = False):
        """Pad a host batch, write it into the next ring slot (cast to
        ``dtype``, or encoded by ``transport``) and copy it to the device.
        With ``rank_rows`` the batch is a loader's whole batch: padded to the
        data axis, of which this rank keeps its block where the group splits
        batches (``_split``). Returns ((x, y) on the device, real rows of
        the whole batch)."""
        x, y, B = self._pad_batch(x, y, self._batch_target(y.shape[0], batch_size, whole=rank_rows))
        if rank_rows and self._split():
            x, y = pmesh.shard_batch(self.mesh, (x, y))
        with tracing.span('trainer/stage/claim'):
            j = self.ring.claim()
        with tracing.span('trainer/stage/write'):
            y_buf = self.ring.buffer(j, 'labels', torch.float32, y.shape)
            np.copyto(y_buf.numpy(), y, casting='same_kind')
            staged: dict = {}
            if transport is not None:
                encode, code_dtype = TRANSPORT_CODES[transport]
                pooled = {}
                for k, v in x.items():
                    bufs = (self.ring.buffer(j, k, code_dtype, v.shape),
                            self.ring.buffer(j, (k, 'peak'), torch.float32, v.shape[:1]),
                            self.ring.buffer(j, (k, 'present'), torch.bool, v.shape[:1]))
                    staged[k] = bufs
                    pooled[k] = tuple(t.numpy() for t in bufs)
                encode(x, slot=pooled)
            else:
                for k, v in x.items():
                    buf = staged[k] = self.ring.buffer(j, k, dtype, v.shape)
                    if dtype == torch.float32:
                        np.copyto(buf.numpy(), v, casting='same_kind')
                    else:
                        buf.copy_(torch.from_numpy(np.ascontiguousarray(v)))
        with tracing.span('trainer/stage/ship'):
            dev = self.ring.ship(j, {**staged, 'labels': y_buf})
        y_dev = dev.pop('labels')
        return (dev, y_dev), B

    def _stage_train(self, x, y):
        with tracing.span('trainer/stage'):
            if self.masker is not None:
                validate_batch(x)
            dtype = torch.bfloat16 if self.precision == 'bfloat16' else torch.float32
            # Over a group the loader's batch is this rank's own rows already.
            rows = getattr(self.datamodule, 'rank_batch_size', self.datamodule.batch_size)
            return self._stage(x, y, rows, self.input_transport, dtype)[0]

    def _progress(self, it, desc: str):
        """Smoothed tqdm progress (the reference's CustomTQDMProgressBar);
        the iterable as it is without tqdm or with the bar off."""
        if not self.progress_bar:
            return it
        try:
            from tqdm import tqdm
        except ImportError:
            return it
        return tqdm(it, desc=desc, smoothing=0.7, leave=False)

    @tracing.follow_profiler()
    def train_epoch(self, epoch: int) -> dict[str, float]:
        self.ensure_state()
        losses: list[torch.Tensor] = []
        cmat = np.zeros((self.num_classes, self.num_classes), np.int64)
        seed = epoch_seed(self.seed, epoch)
        pending: list = []

        def drain():
            with tracing.span('trainer/drain'):
                if pending:
                    np.add(cmat, torch.stack([m['cmat'] for m in pending]).sum(0).cpu().numpy(), out=cmat)
                    losses.extend(m['loss'] for m in pending)
                    pending.clear()
                self._drain_host_ema()

        t0 = time.time()
        host_it = iter(self._progress(self.datamodule.train_loader(epoch), f'train e{epoch}'))
        # Seconds the host spends producing batches (parquet read,
        # normalization, collate) as a share of the epoch: near 1 the
        # loader, not the card, sets the step time.
        t_host = 0.0
        th0 = time.time()
        with tracing.span('trainer/load'):
            nxt = next(host_it, None)
        t_host += time.time() - th0
        dev = self._stage_train(*nxt) if nxt is not None else None
        n = 0
        while dev is not None:
            step_before = self.state.step
            with tracing.span('trainer/step'):
                self.state, metrics = self._train_step(self.state, dev, seed)
            th0 = time.time()
            with tracing.span('trainer/load'):
                nxt = next(host_it, None)
            t_host += time.time() - th0
            dev = self._stage_train(*nxt) if nxt is not None else None
            if self.host_ema is not None:
                self._enqueue_host_ema(step_before)
            pending.append(metrics)
            if len(pending) >= max(1, self.metric_fetch_every):
                drain()
            n += 1
        drain()
        self.ring.release()
        if not losses:
            raise ValueError('Empty training epoch - no batches produced.')
        loss = float(torch.stack(losses).mean())
        elapsed = time.time() - t0
        out = {
            'train_loss': loss,
            'train_steps_per_sec': n / max(elapsed, 1e-9),
            'lr_step': int(self.state.step),
            'lr': self.current_lr(),
            'host_loader_frac': round(t_host / max(elapsed, 1e-9), 4),
        }
        self.metrics_logger.log(out, step=epoch)
        self.metrics_logger.log_confusion(cmat, epoch, prefix=f'{TRAIN}_all')
        return out

    def current_lr(self) -> float:
        """The learning rate of the most recent optimizer update, from the
        host's counters (the reference's LearningRateMonitor): 'expdecay' at
        the applied-update count (micro-steps over the accumulation),
        'plateau' the base LR times the controller's scale."""
        if self.plateau is not None:
            return float(self.lr * self.plateau.scale)
        if self.scheduler != 'expdecay':
            return float(self.lr)
        step = max(int(self.state.step) // max(1, self.accumulate_grad_batches), 1)
        if step <= self.warmup_steps:
            return float(self.lr * step / self.warmup_steps)
        return float(self.lr * math.exp(-(step - self.warmup_steps) / self.tau))

    # ------------------------------------------------------------------
    def _enqueue_host_ema(self, step_before: int) -> None:
        """Queue the parameters after the step that was at ``step_before``
        for the offloaded EMA, when that step applied an optimizer update at
        or after ``ema_start_step`` (both counted in optimizer steps, as
        the in-graph EMA). The copy to pinned host memory runs behind the
        step on the card's stream; the fold waits for it at the next read."""
        k = max(1, self.accumulate_grad_batches)
        if (step_before + 1) % k != 0 or step_before // k < self.ema_start_step:
            return
        params = list(self.state.params.values())
        snap = self._ema_free.pop() if self._ema_free else [
            torch.empty(p.shape, dtype=p.dtype, pin_memory=self.device.type == 'cuda') for p in params]
        for d, p in zip(snap, params):
            d.copy_(p.detach(), non_blocking=True)
        event = None
        if self.device.type == 'cuda':
            event = torch.cuda.Event()
            event.record()
        self._ema_pending.append((snap, event))
        # Bound the snapshots in flight: the oldest were copied steps ago.
        while len(self._ema_pending) > max(2, self.stage_ring):
            self._fold_host_ema(*self._ema_pending.pop(0))

    def _fold_host_ema(self, snap: list[torch.Tensor], event) -> None:
        if event is not None:
            event.synchronize()
        d = self.ema_decay
        for e, p in zip(self.host_ema.values(), snap):
            p_np = p.numpy()
            np.multiply(e, d, out=e)
            np.multiply(p_np, 1.0 - d, out=p_np)
            e += p_np
        self._ema_free.append(snap)

    def _drain_host_ema(self) -> None:
        for snap, event in self._ema_pending:
            self._fold_host_ema(snap, event)
        self._ema_pending.clear()

    # ------------------------------------------------------------------
    def _eval_params(self) -> dict[str, torch.Tensor]:
        if self.ema_decay is None:
            return self.state.params
        if self.host_ema is not None:
            # One copy to the card per eval or predict pass.
            return {k: torch.from_numpy(v).to(self.device) for k, v in self.host_ema.items()}
        if self.state.ema_params is not None:
            return self.state.ema_params
        return self.state.params

    def _present(self, key: tuple[str, ...], signals, B: int) -> dict[str, torch.Tensor]:
        """Presence masks of ``key``'s signals for a batch of ``B`` rows, made
        on the device once."""
        cache_key = key, tuple(signals), B
        if cache_key not in self._presence:
            self._presence[cache_key] = {k: torch.full((B,), k in key, dtype=torch.bool, device=self.device)
                                         for k in signals}
        return self._presence[cache_key]

    def _run_eval(self, loader, subsets: tuple[tuple[str, ...], ...] = (), batch_size: int | None = None):
        """One pass over a loader: each batch is copied to the device once,
        then evaluated under the full modality set and every subset
        (presence masks). Returns ``{None: (loss, cmat), subset: (loss,
        cmat), ...}``, each loss the batches' mean weighted by their scored
        epochs."""
        self.ensure_state()
        keys: list = [None, *subsets]
        losses: dict = {k: [] for k in keys}
        cmats = {k: np.zeros((self.num_classes, self.num_classes), np.int64) for k in keys}
        params = self._eval_params()
        pending: list = []

        def drain():
            if not pending:
                return
            batch_losses = torch.stack([out['loss'].float() for _, out in pending]).cpu().numpy()
            batch_cmats = torch.stack([out['cmat'] for _, out in pending]).cpu().numpy().astype(np.int64)
            for (key, _), loss, cmat in zip(pending, batch_losses, batch_cmats):
                losses[key].append((float(loss), int(cmat.sum())))
                cmats[key] += cmat
            pending.clear()

        n = 0
        for x, y in loader:
            batch, _ = self._stage(x, y, batch_size, self.eval_transport, rank_rows=True)
            Bp = int(batch[1].shape[0])
            for key in keys:
                present = None if key is None else self._present(key, batch[0], Bp)
                pending.append((key, self._eval_step(params, batch, present)))
            n += 1
            if n % max(1, self.eval_fetch_every) == 0:
                drain()
        drain()
        self.ring.release()
        # Per key: sum(loss x scored epochs), scored epochs, the matrix.
        sums = np.array([[sum(l * c for l, c in losses[k]), sum(c for _, c in losses[k]), *cmats[k].ravel()]
                         for k in keys], np.float64)
        if self.mesh is not None:
            # A rank's part of the eval matrix, summed over the group (exact:
            # the counts are integers far below 2**53).
            sums = pmesh.all_reduce_sum(torch.from_numpy(sums).to(self.device)).cpu().numpy()
        out = {}
        for k, (total_loss, total, *cmat) in zip(keys, sums):
            loss = float('nan') if total == 0 else float(total_loss / total)
            out[k] = (loss, np.rint(cmat).astype(np.int64).reshape(cmats[k].shape))
        return out

    def _subset_matrix(self, ds_name: str, mode: str) -> list[tuple[str, ...]]:
        """Signal subsets to evaluate per dataset (the reference's
        trainer/main.py:188-224)."""
        if not self.unified:
            return []
        valid = set(self.model.valid_signals)
        cols = set(self.datamodule.columns)
        subsets: list[tuple[str, ...]] = []
        if ECG in cols and ECG in valid:
            subsets.append((ECG,))
            ecg_thx_ok = THX in cols and THX in valid
            if mode == VAL:
                if ecg_thx_ok and ds_name in (SHHS, MESA):
                    subsets.append((ECG, THX))
            elif ecg_thx_ok:
                subsets.append((ECG, THX))
        if PPG in cols and PPG in valid and ds_name in (MESA, CFS, CCSHS, CHAT):
            subsets.append((PPG,))
            if THX in cols and THX in valid and ds_name == MESA:
                subsets.append((PPG, THX))
        return subsets

    def evaluate(self, mode: str = VAL, epoch: int | None = None) -> dict[str, float]:
        """The full eval matrix; returns flat metrics including ``{mode}_loss``.
        Per-loader wall times go to metrics.jsonl, not into the result."""
        epoch = self.current_epoch if epoch is None else epoch
        loaders = self.datamodule.val_loaders() if mode == VAL else self.datamodule.test_loaders()
        eval_bs = getattr(self.datamodule, 'val_batch_size' if mode == VAL else 'test_batch_size', None)
        results: dict[str, float] = {}
        timings: dict[str, float] = {}
        t_eval0 = time.time()
        for ds_name, loader in loaders:
            is_combined = mode == VAL and ds_name == 'all'
            subsets = () if is_combined else tuple(self._subset_matrix(ds_name, mode))
            stats = self._run_eval(loader, subsets, batch_size=eval_bs)
            timings[f'{mode}_eval_seconds_{ds_name}'] = round(time.time() - t_eval0, 3)
            t_eval0 = time.time()
            loss, cmat = stats[None]
            results[f'{mode}_loss' if is_combined else f'{mode}_loss_{ds_name}'] = loss
            self.metrics_logger.log_confusion(cmat, epoch, prefix=f'{mode}_{ds_name}')
            for subset in subsets:
                sig_prefix = '_'.join(subset)
                loss_s, cmat_s = stats[subset]
                results[f'{mode}_{sig_prefix}_loss_{ds_name}'] = loss_s
                self.metrics_logger.log_confusion(cmat_s, epoch, prefix=f'{mode}_{sig_prefix}_{ds_name}')
        if mode == VAL and self.shadow_eval_transport is not None:
            # The val loaders again under the shadow transport, aggregated as
            # the primary val_loss is.
            saved = self.eval_transport
            self.eval_transport = self.shadow_eval_transport
            t_shadow = time.time()
            try:
                combined, per_ds = None, []
                for ds_name, loader in self.datamodule.val_loaders():
                    loss, _ = self._run_eval(loader, (), batch_size=eval_bs)[None]
                    if ds_name == 'all':
                        combined = loss
                    else:
                        per_ds.append(loss)
            finally:
                self.eval_transport = saved
            if combined is not None or per_ds:
                timings[f'{mode}_loss_{self.shadow_eval_transport}'] = float(
                    combined if combined is not None else np.mean(per_ds))
            timings[f'{mode}_shadow_eval_seconds'] = round(time.time() - t_shadow, 3)
        if mode == VAL and f'{mode}_loss' not in results:
            # No combined loader (census only): early stopping and checkpoint
            # selection take the mean of the per-dataset losses.
            per_ds = [v for k, v in results.items() if k.startswith(f'{mode}_loss_')]
            if per_ds:
                results[f'{mode}_loss'] = float(np.mean(per_ds))
                logger.warning('No combined val loader; val_loss is the mean of the per-dataset val losses.')
        self.metrics_logger.log({**results, **timings}, step=epoch)
        return results

    # ------------------------------------------------------------------
    def fit(self, resume_from: str | None = None) -> dict[str, float]:
        from .checkpointing import CheckpointManager

        ckpt = CheckpointManager(os.path.join(self.log_dir, 'checkpoints'))
        start_epoch = 0
        if resume_from:
            start_epoch = self.restore(resume_from, ckpt)
        if self.reset_early_stopping:
            self.early_stopping.reset()
        # A run resumed at or past its last epoch trains nothing: it returns
        # the last evaluation's metrics (the JAX package returns {} here).
        last_val: dict[str, float] = self.metrics_logger.last_val_metrics() if start_epoch >= self.epochs else {}
        for epoch in range(start_epoch, self.epochs):
            self.current_epoch = epoch
            train_metrics = self.train_epoch(epoch)
            val_metrics = self.evaluate(VAL, epoch)
            last_val = val_metrics
            # No validation data (no val_loss) is not divergence: train every
            # epoch with early stopping off. A present non-finite val_loss is.
            has_val = 'val_loss' in val_metrics
            val_loss = val_metrics.get('val_loss', float('nan'))
            logger.info(f'epoch {epoch}: train_loss={train_metrics["train_loss"]:.4f} val_loss={val_loss:.4f}')
            if self.plateau is not None and np.isfinite(val_loss):
                # The plateau cut scales the LR of the next updates.
                self.state.opt_state.lr_scale = self.plateau.update(val_loss)
            # Early stopping updates before the checkpoint, whose sidecar
            # carries its state; is_best is judged against the best before
            # this epoch.
            is_best = val_loss <= self.early_stopping.best
            should_stop = has_val and np.isfinite(val_loss) and self.early_stopping.update(val_loss)
            ckpt.save(self, epoch, val_loss, is_best=is_best)
            if not has_val:
                continue
            if not np.isfinite(val_loss):
                logger.warning(f'Stopping at epoch {epoch}: non-finite val_loss ({val_loss}).')
                break
            if should_stop:
                logger.info(f'Early stopping at epoch {epoch} (best val_loss {self.early_stopping.best:.4f}).')
                break
        return last_val

    def predict(self, loader) -> dict[str, np.ndarray]:
        """Hypnograms of every night of ``loader`` under all its signals and,
        where the data module's columns have them, ECG only and ECG + THX
        (presence masks), with the labels: ``labels``, ``preds``,
        ``preds_ECG``, ``preds_ECG_THX``."""
        self.ensure_state()
        params = self._eval_params()
        outputs: dict[str, list[np.ndarray]] = {'labels': [], 'preds': []}
        cols = set(self.datamodule.columns)
        variants = {'preds': None}
        if ECG in cols:
            variants[f'preds_{ECG}'] = (ECG,)
            if THX in cols:
                variants[f'preds_{ECG}_{THX}'] = (ECG, THX)
        for x, y in loader:
            outputs['labels'].append(np.asarray(y))
            # One copy, every variant; over a group that splits batches this
            # rank predicts its block and the blocks are gathered.
            batch, B = self._stage(x, y, None, rank_rows=True)
            Bp = int(batch[1].shape[0])
            for name, key in variants.items():
                present = None if key is None else self._present(key, batch[0], Bp)
                preds = self._eval_step(params, batch, present)['preds']
                if self._split():
                    preds = pmesh.gather_rows(self.mesh, preds)
                outputs.setdefault(name, []).append(preds.cpu().numpy()[:B])
        self.ring.release()
        return {k: np.concatenate(v, axis=0) for k, v in outputs.items()}

    def restore(self, path: str, manager=None) -> int:
        from .checkpointing import CheckpointManager

        manager = manager or CheckpointManager(os.path.join(self.log_dir, 'checkpoints'))
        return manager.restore(self, path)

    def export(self, folder: str, config: dict) -> None:
        """Write the deployable checkpoint folder (``config.yaml`` and
        ``state_dict.pth`` of the eval weights and the running statistics),
        which ``api.load_model`` and the reference read."""
        from ..checkpoint import save_checkpoint_folder

        self.ensure_state()
        state_dict = {**self.model.state_dict(), **self._eval_params()}
        if self.primary:
            save_checkpoint_folder(folder, config, state_dict)
        if self.mesh is not None:
            pmesh.barrier()
