"""Modality dropout and polarity flip of the training step.

Port of ``wav2sleep_tpu/train/masker.py``. ``SignalMasker`` drops each
night's channels with per-signal probabilities and keeps at least one: when
a night would lose every channel, one survivor is drawn from the
``backups`` present in that night (or, without ``backups``, from the
present channels weighted by their keep probability); a night with no such
channel keeps its channels as they were. A dropped channel becomes the
``-inf`` missing-modality row. ``invert_signals`` flips each (night,
signal) row's sign with probability 0.5.

Both draw from the ``torch.Generator`` they are given, on the batch's
device, never from the global stream. The streams are torch's, not JAX's,
so the two packages drop and flip different rows for the same seed. With
``rows=(start, total)`` a rank of a data-parallel group holds rows
``start:start + B`` of a global batch of ``total``: it draws for all
``total`` rows and keeps its own, so the group drops and flips what one
card does on the global batch.
"""

from __future__ import annotations

import torch

NEG_INF = float('-inf')


def validate_batch(signals: dict) -> None:
    """Raise when a night of the batch has every signal missing."""
    missing = torch.stack([torch.isinf(torch.as_tensor(x)[:, 0]) for x in signals.values()], dim=-1)
    if bool(missing.all(dim=-1).any()):
        raise ValueError('Found batch element with all signals unavailable.')


class SignalMasker:
    """Callable masker: ``masker(generator, signals) -> masked signals``.

    Args:
        dropouts: per-signal drop probability (e.g. ABD .7, THX .7, ECG .5,
            PPG .1 - scripts/config/inputs/cardiorespiratory/all.yaml).
        backups: signals eligible as the guaranteed survivor.
    """

    def __init__(self, dropouts: dict[str, float], backups: list[str] | None = None):
        for name, p in dropouts.items():
            if p < 0.0 or p > 1.0:
                raise ValueError(f'channel_dropout={p} for {name} is not a valid probability.')
        self.channel_dropouts = dict(dropouts)
        self.backup_channels = list(backups) if backups is not None else None
        self._constants = {}

    def _per_signal(self, names: tuple[str, ...], device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """The drop probabilities and the backup eligibility of ``names``,
        made on ``device`` once: a copy from pageable host memory would wait
        for the device's queue on every step."""
        key = names, device
        if key not in self._constants:
            p = [self.channel_dropouts.get(n, 0.0) for n in names]
            eligible = [self.backup_channels is not None and n in self.backup_channels for n in names]
            self._constants[key] = (torch.tensor(p, dtype=torch.float32).to(device),
                                    torch.tensor(eligible).to(device))
        return self._constants[key]

    def __call__(self, generator: torch.Generator, signals: dict[str, torch.Tensor],
                 rows: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
        names = list(signals)
        first = signals[names[0]]
        B, dev = first.shape[0], first.device
        start, total = rows if rows is not None else (0, B)
        z_BC = torch.stack([torch.isinf(signals[n][:, 0]) for n in names], dim=-1)  # True = missing
        p, eligible = self._per_signal(tuple(names), dev)

        # Survivor weights per night.
        if self.backup_channels is not None:
            weights = (~z_BC & eligible).to(torch.float32)
        else:
            weights = (~z_BC).to(torch.float32) * (1.0 - p)

        keep_BC = torch.rand((total, len(names)), generator=generator, device=dev)[start : start + B] < (1.0 - p)
        # One survivor per night by the Gumbel-max draw over log(weights).
        has_backup = weights.sum(dim=-1) > 0
        u = torch.rand((total, len(names)), generator=generator, device=dev)[start : start + B]
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        scores = torch.where(weights > 0, torch.log(weights.clamp_min(1e-30)) + gumbel, -torch.inf)
        survivor_BC = torch.nn.functional.one_hot(scores.argmax(dim=-1), len(names)).bool()

        all_zero = (z_BC | ~keep_BC).all(dim=-1)
        m_BC = torch.where((all_zero & has_backup)[:, None], survivor_BC, keep_BC)
        # No survivor available: the night keeps its channels as they were.
        m_BC = torch.where((all_zero & ~has_backup)[:, None], ~z_BC, m_BC)
        return {n: torch.where(m_BC[:, i, None], signals[n], NEG_INF) for i, n in enumerate(names)}


def invert_signals(generator: torch.Generator, signals: dict[str, torch.Tensor],
                   rows: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """Flip each (night, signal) row's polarity with probability 0.5."""
    out = {}
    for name, x_BT in signals.items():
        B = x_BT.shape[0]
        start, total = rows if rows is not None else (0, B)
        flip = torch.rand((total, 1), generator=generator, device=x_BT.device)[start : start + B] < 0.5
        out[name] = x_BT * torch.where(flip, -1.0, 1.0).to(x_BT.dtype)
    return out
