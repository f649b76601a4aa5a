"""Where a flagship training step spends its device time, on one NVIDIA card.

    python -m wav2sleep_tpu_torch.profile_train [--precision float32|bfloat16]
        [--batch 16] [--table FILE]

Builds ``train_bench``'s step (masker, flip, EMA, remat as the training
config has it, torch's default TF32 flags; the f32 step switches them off
for itself) on its seeded batch of ten-hour nights, already on the card,
and prints, per step:

- the wall time (CUDA events, median of 3) and the device time that
  ``torch.profiler`` records over 2 steps;
- the step's spans (``train_step/forward``, ``train_step/optimizer``;
  ``tracing``, on while the profiler records) and the backward (the rest
  of the device time);
- K1 and K2 (the ``_ConvK3`` / ``_ConvK3Stats`` forwards, recompute
  included) and the backward of those convs (``_ConvK3Backward`` /
  ``_ConvK3StatsBackward``: the plain version's forward and its gradient,
  in cuDNN), by device time;
- the kernels, and then the ops that launched them, by self device time;
- the peak device memory.

A backward follows the step's forward, so by default the encoders' fused
chain runs K1 and takes its statistics from ``block_stats``
(``block_domain.kernel_stats_enabled``). ``WAV2SLEEP_KERNEL_STATS=1`` in the
environment forces K2 there, whose backward reruns ``block_stats`` in plain
ops. ``--table`` also writes the profiler's full ``key_averages()`` table
there.
"""

from __future__ import annotations

import argparse
import statistics

import torch
from torch.autograd import DeviceType

from . import tracing, train_bench

STEPS, ROWS = 2, 15
EPOCHS = 1200  # ten hours of 30 s epochs, as train_bench's default
SPANS = ('train_step/forward', 'train_step/optimizer')
CONV_OPS = ('_ConvK3', '_ConvK3Stats')
CONV_BACKWARD = ('_ConvK3Backward', '_ConvK3StatsBackward')


def _self_us(avg) -> float:
    return float(avg.self_device_time_total)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--precision', default='float32', choices=sorted(train_bench.DTYPES))
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--table', default=None, help="file for the profiler's full table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train needs an NVIDIA card')

    s = train_bench.build(args.precision, device='cuda')
    x, y = train_bench.example_batch(args.batch, EPOCHS)
    batch = train_bench.device_batch(x, y, 'lossless', s.dtype, s.device)
    torch.cuda.reset_peak_memory_stats()
    train_bench.chain_ms(s, batch, 1)  # warm
    wall = statistics.median(train_bench.chain_ms(s, batch, 1)[0] for _ in range(3))
    # The step's spans enter their record_function while the recorder is on.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof, tracing.follow_profiler():
        train_bench.chain_ms(s, batch, STEPS)
    tracing.collect()
    avgs = prof.key_averages()
    n = STEPS
    # Device entries are the kernels and copies (the spans also appear on
    # the device's timeline as ranges, which are not work); host entries are
    # the ops that launched them, each with the device time of its own
    # launches.
    on_device = [a for a in avgs if a.device_type != DeviceType.CPU and _self_us(a) > 0 and a.key not in SPANS]
    on_host = [a for a in avgs if a.device_type == DeviceType.CPU and _self_us(a) > 0]
    device_ms = sum(_self_us(a) for a in on_device) / 1e3 / n

    def host_ms(key: str, inclusive: bool) -> tuple[float, float]:
        hits = [a for a in avgs if a.device_type == DeviceType.CPU and a.key == key]
        us = sum(float(a.device_time_total if inclusive else a.self_device_time_total) for a in hits)
        return us / 1e3 / n, sum(a.count for a in hits) / n
    print(f'{torch.cuda.get_device_name(0)}; flagship training step, {args.precision}, B={args.batch} x '
          f'{EPOCHS} epochs, remat, masker, flip, EMA')
    print(f'wall per step (CUDA events, median of 3): {wall:.3f} ms')
    print(f'device time per step (profiler, {n} steps): {device_ms:.3f} ms ({100 * device_ms / wall:.1f}% of the wall)')
    print(f'peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    # The backward runs on autograd's own thread, outside the step's spans:
    # it is the device time the forward and optimizer spans leave.
    rows = {key: host_ms(key, True) for key in SPANS}
    rows['backward (the rest)'] = (device_ms - sum(ms for ms, _ in rows.values()), 1.0)
    rows.update({key: host_ms(key, False) for key in CONV_OPS})
    rows.update({key: host_ms(key, True) for key in CONV_BACKWARD})
    for key, (ms, calls) in rows.items():
        print(f'{key:24s} {ms:9.3f} ms/step {calls:7.1f} calls/step {100 * ms / device_ms:5.1f}% of the device time')
    for title, rows in (('kernel', on_device), ('op', on_host)):
        print(f'{title:70s} {"ms/step":>9s} {"calls/step":>10s} {"share":>6s}')
        for a in sorted(rows, key=_self_us, reverse=True)[:ROWS]:
            ms = _self_us(a) / 1e3 / n
            print(f'{a.key[:70]:70s} {ms:9.3f} {a.count / n:10.1f} {100 * ms / device_ms:5.1f}%')
    if args.table:
        with open(args.table, 'w') as f:
            f.write(avgs.table(sort_by='self_device_time_total', row_limit=200, max_name_column_width=100))


if __name__ == '__main__':
    main()
