"""Where a flagship serving forward spends its device time, on one NVIDIA card.

    python -m wav2sleep_tpu_torch.profile_forward [--signals cardio|eog] [--table FILE]

Runs ``make_streaming_forward_q8`` (bf16, the flagship model of the
``--signals`` variant with seeded random weights: cardio, the default, or
wav2sleep-eog) on seeded int8 codes for a batch of 8 ten-hour nights,
already on the card, and prints, per forward:

- the k3 conv kernel's launches (K1's and K2's; a serving forward takes
  its statistics from K2, so all are K2's unless ``block_domain.KERNEL_STATS``
  is False);
- the wall time (CUDA events, median of 5), and the device time that
  ``torch.profiler`` records over 3 forwards;
- the kernels, and then the ops that launched them, by self device time
  (ms per forward, calls per forward, share of the device time);
- each signal encoder's time (CUDA events) on the same bf16 inputs.

``--table`` also writes the profiler's full ``key_averages()`` table there.
"""

from __future__ import annotations

import argparse
import statistics

import torch
from torch.autograd import DeviceType

from .models.wav2sleep import VARIANTS, flagship_model
from .ops import conv_k3
from .pipeline import Q8_META_DTYPE, grid_length, make_streaming_forward_q8

BATCH, HOURS, FORWARDS, ROWS = 8, 10.0, 3, 15


def _cuda_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _self_device_us(avg) -> float:
    return float(avg.self_device_time_total)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--signals', default='cardio', choices=sorted(VARIANTS), help='the released variant')
    ap.add_argument('--table', default=None, help="file for the profiler's full table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_forward needs an NVIDIA card')

    signals = VARIANTS[args.signals][1]
    model = flagship_model(variant=args.signals, device='cuda', generator=torch.Generator().manual_seed(0))
    forward = make_streaming_forward_q8(model, 'bfloat16', output='logits')
    gen = torch.Generator(device='cuda').manual_seed(0)
    B, q, fields = BATCH, {}, {name: {} for name in Q8_META_DTYPE.names}
    for c in signals:
        n = grid_length(c, HOURS)
        q[c] = torch.randint(-127, 128, (B, n), generator=gen, device='cuda', dtype=torch.int8)
        for name, value in (('a', 1.0), ('b', 0.0), ('vmax', 1000.0)):
            fields[name][c] = torch.full((B,), value, device='cuda')
        for name in ('n_valid', 'n_pad'):
            fields[name][c] = torch.full((B,), n, dtype=torch.int32, device='cuda')
        fields['present'][c] = torch.ones(B, dtype=torch.bool, device='cuda')

    def run():
        return forward(q, *fields.values())

    wall = _cuda_ms(run)
    conv_k3.LAUNCHES = conv_k3.STATS_LAUNCHES = 0
    run()
    torch.cuda.synchronize()
    launches, k2_launches = conv_k3.LAUNCHES, conv_k3.STATS_LAUNCHES
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(FORWARDS):
            run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    n = FORWARDS
    # Device entries are the kernels (and copies); host entries are the ops
    # that launched them, each with the device time of its own launches.
    on_device = [a for a in avgs if a.device_type != DeviceType.CPU and _self_device_us(a) > 0]
    on_host = [a for a in avgs if a.device_type == DeviceType.CPU and _self_device_us(a) > 0]
    device_ms = sum(_self_device_us(a) for a in on_device) / 1e3 / n
    print(f'{torch.cuda.get_device_name(0)}; {args.signals} flagship q8 forward, bf16, B={B} x {HOURS:g} h; '
          f'{launches} k3 conv kernel launches a forward (conv_k3.LAUNCHES: K1 and K2), '
          f'{k2_launches} of them K2 (statistics epilogue)')
    print(f'wall per forward (CUDA events, median of 5): {wall:.3f} ms')
    print(f'device time per forward (profiler, {n} forwards): {device_ms:.3f} ms '
          f'({100 * device_ms / wall:.1f}% of the wall)')
    for title, rows in (('kernel', on_device), ('op', on_host)):
        print(f'{title:70s} {"ms/fwd":>9s} {"calls/fwd":>9s} {"share":>6s}')
        for a in sorted(rows, key=_self_device_us, reverse=True)[:ROWS]:
            ms = _self_device_us(a) / 1e3 / n
            print(f'{a.key[:70]:70s} {ms:9.3f} {a.count / n:9.1f} {100 * ms / device_ms:5.1f}%')
    if args.table:
        with open(args.table, 'w') as f:
            f.write(avgs.table(sort_by='self_device_time_total', row_limit=200, max_name_column_width=100))

    with torch.inference_mode():
        for c in signals:
            x = torch.randn(q[c].shape, generator=gen, device='cuda').to(torch.bfloat16)
            enc = model.signal_encoders.encoders[c]
            print(f'encoder {c}: {_cuda_ms(lambda: enc(x)):.3f} ms')


if __name__ == '__main__':
    main()
