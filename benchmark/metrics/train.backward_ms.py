"""Device time a step outside the program's spans ``train_step/forward``
and ``train_step/optimizer``, copies left out, in ms: the backward, which
runs on autograd's own thread."""


def read(run):
    t = run.trace
    if t is None or not run.cuda or not run.counters.get('steps') or 'train_step/forward' not in t.spans:
        return None
    compute = sum(s for op, s in t.device_ops.items() if 'Memcpy' not in op and 'Memset' not in op)
    rest = compute - t.spans['train_step/forward'] - t.spans.get('train_step/optimizer', 0.0)
    return 1e3 * rest / run.counters['steps'] if rest > 0 else None
