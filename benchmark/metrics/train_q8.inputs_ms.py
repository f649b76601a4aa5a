"""Device ms a step under the program's span ``train_step/inputs``: the q8
decode, the polarity flip and the masker, before the forward."""


def read(run):
    if run.trace is None or not run.cuda or not run.counters.get('steps'):
        return None
    s = run.trace.spans.get('train_step/inputs')
    return 1e3 * s / run.counters['steps'] if s else None
