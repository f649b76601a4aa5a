"""Device time a step under the program's span ``train_step/forward``, in ms."""


def read(run):
    if run.trace is None or not run.cuda or not run.counters.get('steps'):
        return None
    s = run.trace.spans.get('train_step/forward')
    return 1e3 * s / run.counters['steps'] if s else None
