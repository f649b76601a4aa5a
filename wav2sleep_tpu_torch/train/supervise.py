"""Supervised training runs: stall detection and checkpoint-resume restarts.

The port's counterpart of ``wav2sleep_tpu/train/supervise.py``.
``run_supervised`` runs the training CLI (``python -m
wav2sleep_tpu_torch.train``) in a child process pinned to one run directory
(``run_dir=``), watches the child's combined output file for liveness (tqdm
writes every step, so silence means a wedge; the timeout must exceed the
longest quiet stretch, such as the first kernel builds), and on a stall
sends SIGABRT (``PYTHONFAULTHANDLER=1`` makes the child dump every thread's
stack into the log) and then SIGKILL. Each restart appends
``ckpt_path=last`` once a checkpoint exists, so completed epochs are not
trained again and every attempt appends to the same ``metrics.jsonl``. A
child that exits non-zero without stalling has a real error and is not
retried. (The JAX package also retries a relay transport's "device fetch
failed" exit, which nothing in the port produces.)
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time

logger = logging.getLogger(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN_COMMAND = (sys.executable, '-m', 'wav2sleep_tpu_torch.train')


class SupervisedRunFailed(RuntimeError):
    pass


def _terminate(child: subprocess.Popen, grace: float = 45.0) -> None:
    """SIGABRT (the stack dump), wait, SIGKILL, wait: the child is reaped
    before the next attempt starts."""
    try:
        child.send_signal(signal.SIGABRT)
    except ProcessLookupError:
        return
    try:
        child.wait(timeout=grace)
        return
    except subprocess.TimeoutExpired:
        pass
    try:
        child.kill()
    except ProcessLookupError:
        pass
    child.wait()


def run_supervised(
    overrides: list[str],
    run_dir: str,
    *,
    stall_timeout: float = 900.0,
    max_attempts: int = 5,
    poll: float = 20.0,
    train_command: list[str] | None = None,
    post_kill_grace: float = 30.0,
) -> str:
    """Drive the training CLI (or ``train_command``, a command line that
    takes the overrides as its arguments) to completion under a stall
    watchdog. Returns the log file of the attempt that succeeded; raises
    ``SupervisedRunFailed`` when an attempt exits non-zero or every attempt
    stalls."""
    os.makedirs(run_dir, exist_ok=True)
    command = list(train_command or TRAIN_COMMAND)
    env = {**os.environ, 'PYTHONFAULTHANDLER': '1', 'PYTHONUNBUFFERED': '1',
           'PYTHONPATH': os.pathsep.join(p for p in (REPO, os.environ.get('PYTHONPATH')) if p)}
    for attempt in range(max_attempts):
        argv = [*command, *overrides, f'run_dir={run_dir}']
        if attempt > 0 and os.path.isdir(os.path.join(run_dir, 'checkpoints', 'last')):
            argv.append('ckpt_path=last')
        log_fp = os.path.join(run_dir, f'supervised_attempt{attempt}.log')
        logger.info('supervised attempt %d: %s (log %s)', attempt, ' '.join(argv[len(command):]), log_fp)
        with open(log_fp, 'wb') as logf:
            child = subprocess.Popen(argv, stdout=logf, stderr=subprocess.STDOUT, env=env)
            stalled = False
            while True:
                try:
                    rc = child.wait(timeout=poll)
                    break
                except subprocess.TimeoutExpired:
                    pass
                silent = time.time() - os.path.getmtime(log_fp)
                if silent > stall_timeout:
                    logger.warning('supervised attempt %d stalled (%.0fs of log silence): SIGABRT for stacks, '
                                   'then restart from the last checkpoint', attempt, silent)
                    _terminate(child)
                    stalled = True
                    break
        if not stalled:
            if rc == 0:
                return log_fp
            with open(log_fp, 'rb') as f:
                tail = f.read()[-4000:].decode(errors='replace')
            raise SupervisedRunFailed(
                f'training exited rc={rc} on attempt {attempt} (not a stall; not retrying). Log tail:\n{tail}')
        time.sleep(post_kill_grace)
    raise SupervisedRunFailed(f'all {max_attempts} attempts stalled ({run_dir})')
