"""Start and collect a job of ``tests/torch_dist_worker.py`` (or
``tests/torch_mp_worker.py``) ranks through ``tools/launch_torch.py``
(``launch_local``) for the port's multi-process tests.

The launcher has no overall timeout, so the job runs in a session of its
own under a subprocess timeout: past it, the whole session (launcher and
ranks) is killed and the test fails with the job's output.  ``finish``
requires every rank to succeed; ``wait`` returns the exit code of a job
that is meant to fail (a rank killed on purpose).
"""
import os
import signal
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
MP_WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


def start(mode, outdir, platform="cpu", ranks=2, worker=WORKER):
    """Launch ``ranks`` processes of ``worker`` in ``mode`` writing to
    ``outdir``; returns the launcher's process."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, os.path.join(REPO, "tools", "launch_torch.py"), "-n",
           str(ranks), sys.executable, worker, mode, str(outdir), platform]
    return subprocess.Popen(cmd, env=env, cwd=REPO, start_new_session=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait(proc, timeout=240):
    """Wait for the job (killing it past ``timeout`` seconds); returns its
    exit code and output, whatever the code (a job expected to fail)."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError("the dist job passed its %d s limit:\n%s"
                             % (timeout, out[-6000:]))
    return proc.returncode, out


def load(outdir, ranks=2):
    """Each rank's ``rank<r>.npz`` as a dict."""
    return [dict(np.load(os.path.join(str(outdir), "rank%d.npz" % r)))
            for r in range(ranks)]


def finish(proc, outdir, ranks=2, timeout=240):
    """Wait for the job (killing it past ``timeout`` seconds), require
    that every rank succeeded, and return each rank's ``rank<r>.npz`` as
    a dict."""
    rc, out = wait(proc, timeout)
    assert rc == 0, "a rank failed (rc=%d):\n%s" % (rc, out[-6000:])
    return load(outdir, ranks)
