"""Start and collect a job of ``tests/torch_dist_worker.py`` ranks through
``tools/launch.py`` (``launch_local``) for the port's multi-process tests.

The launcher has no overall timeout, so the job runs in a session of its
own under a subprocess timeout: past it, the whole session (launcher and
ranks) is killed and the test fails with the job's output.
"""
import os
import signal
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")


def start(mode, outdir, platform="cpu", ranks=2):
    """Launch ``ranks`` worker processes in ``mode`` writing to
    ``outdir``; returns the launcher's process."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
           str(ranks), sys.executable, WORKER, mode, str(outdir), platform]
    return subprocess.Popen(cmd, env=env, cwd=REPO, start_new_session=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(proc, outdir, ranks=2, timeout=240):
    """Wait for the job (killing it past ``timeout`` seconds) and return
    each rank's ``rank<r>.npz`` as a dict."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError("the dist job passed its %d s limit:\n%s"
                             % (timeout, out[-6000:]))
    assert proc.returncode == 0, \
        "a rank failed (rc=%d):\n%s" % (proc.returncode, out[-6000:])
    return [dict(np.load(os.path.join(str(outdir), "rank%d.npz" % r)))
            for r in range(ranks)]
