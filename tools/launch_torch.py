#!/usr/bin/env python
"""Local distributed-training launcher of the PyTorch port (counterpart of
``tools/launch.py``).

Spawns N worker processes on this host with the ``DMLC_*`` rendezvous
environment that the port's ``torch.distributed`` bootstrap
(``incubator_mxnet_tpu_torch.parallel.distributed.initialize``) and its
dist KVStore read: ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` (the
coordinator), ``DMLC_NUM_WORKER``/``DMLC_WORKER_ID`` (world size, rank),
``DMLC_ROLE``/``DMLC_NUM_SERVER`` (for the reference's scripts) and
``MXNET_RESTART_COUNT`` (which attempt of the job this is).  There are no
scheduler or server roles: ``-s`` is accepted for the reference's CLI and
ignored.  This file imports neither ``jax`` nor either package.

``launch_local`` runs a job to its end, with whole-job restarts;
``spawn_workers`` starts one attempt and hands back the ranks' handles,
each rank in a session of its own, so a supervisor can poll each rank and
kill a rank with everything it started
(``incubator_mxnet_tpu_torch.parallel.supervisor.Supervisor``).

Usage::

    python tools/launch_torch.py -n 2 python train.py --kv-store dist_sync
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch_local", "spawn_workers", "worker_env", "RankProcess"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(rank: int, num_workers: int, port: int, attempt: int = 0,
               extra_env=None) -> dict:
    """The environment of rank ``rank``: this process's, plus the
    ``DMLC_*`` protocol and ``MXNET_RESTART_COUNT``, plus ``extra_env``."""
    env = dict(os.environ)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": "0",
        "DMLC_WORKER_ID": str(rank),
        "MXNET_RESTART_COUNT": str(attempt),
    })
    if extra_env:
        env.update(extra_env)
    return env


class RankProcess:
    """One rank: the ``subprocess.Popen`` liveness surface (``poll``,
    ``wait``, ``terminate``, ``kill``, ``pid``, ``returncode``).  A rank
    started in a session of its own (``group``) is signalled with its
    whole process group, so nothing it started outlives it."""

    def __init__(self, popen: subprocess.Popen, rank: int,
                 group: bool = True):
        self.popen = popen
        self.rank = int(rank)
        self.group = bool(group)

    @property
    def pid(self) -> int:
        return self.popen.pid

    @property
    def returncode(self):
        return self.popen.returncode

    def poll(self):
        return self.popen.poll()

    def wait(self, timeout=None):
        return self.popen.wait(timeout=timeout)

    def _signal_group(self, sig) -> None:
        try:
            if self.group:
                os.killpg(self.popen.pid, sig)
            else:
                self.popen.send_signal(sig)
        except (ProcessLookupError, PermissionError):
            pass

    def terminate(self) -> None:
        self._signal_group(signal.SIGTERM)

    def kill(self) -> None:
        self._signal_group(signal.SIGKILL)


def spawn_workers(num_workers: int, command, port: int | None = None,
                  extra_env=None, attempt: int = 0, new_session: bool = True,
                  **popen_kwargs):
    """Start one attempt of the job: ``command`` (a list, or a function of
    the rank that returns one) ``num_workers`` times under the ``DMLC_*``
    protocol, each rank in a session of its own unless ``new_session`` is
    false (then the ranks stay in the caller's process group, and a kill
    of that group takes them too).  Returns the ranks'
    :class:`RankProcess` handles, in rank order."""
    port = port or _free_port()
    procs = []
    for rank in range(num_workers):
        cmd = command(rank) if callable(command) else list(command)
        env = worker_env(rank, num_workers, port, attempt, extra_env)
        procs.append(RankProcess(subprocess.Popen(
            cmd, env=env, start_new_session=new_session, **popen_kwargs),
            rank, group=new_session))
    return procs


def launch_local(num_workers: int, command, port: int | None = None,
                 extra_env=None, grace: float = 20.0,
                 max_restarts: int = 0) -> int:
    """Spawn ``command`` ``num_workers`` times; return the first nonzero
    exit code (0 when every rank succeeded).

    The launcher polls the ranks: once one has died nonzero, the others
    (likely blocked in a collective with the dead peer) are terminated
    after ``grace`` seconds.  With ``max_restarts > 0`` a failed job is
    launched again whole, up to that many times, on a fresh rendezvous
    port; ``MXNET_RESTART_COUNT`` tells the ranks which attempt they are
    in, and they resume from their last checkpoint."""
    attempt = 0
    while True:
        rc = _launch_once(num_workers, command, port, extra_env, grace,
                          attempt)
        if rc == 0 or attempt >= max_restarts:
            return rc
        attempt += 1
        print("[launch] job failed (rc=%d); restart %d/%d"
              % (rc, attempt, max_restarts), file=sys.stderr, flush=True)
        port = None  # a new rendezvous


def _launch_once(num_workers: int, command, port, extra_env, grace: float,
                 attempt: int = 0) -> int:
    # the ranks stay in the launcher's process group: whoever kills the
    # launcher's session (a test's timeout) kills the ranks too
    procs = spawn_workers(num_workers, command, port, extra_env, attempt,
                          new_session=False)
    rc = 0
    failed_at = None
    try:
        while True:
            live = [p for p in procs if p.poll() is None]
            rc = rc or next((p.returncode for p in procs
                             if p.returncode not in (None, 0)), 0)
            if not live:
                break
            if rc and failed_at is None:
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > grace:
                for p in live:
                    p.terminate()
                for p in live:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                break
            time.sleep(0.2)
    except BaseException:
        # the launcher itself was stopped: take the ranks with it
        for p in procs:
            p.kill()
        raise
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch a distributed job of the PyTorch port on this "
                    "host.")
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of worker processes")
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for the reference's CLI; ignored (no "
                         "parameter servers)")
    ap.add_argument("--launcher", default="local", choices=["local"],
                    help="only local (one host, several processes)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="launch the whole job again up to N times after a "
                         "worker failure (workers resume from their last "
                         "checkpoint; MXNET_RESTART_COUNT carries the "
                         "attempt number)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="training command to run")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    return launch_local(args.num_workers, args.command,
                        max_restarts=args.max_restarts)


if __name__ == "__main__":
    sys.exit(main())
