"""The asynchronous parameter host of ``dist_async`` (port of
``incubator_mxnet_tpu/kvstore/async_host.py``; the reference's
``src/kvstore/kvstore_dist_server.h:155``).

The server takes each worker's push with no barrier and applies the
update at once (``ApplyUpdates``, its async branch: no aggregation across
workers, first come first served), and serves a pull with whatever value
it holds then; workers run at unequal step counts.  Rank 0 runs this
host in a thread: a TCP server speaking length-prefixed pickle, holding
float32 parameter state behind a lock per key, with an optional
server-side optimizer (``set_optimizer`` ships the pickled optimizer, the
reference's ``kController`` command).

Wire ops: ``INIT`` (the first writer wins), ``PUSH`` (apply the update
now), ``PULL``, ``SET_OPT``, ``CMD`` (a command for the server's
controller), ``STOP``.

Trust model: the wire is pickle, so only processes that trust each other
may share it, as in the reference's ps-lite deployment.  The host binds
the loopback address unless told otherwise.  Messages are bounded
(``_MAX_MSG``) and the state is strictly float32: a push or init of
another dtype is refused, never cast, so mixed-precision trainers keep
their f32 master weights on the worker.  The reference's server profiler
command (``CMD`` head 5) needs a profiler module, which the port does not
have yet: the host refuses it.
"""
from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Any, Dict

import numpy as np

from ..base import dtype_name

__all__ = ["AsyncParamHost", "AsyncParamClient"]


def _int_key(key) -> int:
    try:
        return int(key)
    except (TypeError, ValueError):
        return zlib.crc32(str(key).encode()) % (1 << 31)


_HDR = struct.Struct("<I")
# one message holds one tensor (and a little framing); 1 GiB bounds the
# memory of a connection and refuses corrupted length prefixes
_MAX_MSG = 1 << 30

#: ``CMD`` head of the reference's server profiler command
_CMD_PROFILER = 5


def _send(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > _MAX_MSG:
        raise ValueError("async-host message of %d bytes exceeds the %d "
                         "byte bound" % (len(payload), _MAX_MSG))
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv(sock: socket.socket) -> Any:
    hdr = b""
    while len(hdr) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    if n > _MAX_MSG:
        raise ConnectionError(
            "async-host frame of %d bytes exceeds the %d byte bound "
            "(corrupted stream?)" % (n, _MAX_MSG))
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return pickle.loads(bytes(buf))


def _nd(arr):
    """A float32 array as the port's NDArray on the CPU (the optimizer's
    ``update`` takes NDArrays)."""
    import torch

    from ..ndarray import NDArray

    return NDArray(torch.from_numpy(np.array(arr, np.float32)))


class AsyncParamHost:
    """The parameter host thread of rank 0."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._values: Dict[str, np.ndarray] = {}
        self._states: Dict[str, Any] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._global_lock = threading.Lock()
        self._optimizer = None
        self._controller = None
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: A003
                try:
                    while True:
                        msg = _recv(self.request)
                        if msg[0] == "STOP":
                            _send(self.request, ("OK",))
                            outer._server.shutdown()
                            return
                        try:
                            res = outer._handle(msg)
                        except Exception as e:  # noqa: BLE001 - to client
                            res = ("ERR", "%s: %s" % (type(e).__name__, e))
                        _send(self.request, res)
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="mx-async-param-host")
        self._thread.start()

    def _lock(self, key: str) -> threading.Lock:
        with self._global_lock:
            return self._locks.setdefault(key, threading.Lock())

    @staticmethod
    def _check_f32(tag, key, arr):
        """``arr`` (an array or a tensor) as a float32 numpy array;
        any other dtype is refused, never cast."""
        tensor = hasattr(arr, "detach")
        if not tensor:
            arr = np.asarray(arr)
        name = dtype_name(arr.dtype) if tensor else arr.dtype.name
        if name != "float32":
            raise TypeError(
                "%s for key %r carries dtype %s; the async parameter host "
                "stores float32 only (kvstore_dist_server.h real_t) — cast "
                "on the worker (mixed-precision trainers keep their f32 "
                "master copy there)" % (tag, key, name))
        return arr.detach().cpu().numpy() if tensor else arr

    def _handle(self, msg):
        op = msg[0]
        if op == "INIT":
            _, key, val = msg
            val = self._check_f32("INIT", key, val)
            with self._lock(key):
                if key not in self._values:  # the first writer wins
                    self._values[key] = val.copy()
            return ("OK",)
        if op == "PUSH":
            _, key, grad = msg
            grad = self._check_f32("PUSH", key, grad)
            with self._lock(key):
                if key not in self._values:
                    return ("ERR", "key %r has not been initialized" % key)
                w = self._values[key]
                if self._optimizer is not None:
                    idx = _int_key(key)
                    st = self._states.get(key)
                    if st is None:
                        st = self._optimizer.create_state_multi_precision(
                            idx, _nd(w))
                        self._states[key] = st
                    wnd = _nd(w)
                    self._optimizer.update_multi_precision(
                        idx, wnd, _nd(grad), st)
                    self._values[key] = wnd.asnumpy()
                else:
                    # no optimizer: accumulate, the reference server's
                    # default merge
                    self._values[key] = w + grad
            return ("OK",)
        if op == "PULL":
            _, key = msg
            with self._lock(key):
                if key not in self._values:
                    return ("ERR", "key %r has not been initialized" % key)
                return ("OK", self._values[key].copy())
        if op == "SET_OPT":
            _, blob = msg
            self._optimizer = pickle.loads(blob)
            return ("OK",)
        if op == "CMD":
            # MXKVStoreSendCommmandToServers: (head, body) to the server's
            # controller (kvstore_dist_server.h CommandHandle)
            _, head, body = msg
            if int(head) == _CMD_PROFILER:
                raise NotImplementedError(
                    "the server profiler command needs a profiler module, "
                    "which the port does not have")
            if self._controller is not None:
                self._controller(int(head), body)
            return ("OK",)
        return ("ERR", "unknown op %r" % (op,))

    def set_controller(self, controller):
        self._controller = controller

    def stop(self):
        try:
            self._server.shutdown()
        finally:
            self._server.server_close()


class AsyncParamClient:
    """One worker's connection to the parameter host."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        t0 = time.time()
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=10)
                break
            except OSError as e:  # the host thread may not be up yet
                if time.time() - t0 > timeout:
                    raise ConnectionError(
                        "async param host %s:%d unreachable: %s"
                        % (host, port, e))
                time.sleep(0.1)
        self._lock = threading.Lock()

    def _call(self, *msg):
        with self._lock:
            _send(self._sock, msg)
            res = _recv(self._sock)
        if res[0] != "OK":
            raise RuntimeError("async param host error: %r" % (res,))
        return res

    def init(self, key: str, value) -> None:
        self._call("INIT", key, AsyncParamHost._check_f32("INIT", key,
                                                          value))

    def push(self, key: str, grad) -> None:
        # no silent up-cast: a bf16/f16 push is a caller's bug (the f32
        # master copy lives on the worker) and fails here
        self._call("PUSH", key, AsyncParamHost._check_f32("PUSH", key,
                                                          grad))

    def pull(self, key: str) -> np.ndarray:
        return self._call("PULL", key)[1]

    def set_optimizer(self, optimizer) -> None:
        self._call("SET_OPT", pickle.dumps(optimizer))

    def send_command(self, head: int, body: str) -> None:
        self._call("CMD", int(head), body)

    def stop_host(self) -> None:
        try:
            self._call("STOP")
        except (RuntimeError, ConnectionError):
            pass

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
