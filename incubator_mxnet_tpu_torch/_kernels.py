"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use, one ``nvcc``
process per source, all started together, and linked by one more into a
shared library with a plain C interface
(``build/torch_kernels/libmxnet_tpu_torch_<hash>.so`` at the repository
root, keyed by a hash of the sources and flags) and loaded with
``ctypes``.  Every pointer and the stream cross as ``c_void_p``; every C
entry returns ``cudaGetLastError()`` and :meth:`Kernel.launch` raises when
it is non-zero.  Each kernel keeps a plain integer launch counter that
only :meth:`Kernel.launch` advances.

Nothing here runs at import: the CPU tests import every module, and this
host may have no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "build", "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_SOURCES = ("ghost_bn.cu", "maxpool_idx.cu", "flash_attention.cu")
_BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry name -> argtypes (see the ``extern "C"`` functions in csrc/)
_SIGNATURES = {
    # dtype, x, r, gamma, beta, y, mean, var, G, C, HW, ng, eps, relu, stream
    "ghost_bn_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # dtype, gy, gy2, x, y, gamma, beta, mean, var, dx, dr, dg, db,
    # G, C, HW, ng, eps, relu, stream
    "ghost_bn_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _F, _I, _P],
    # dtype, x, out, idx, N, C, H, W, OH, OW, kh, kw, sh, sw, ph, pw, stream
    "maxpool_idx_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    # dtype, q, k, v, out, lse, BH, Sq, Sk, D, scale, causal, stream
    "flash_attn_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # dtype, q, k, v, dout, lse, delta, dq, BH, Sq, Sk, D, scale, causal,
    # stream
    "flash_attn_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _I, _P],
    # dtype, q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, D, scale,
    # causal, stream
    "flash_attn_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from csrc/ at "
                       "first use")


def _library_path():
    h = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / ("libmxnet_tpu_torch_%s.so" % h.hexdigest()[:12])


def _run(procs):
    """Wait for every ``(cmd, Popen)``; raise on the first that failed."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = "%s failed (%d):\n%s\n%s" % (" ".join(cmd),
                                                 proc.returncode, out, err)
    if failed:
        raise RuntimeError(failed)


def _compile(path):
    """One ``nvcc -c`` per source, all at once, then one link into
    ``path`` (written under a temporary name and renamed)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "%s.%d" % (path.stem, os.getpid())
    objs = [_BUILD_DIR / ("%s.%s.o" % (tag, Path(s).stem)) for s in _SOURCES]
    nvcc = _nvcc()
    cmds = [[nvcc, *_NVCC_FLAGS, "-c", str(_CSRC / s), "-o", str(o)]
            for s, o in zip(_SOURCES, objs)]
    try:
        _run([(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
              for c in cmds])
        tmp = path.with_suffix(".%d.tmp" % os.getpid())
        link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp),
                *[str(o) for o in objs]]
        _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, path)
    finally:
        for o in objs:
            if o.exists():
                o.unlink()


def build():
    """Compile the kernels (if the library for these sources is missing)
    and load them.  Returns the seconds spent building (0.0 when the
    library was already there)."""
    global _lib
    with _lock:
        if _lib is not None:
            return 0.0
        path = _library_path()
        seconds = 0.0
        if not path.exists():
            t0 = time.perf_counter()
            _compile(path)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return seconds


class Kernel:
    """One C entry of the library plus its launch counter."""

    def __init__(self, name):
        self.name = name
        self.launches = 0

    def launch(self, device, *args):
        """Launch on ``device``'s current stream; ``args`` are the C
        arguments before the trailing stream.  Raises if the launch was
        refused."""
        if _lib is None:
            build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(_lib, self.name)(*args, stream)
        if err != 0:
            raise RuntimeError("%s launch failed: CUDA error %d" % (self.name,
                                                                     err))
        self.launches += 1


KERNELS = {name: Kernel(name) for name in _SIGNATURES}


def launch_counts():
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0
