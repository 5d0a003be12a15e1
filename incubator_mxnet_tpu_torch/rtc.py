"""Runtime-compiled CUDA kernels (port of ``incubator_mxnet_tpu/rtc.py``).

The reference contract is MXNet's ``CudaModule`` (``python/mxnet/rtc.py:42``,
compiled by NVRTC in ``src/common/rtc.cc:49``): the user hands CUDA C
source at run time and gets kernels to launch on NDArrays.  The JAX
package answered it with Pallas source (``PallasModule``, its TPU kernel
of ``_Kernel.launch``); on the card the port restores the CUDA C
contract:

- :class:`CudaModule` compiles the source with NVRTC (``libnvrtc``,
  reached through ``ctypes``) for the card's architecture (``sm_90a`` on
  an H100), takes the CUBIN, and loads it with the driver API
  (``libcuda.so.1``: ``cuModuleLoadData``, ``cuModuleGetFunction``) into
  torch's primary context, one module per device.
- :meth:`CudaModule.get_kernel` parses MXNet's signature grammar,
  ``const? type *? name?`` per argument, over ``float``, ``double``,
  ``__half``, ``uint8_t``, ``int``, ``int32_t``, ``int8_t``, ``char`` and
  ``int64_t``.
- :meth:`CudaKernel.launch` runs on the current stream with
  ``cuLaunchKernel``.  Pointer arguments are NDArrays on the launch
  device whose dtype matches the signature; a non-const pointer is an
  output, which the kernel writes in place.  Each kernel counts its
  launches.

Nothing here runs on the CPU: a CPU ``ctx`` or a CPU array raises, and
nothing falls back.  No library is looked up at import, so the module
imports on a host without NVRTC.

The two user kernels of the JAX package's own rtc tests,
``scale_kernel`` and ``mm_kernel`` (``tests/test_subgraph_rtc.py``), are
kept as CUDA C under ``csrc/rtc/`` (R1 and R2), with their plain
versions :func:`scale_plain` and :func:`mm_plain` beside them here.
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "parse_signature",
           "USER_KERNELS", "user_source", "scale_plain", "mm_plain",
           "launch_scale", "launch_mm"]

# ---------------------------------------------------------------------------
# the signature grammar (python/mxnet/rtc.py)
# ---------------------------------------------------------------------------

#: C type -> (torch dtype, ctypes type of a scalar argument)
_C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")


class _Arg:
    __slots__ = ("ctype", "dtype", "is_pointer", "is_const", "name")

    def __init__(self, ctype, is_pointer, is_const, name):
        self.ctype = ctype
        self.dtype = _C_TYPES[ctype][0]
        self.is_pointer = is_pointer
        self.is_const = is_const
        self.name = name

    def __repr__(self):
        return "%s%s%s %s" % ("const " if self.is_const else "", self.ctype,
                              " *" if self.is_pointer else "", self.name)


def parse_signature(signature):
    """``[_Arg]`` of a kernel signature such as ``"const float *x, float
    *y, int n"``.  Raises ValueError on a malformed argument and TypeError
    on a type outside the grammar."""
    args = []
    for text in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(text)
        if not m or m.group(2) == "const":
            raise ValueError('invalid kernel argument "%s": must be '
                             '"(const) type (*) (name)"' % text.strip())
        const, ctype, star, name = m.groups()
        if ctype not in _C_TYPES:
            raise TypeError("unsupported kernel argument type %r in %r; "
                            "supported: %s" % (ctype, text.strip(),
                                               ", ".join(_C_TYPES)))
        args.append(_Arg(ctype, bool(star), bool(const), name or ""))
    return args


# ---------------------------------------------------------------------------
# NVRTC and the driver API through ctypes, loaded at first use
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_libs = {}


def _cuda_home():
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"


def _nvrtc_candidates():
    dirs = [os.path.join(_cuda_home(), "lib64"), "/usr/local/cuda/lib64"]
    dirs += [os.path.join(p, "nvidia", "cuda_nvrtc", "lib") for p in sys.path
             if p]
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "libnvrtc.so*"))):
            yield path


def _declare(lib, table):
    for name, (restype, argtypes) in table.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_SZ = ctypes.POINTER(ctypes.c_size_t)
_I = ctypes.c_int
_U = ctypes.c_uint

_NVRTC_API = {
    "nvrtcGetErrorString": (ctypes.c_char_p, [_I]),
    "nvrtcCreateProgram": (_I, [_PP, ctypes.c_char_p, ctypes.c_char_p, _I,
                                ctypes.POINTER(ctypes.c_char_p),
                                ctypes.POINTER(ctypes.c_char_p)]),
    "nvrtcAddNameExpression": (_I, [_P, ctypes.c_char_p]),
    "nvrtcCompileProgram": (_I, [_P, _I, ctypes.POINTER(ctypes.c_char_p)]),
    "nvrtcGetProgramLogSize": (_I, [_P, _SZ]),
    "nvrtcGetProgramLog": (_I, [_P, ctypes.c_char_p]),
    "nvrtcGetCUBINSize": (_I, [_P, _SZ]),
    "nvrtcGetCUBIN": (_I, [_P, ctypes.c_char_p]),
    "nvrtcGetLoweredName": (_I, [_P, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_char_p)]),
    "nvrtcDestroyProgram": (_I, [_PP]),
}

_CUDA_API = {
    "cuInit": (_I, [_U]),
    "cuGetErrorString": (_I, [_I, ctypes.POINTER(ctypes.c_char_p)]),
    "cuDeviceGet": (_I, [ctypes.POINTER(_I), _I]),
    "cuDevicePrimaryCtxRetain": (_I, [_PP, _I]),
    "cuCtxSetCurrent": (_I, [_P]),
    "cuModuleLoadData": (_I, [_PP, _P]),
    "cuModuleGetFunction": (_I, [_PP, _P, ctypes.c_char_p]),
    "cuFuncSetAttribute": (_I, [_P, _I, _I]),
    "cuLaunchKernel": (_I, [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP]),
}

_CUDA_ERROR_NOT_FOUND = 500
_NVRTC_ERROR_NAME_EXPRESSION_NOT_VALID = 10
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8


def _nvrtc():
    with _lock:
        if "nvrtc" not in _libs:
            tried = []
            for path in _nvrtc_candidates():
                tried.append(path)
                try:
                    lib = ctypes.CDLL(path)
                except OSError:
                    continue
                _declare(lib, _NVRTC_API)
                _libs["nvrtc"] = lib
                break
            else:
                raise RuntimeError(
                    "libnvrtc not found (looked in $CUDA_HOME/lib64, "
                    "/usr/local/cuda/lib64 and the nvidia/cuda_nvrtc wheel; "
                    "tried %s): rtc compiles CUDA C with NVRTC" % tried)
        return _libs["nvrtc"]


def _cuda():
    with _lock:
        if "cuda" not in _libs:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise RuntimeError("the CUDA driver (libcuda.so.1) is not "
                                   "loadable: %s" % e) from None
            _declare(lib, _CUDA_API)
            _check_cu(lib, lib.cuInit(0), "cuInit")
            _libs["cuda"] = lib
        return _libs["cuda"]


def _check_cu(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        raise RuntimeError("%s failed: CUDA error %d (%s)" % (
            what, res, (msg.value or b"?").decode()))


def _check_nvrtc(lib, res, what, log=""):
    if res != 0:
        raise RuntimeError("%s failed: %s%s" % (
            what, lib.nvrtcGetErrorString(res).decode(),
            "\n" + log if log else ""))


def _require_card(what):
    if not torch.cuda.is_available():
        raise RuntimeError("%s needs a CUDA card, and there is none: rtc "
                           "kernels are CUDA C and cannot run on the CPU"
                           % what)


def _arch(device):
    major, minor = torch.cuda.get_device_capability(device)
    # Hopper's wgmma/setmaxnreg need the arch-specific target
    return "sm_%d%d%s" % (major, minor, "a" if (major, minor) == (9, 0)
                          else "")


def _program(lib, source, options, exports, device):
    """An NVRTC program of ``source`` with ``exports`` as name expressions,
    compiled: ``(program, result code, compile log)``.  The caller destroys
    the program."""
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                         "nvrtcAddNameExpression(%s)" % name)
    except RuntimeError:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
        raise
    opts = ["--gpu-architecture=%s" % _arch(device),
            "-I%s" % os.path.join(_cuda_home(), "include"), *options]
    copts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
    res = lib.nvrtcCompileProgram(prog, len(opts), copts)
    size = ctypes.c_size_t()
    lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
    log = ctypes.create_string_buffer(size.value + 1)
    lib.nvrtcGetProgramLog(prog, log)
    return prog, res, "NVRTC compile (%s)" % " ".join(opts), \
        log.value.decode(errors="replace")


def _unresolved(lib, source, options, exports, device):
    """The exports whose name expression alone breaks the compile of a
    ``source`` that compiles without them; [] if ``source`` itself does
    not compile."""
    def compiles(names):
        prog, res, _, _ = _program(lib, source, options, names, device)
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
        return res == 0

    if not compiles(()):
        return []
    return [name for name in exports if not compiles((name,))]


def _compile(source, options, exports, device):
    """CUBIN bytes and ``{export: lowered name}`` of ``source``.  An export
    NVRTC cannot resolve raises ValueError."""
    lib = _nvrtc()
    prog, res, what, log = _program(lib, source, options, exports, device)
    try:
        if res != 0 and exports:
            bad = _unresolved(lib, source, options, exports, device)
            if bad:
                raise ValueError("export(s) %s not defined in source: NVRTC "
                                 "cannot resolve the name\n%s" % (bad, log))
        _check_nvrtc(lib, res, what, log)
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            res = lib.nvrtcGetLoweredName(prog, name.encode(),
                                          ctypes.byref(out))
            if res == _NVRTC_ERROR_NAME_EXPRESSION_NOT_VALID:
                raise ValueError("export %r not defined in source: NVRTC "
                                 "has no lowered name for it" % name)
            _check_nvrtc(lib, res, "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = out.value.decode()
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


_primary = {}


def _make_current(lib, index):
    """Make torch's primary context of device ``index`` current on this
    thread (retained once per device, for the life of the process)."""
    with _lock:
        ctx = _primary.get(index)
        if ctx is None:
            torch.cuda.init()
            dev = ctypes.c_int()
            _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), index),
                      "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                        dev),
                      "cuDevicePrimaryCtxRetain")
            _primary[index] = ctx
    _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


# ---------------------------------------------------------------------------
# modules and kernels
# ---------------------------------------------------------------------------


def _device(ctx):
    """The CUDA ``torch.device`` of a launch; a CPU ctx raises."""
    dev = torch.device(ctx) if not isinstance(ctx, torch.device) else ctx
    if dev.type != "cuda":
        raise RuntimeError("rtc kernels run on a CUDA card; ctx %s is not "
                           "one (there is no CPU path)" % dev)
    _require_card("an rtc launch")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


class CudaModule:
    """CUDA C source compiled by NVRTC (``mx.rtc.CudaModule``).

    ``options`` are extra NVRTC options; ``exports`` the kernel names to
    look up through NVRTC's name expressions (needed for C++ names; an
    ``extern "C"`` kernel needs none).  ``compile_ms`` is the NVRTC
    compile's time."""

    def __init__(self, source: str, options=(), exports=()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        for name in self.exports:
            # a quick lexical check that needs no card; NVRTC has the last
            # word.  The kernel's own identifier: "ns::axpy<float>" names axpy
            ident = re.split(r"[<(]", name)[0].split("::")[-1].strip()
            if not ident or not re.search(r"\b%s\b" % re.escape(ident),
                                          source):
                raise ValueError("export %r not defined in source" % name)
        _require_card("rtc.CudaModule")
        device = torch.device("cuda", torch.cuda.current_device())
        t0 = time.perf_counter()
        self._cubin, self._lowered = _compile(source, self.options,
                                              self.exports, device)
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self._modules = {}
        self._functions = {}
        self._mod_lock = threading.Lock()

    def _function(self, device, name):
        """The ``CUfunction`` of kernel ``name`` on ``device``, with the
        device's primary context made current; raises ValueError if the
        module has no such kernel.  The module loads once per device."""
        lib = _cuda()
        _make_current(lib, device.index)
        with self._mod_lock:
            fn = self._functions.get((device.index, name))
            if fn is not None:
                return fn
            mod = self._modules.get(device.index)
            if mod is None:
                mod = ctypes.c_void_p()
                _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod),
                                                    self._cubin),
                          "cuModuleLoadData")
                self._modules[device.index] = mod
            fn = ctypes.c_void_p()
            res = lib.cuModuleGetFunction(
                ctypes.byref(fn), mod, self._lowered.get(name, name).encode())
            if res == _CUDA_ERROR_NOT_FOUND:
                raise ValueError("kernel %r not found in the module" % name)
            _check_cu(lib, res, "cuModuleGetFunction(%s)" % name)
            self._functions[(device.index, name)] = fn
            return fn

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """Kernel ``name`` with its C ``signature``; a name the module does
        not define raises ValueError."""
        args = parse_signature(signature)
        self._function(torch.device("cuda", torch.cuda.current_device()),
                       name)
        return CudaKernel(self, name, args)


class CudaKernel:
    """A launchable kernel of a :class:`CudaModule`, with its launch
    count."""

    def __init__(self, module, name, args):
        self.module = module
        self.name = name
        self.args = list(args)
        self.launches = 0

    def _pack(self, args, device):
        """The ``void*`` array of ``cuLaunchKernel`` and the objects it
        points into (kept alive until the launch returns)."""
        if len(args) != len(self.args):
            raise ValueError("kernel %s takes %d arguments (%s), got %d"
                             % (self.name, len(self.args), self.args,
                                len(args)))
        from .ndarray import NDArray

        holders = []
        for i, (a, spec) in enumerate(zip(args, self.args)):
            if spec.is_pointer:
                if not isinstance(a, NDArray):
                    raise TypeError("argument %d (%s) of %s must be an "
                                    "NDArray, got %s" % (i, spec, self.name,
                                                         type(a)))
                t = a._data
                if t.device != device:
                    raise RuntimeError(
                        "argument %d (%s) of %s is on %s, the launch on %s: "
                        "rtc kernels take CUDA arrays" % (i, spec, self.name,
                                                          t.device, device))
                if t.dtype != spec.dtype:
                    raise TypeError("argument %d (%s) of %s must be %s, got "
                                    "%s" % (i, spec, self.name, spec.dtype,
                                            t.dtype))
                if not t.is_contiguous():
                    if not spec.is_const:
                        raise ValueError("output argument %d (%s) of %s "
                                         "must be contiguous"
                                         % (i, spec, self.name))
                    t = t.contiguous()
                holders.append((t, ctypes.c_void_p(t.data_ptr())))
            else:
                if isinstance(a, NDArray):
                    raise TypeError("argument %d (%s) of %s is a scalar, got "
                                    "an NDArray" % (i, spec, self.name))
                ctype = _C_TYPES[spec.ctype][1]
                if spec.ctype == "__half":
                    holders.append((None, ctype(int(
                        np.float16(a).view(np.uint16)))))
                elif spec.dtype.is_floating_point:
                    holders.append((None, ctype(float(a))))
                else:
                    holders.append((None, ctype(int(a))))
        params = (ctypes.c_void_p * len(holders))(
            *[ctypes.addressof(v) for _, v in holders])
        return params, holders

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx``'s current stream with MXNet's geometry (three
        grid and three block dimensions).  A CPU ``ctx`` or a CPU array
        raises; so does a dtype that does not match the signature."""
        device = _device(ctx)
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise ValueError("grid_dims and block_dims take 3 values each")
        # cuLaunchKernel copies the argument values; a temporary contiguous
        # input stays valid because its memory returns to torch's pool on
        # this same stream
        params, holders = self._pack(args, device)
        lib = _cuda()
        fn = self.module._function(device, self.name)
        if shared_mem > 48 * 1024:
            _check_cu(lib, lib.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), "cuFuncSetAttribute(%s)" % self.name)
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_cu(lib, lib.cuLaunchKernel(
            fn, *[int(g) for g in grid_dims], *[int(b) for b in block_dims],
            int(shared_mem), ctypes.c_void_p(stream), params, None),
            "cuLaunchKernel(%s)" % self.name)
        self.launches += 1


class PallasModule:
    """The JAX package's Pallas runtime has no counterpart here: Pallas
    source cannot run on the card.  Use :class:`CudaModule` with CUDA C."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "rtc.PallasModule compiles Pallas for the TPU; the port's "
            "runtime kernels are CUDA C: use rtc.CudaModule")


# ---------------------------------------------------------------------------
# R1 and R2: the user kernels of the JAX package's rtc tests, in CUDA C
# ---------------------------------------------------------------------------

_RTC_DIR = Path(__file__).resolve().parent / "csrc" / "rtc"

#: name -> C signature of the sources under csrc/rtc/
USER_KERNELS = {
    "scale_kernel": "const float *x, float *y, int n",
    "mm_kernel": "const float *a, const float *b, float *c, int M, int N, "
                 "int K",
}
#: mm_kernel's tile of C per block, threads per block and dynamic shared
#: memory: the #defines MM_TILE, MM_THREADS and MM_SMEM_BYTES of
#: csrc/rtc/mm_kernel.cu (3 stages of a 128 x 16 A slice at a pitch of 20
#: floats and a 16 x 128 B slice at a pitch of 136)
MM_TILE = 128
MM_THREADS = 256
MM_SMEM_BYTES = 3 * (128 * 20 + 16 * 136) * 4


def user_source(name):
    """The CUDA C text of ``csrc/rtc/<name>.cu``."""
    return (_RTC_DIR / (name + ".cu")).read_text()


def scale_plain(x):
    """R1's plain version: ``2x + 1``."""
    return x * 2 + 1


def mm_plain(a, b):
    """R2's plain version: ``a @ b``."""
    return a @ b


def launch_scale(kernel, x, ctx):
    """``y = 2x + 1`` through R1: one thread an element, 256 a block."""
    from .ndarray import NDArray

    y = NDArray(torch.empty_like(x._data,
                                 memory_format=torch.contiguous_format))
    n = x.size
    kernel.launch([x, y, n], ctx, (max(1, -(-n // 256)), 1, 1), (256, 1, 1))
    return y


def launch_mm(kernel, a, b, ctx):
    """``a @ b`` of 2-D float32 arrays through R2."""
    from .ndarray import NDArray

    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("mm_kernel takes (M, K) @ (K, N), got %s @ %s"
                         % (a.shape, b.shape))
    m, k = a.shape
    n = b.shape[1]
    c = NDArray(torch.empty((m, n), dtype=a._data.dtype,
                            device=a._data.device))
    kernel.launch([a, b, c, m, n, k], ctx,
                  (-(-n // MM_TILE), -(-m // MM_TILE), 1),
                  (MM_THREADS, 1, 1), shared_mem=MM_SMEM_BYTES)
    return c
