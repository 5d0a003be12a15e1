"""``mx.np.linalg`` (port of ``incubator_mxnet_tpu/numpy/linalg.py``):
NumPy's linear algebra in ``torch.linalg`` on the arrays' device
(cuSOLVER on the card), returning NDArrays.  As in the reference these
calls do not record on the autograd tape.  Integer inputs compute in
their inexact type (``base.np_inexact``).  Factors with a sign or phase
freedom (``svd``, ``qr``, ``eig``, ``eigh``) are the solver's.
"""
from __future__ import annotations

import functools

import torch

from ..base import np_inexact

_NAMES = ["norm", "svd", "cholesky", "qr", "inv", "det", "slogdet", "solve",
          "lstsq", "pinv", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
          "matrix_power", "multi_dot", "tensorinv", "tensorsolve", "cond"]

__all__ = list(_NAMES)


def _f(x):
    return x.to(np_inexact(x.dtype))


def _norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    return torch.linalg.norm(_f(x), ord=ord, dim=axis, keepdim=keepdims)


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    if not compute_uv:
        return torch.linalg.svdvals(_f(a))
    return tuple(torch.linalg.svd(_f(a), full_matrices=full_matrices))


def _qr(a, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(_f(a), mode="r")[1]
    return tuple(torch.linalg.qr(_f(a), mode=mode))


def _slogdet(a):
    return tuple(torch.linalg.slogdet(_f(a)))


def _solve(a, b):
    from ..ops.npi import _solve as solve

    return solve(a, b)


def _lstsq(a, b, rcond=None):
    """(solution, sums of squared residuals, rank, singular values), the
    residuals empty unless the system is overdetermined and of full
    rank, as NumPy's."""
    a, b = _f(a), _f(b).to(np_inexact(a.dtype))
    vec = b.ndim == 1
    bb = b.unsqueeze(-1) if vec else b
    x = torch.linalg.pinv(a, rtol=rcond) @ bb
    s = torch.linalg.svdvals(a)
    m, n = a.shape
    rank = torch.linalg.matrix_rank(a, rtol=rcond)
    if m > n and int(rank) == n:
        resid = torch.sum(torch.square(bb - a @ x), dim=0)
    else:
        resid = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return (x.squeeze(-1) if vec else x), resid, rank, s


def _eig(a):
    return tuple(torch.linalg.eig(_f(a)))


def _eigh(a, UPLO="L", symmetrize_input=True):  # noqa: N803
    a = _f(a)
    if symmetrize_input:
        a = (a + a.transpose(-1, -2)) / 2
    return tuple(torch.linalg.eigh(a, UPLO=UPLO))


def _eigvalsh(a, UPLO="L"):  # noqa: N803
    return torch.linalg.eigvalsh(_f(a), UPLO=UPLO)


def _matrix_rank(M, rtol=None, tol=None):  # noqa: N803
    out = torch.linalg.matrix_rank(_f(M), atol=tol, rtol=rtol)
    return out


def _tensorsolve(a, b, axes=None):
    return torch.linalg.tensorsolve(_f(a), _f(b), dims=axes)


def _cond(x, p=None):
    return torch.linalg.cond(_f(x), p=p)


_IMPL = {
    "norm": _norm, "svd": _svd,
    "cholesky": lambda a, **kw: torch.linalg.cholesky(_f(a)),
    "qr": _qr, "inv": lambda a: torch.linalg.inv(_f(a)),
    "det": lambda a: torch.linalg.det(_f(a)), "slogdet": _slogdet,
    "solve": _solve, "lstsq": _lstsq,
    "pinv": lambda a, rtol=None, hermitian=False, **kw: torch.linalg.pinv(
        _f(a), rtol=kw.get("rcond", rtol), hermitian=hermitian),
    "eig": _eig, "eigh": _eigh,
    "eigvals": lambda a: torch.linalg.eigvals(_f(a)),
    "eigvalsh": _eigvalsh, "matrix_rank": _matrix_rank,
    "matrix_power": lambda a, n: torch.linalg.matrix_power(a, int(n)),
    "multi_dot": lambda arrays, **kw: torch.linalg.multi_dot(
        [_f(a) for a in arrays]),
    "tensorinv": lambda a, ind=2: torch.linalg.tensorinv(_f(a), ind=ind),
    "tensorsolve": _tensorsolve, "cond": _cond,
}


def _make(name):
    impl = _IMPL[name]

    @functools.wraps(impl)
    def fn(*args, **kwargs):
        from . import _dispatch

        return _dispatch(name, impl, False)(*args, **kwargs)

    fn.__name__ = name
    return fn


for _n in _NAMES:
    globals()[_n] = _make(_n)
del _n
