"""Linear-algebra operators, the ``la_op`` family (port of
``incubator_mxnet_tpu/ops/linalg.py``; the reference's
``src/operator/tensor/la_op.cc``): ``gemm``, ``gemm2``, ``potrf``,
``potri``, ``trmm``, ``trsm``, ``syrk``, ``gelqf``, ``syevd``,
``sumlogdiag``, ``extractdiag``/``makediag``, ``extracttrian``/
``maketrian``, ``inverse``, ``det``, ``slogdet``, and ``einsum`` and
``tensordot``.

Every op works on the last two axes with any leading batch axes.  The
reference computes them with ``jnp.linalg`` outside any Pallas kernel;
here ``torch.linalg`` and ``torch.matmul`` do (cuSOLVER and cuBLAS on the
card), and their gradients are PyTorch's.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _tr(x, do):
    return x.transpose(-1, -2) if do else x


@register("_linalg_gemm", num_inputs=3, aliases=("linalg_gemm",))
def _gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,  # noqa: N803
          beta=1.0, axis=-2):
    """``alpha * op(A) @ op(B) + beta * C``; ``axis`` names the matrices'
    row axis."""
    A, B, C = (x.movedim(axis, -2) for x in (A, B, C))
    out = alpha * torch.matmul(_tr(A, transpose_a), _tr(B, transpose_b))
    return (out + beta * C).movedim(-2, axis)


@register("_linalg_gemm2", num_inputs=2, aliases=("linalg_gemm2",))
def _gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,  # noqa: N803
           axis=-2):
    """``alpha * op(A) @ op(B)``."""
    A, B = A.movedim(axis, -2), B.movedim(axis, -2)
    out = alpha * torch.matmul(_tr(A, transpose_a), _tr(B, transpose_b))
    return out.movedim(-2, axis)


@register("_linalg_potrf", num_inputs=1, aliases=("linalg_potrf",))
def _potrf(A):  # noqa: N803
    """The lower Cholesky factor ``L`` of an SPD matrix, ``A = L Lᵀ``."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", num_inputs=1, aliases=("linalg_potri",))
def _potri(A):  # noqa: N803
    """``(L Lᵀ)⁻¹`` from the Cholesky factor ``L`` given."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("_linalg_trmm", num_inputs=2, aliases=("linalg_trmm",))
def _trmm(A, B, transpose=False, rightside=False, lower=True,  # noqa: N803
          alpha=1.0):
    """``alpha * op(tri(A)) @ B`` (``B @ op(tri(A))`` with ``rightside``)."""
    tri = _tr(torch.tril(A) if lower else torch.triu(A), transpose)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("_linalg_trsm", num_inputs=2, aliases=("linalg_trsm",))
def _trsm(A, B, transpose=False, rightside=False, lower=True,  # noqa: N803
          alpha=1.0):
    """``X`` with ``op(tri(A)) X = alpha B`` (``X op(tri(A)) = alpha B``
    with ``rightside``); only the triangle named by ``lower`` is read."""
    tri, upper = (A.transpose(-1, -2), lower) if transpose else (A, not lower)
    return torch.linalg.solve_triangular(tri, alpha * B, upper=upper,
                                         left=not rightside)


@register("_linalg_syrk", num_inputs=1, aliases=("linalg_syrk",))
def _syrk(A, transpose=False, alpha=1.0):  # noqa: N803
    """``alpha * A Aᵀ`` (``alpha * Aᵀ A`` with ``transpose``)."""
    At = A.transpose(-1, -2)
    return alpha * (torch.matmul(At, A) if transpose
                    else torch.matmul(A, At))


@register("_linalg_gelqf", num_inputs=1, num_outputs=2,
          aliases=("linalg_gelqf",))
def _gelqf(A):  # noqa: N803
    """``(L, Q)`` with ``A = L Q``, Q's rows orthonormal (m <= n) and
    ``diag(L) >= 0`` (LAPACK's form, as the reference)."""
    q, r = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    L, Q = r.transpose(-1, -2), q.transpose(-1, -2)
    d = torch.sign(torch.diagonal(L, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return L * d[..., None, :], Q * d[..., :, None]


@register("_linalg_syevd", num_inputs=1, num_outputs=2,
          aliases=("linalg_syevd",))
def _syevd(A):  # noqa: N803
    """``(U, lam)`` with ``A = Uᵀ diag(lam) U``: U's rows are the
    eigenvectors, ``lam`` ascending."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w


@register("_linalg_sumlogdiag", num_inputs=1, aliases=("linalg_sumlogdiag",))
def _sumlogdiag(A):  # noqa: N803
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("_linalg_extractdiag", num_inputs=1,
          aliases=("linalg_extractdiag",))
def _extractdiag(A, offset=0):  # noqa: N803
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("_linalg_makediag", num_inputs=1, aliases=("linalg_makediag",))
def _makediag(d, offset=0):
    return torch.diag_embed(d, offset=offset)


def _trian_indices(n, offset, lower, device):
    return torch.tril_indices(n, n, offset, device=device) if lower \
        else torch.triu_indices(n, n, offset, device=device)


@register("_linalg_extracttrian", num_inputs=1,
          aliases=("linalg_extracttrian",))
def _extracttrian(A, offset=0, lower=True):  # noqa: N803
    """The triangle's entries packed row by row."""
    rows, cols = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@register("_linalg_maketrian", num_inputs=1, aliases=("linalg_maketrian",))
def _maketrian(d, offset=0, lower=True):
    """The n x n matrix whose triangle ``d`` packs (n from its length)."""
    n = 0
    while _trian_indices(n, offset, lower, "cpu").shape[1] < d.shape[-1]:
        n += 1
    rows, cols = _trian_indices(n, offset, lower, d.device)
    out = d.new_zeros(d.shape[:-1] + (n, n))
    out[..., rows, cols] = d
    return out


@register("_linalg_inverse", num_inputs=1, aliases=("linalg_inverse",))
def _inverse(A):  # noqa: N803
    return torch.linalg.inv(A)


@register("_linalg_det", num_inputs=1, aliases=("linalg_det",))
def _det(A):  # noqa: N803
    return torch.linalg.det(A)


@register("_linalg_slogdet", num_inputs=1, num_outputs=2,
          aliases=("linalg_slogdet",))
def _slogdet(A):  # noqa: N803
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("_npi_einsum", aliases=("einsum",))
def _einsum(*operands, subscripts=""):
    return torch.einsum(subscripts, *operands)


@register("_npi_tensordot", num_inputs=2, aliases=("tensordot",))
def _tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)
