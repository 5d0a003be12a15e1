"""Cases of ``mx.np``'s surface, for both packages (numpy inputs only:
no JAX here, so the chip script can use them too).

``CASES`` has at least one case of every name of the two dispatch sets
of ``mx.np`` (``copyto`` writes in place and is tested on its own):
``name[-variant] -> make(A)`` returning ``(args, kwargs)``, where
``A(x)`` turns a numpy array into an array of the package under test.
``LINALG`` and ``NPX`` do the same for ``mx.np.linalg`` and ``mx.npx``;
``RANDOM`` gives each sampler of ``mx.np.random`` its arguments and the
mean and variance of its draws, ``SAMPLERS`` each sampler op of the
registry.  Cases that draw arrays inline draw them from ``_R``:
call :func:`build` (it seeds ``_R`` from the case's name), so that every
package and device gets the same inputs.
"""
import numpy as onp

_R = onp.random.RandomState(2024)


def _f(*shape):
    return _R.normal(0.0, 1.0, shape).astype(onp.float32)


def _p(*shape):
    return _R.uniform(0.5, 2.0, shape).astype(onp.float32)


def _i(lo, hi, *shape):
    return _R.randint(lo, hi, shape).astype(onp.int32)


F34, G34, F4, P34 = _f(3, 4), _f(3, 4), _f(4), _p(3, 4)
F234, F44, F3 = _f(2, 3, 4), _f(4, 4), _f(3)
I34, J34 = _i(-9, 10, 3, 4), _i(1, 5, 3, 4)
B34 = _R.rand(3, 4) > 0.5
U01 = _R.uniform(-0.9, 0.9, (3, 4)).astype(onp.float32)
SORTED = onp.sort(_f(7))
SPD = (lambda a: a @ a.T + 4 * onp.eye(4, dtype=onp.float32))(_f(4, 4))

#: name -> make(A) of (args, kwargs); A(x) makes an array of the
#: package under test
CASES = {
    "add": lambda A: ((A(F34), A(G34)), {}),
    "add-scalar-int": lambda A: ((A(I34), 2.5), {}),
    "subtract": lambda A: ((A(F34), A(F4)), {}),
    "multiply": lambda A: ((A(F34), 3.0), {}),
    "divide": lambda A: ((A(F34), A(P34)), {}),
    "divide-int": lambda A: ((A(I34), A(J34)), {}),
    "true_divide": lambda A: ((2.0, A(P34)), {}),
    "power": lambda A: ((A(P34), A(F34)), {}),
    "power-int": lambda A: ((A(J34), 2), {}),
    "float_power": lambda A: ((A(P34), 1.5), {}),
    "mod": lambda A: ((A(F34 * 5), A(P34)), {}),
    "mod-int": lambda A: ((A(I34), A(-J34)), {}),
    "remainder": lambda A: ((A(F34 * 5), -1.5), {}),
    "fmod": lambda A: ((A(F34 * 5), A(P34)), {}),
    "fmod-int": lambda A: ((A(I34), A(J34)), {}),
    "maximum": lambda A: ((A(F34), A(G34)), {}),
    "minimum": lambda A: ((A(F34), 0.25), {}),
    "fmax": lambda A: ((A(F34), A(G34)), {}),
    "fmin": lambda A: ((A(F34), A(G34)), {}),
    "matmul": lambda A: ((A(F34), A(_f(4, 5))), {}),
    "matmul-batch": lambda A: ((A(F234), A(_f(4, 2))), {}),
    "dot": lambda A: ((A(F34), A(F4)), {}),
    "dot-nd": lambda A: ((A(F234), A(_f(5, 4, 2))), {}),
    "vdot": lambda A: ((A(F34), A(G34)), {}),
    "inner": lambda A: ((A(F34), A(_f(2, 4))), {}),
    "outer": lambda A: ((A(F3), A(F4)), {}),
    "tensordot": lambda A: ((A(F234), A(_f(3, 4, 5))), {"axes": 2}),
    "tensordot-lists": lambda A: ((A(F34), A(G34)),
                                  {"axes": ([1], [1])}),
    "einsum": lambda A: (("ij,kj->ik", A(F34), A(G34)), {}),
    "kron": lambda A: ((A(_f(2, 2)), A(_f(2, 3))), {}),
    "cross": lambda A: ((A(_f(4, 3)), A(_f(4, 3))), {}),
    "exp": lambda A: ((A(F34),), {}),
    "exp-int": lambda A: ((A(_i(-3, 3, 5)),), {}),
    "exp2": lambda A: ((A(F34),), {}),
    "expm1": lambda A: ((A(F34),), {}),
    "log": lambda A: ((A(P34),), {}),
    "log2": lambda A: ((A(P34),), {}),
    "log10": lambda A: ((A(P34),), {}),
    "log1p": lambda A: ((A(P34),), {}),
    "sqrt": lambda A: ((A(P34),), {}),
    "sqrt-int": lambda A: ((A(J34),), {}),
    "cbrt": lambda A: ((A(F34),), {}),
    "square": lambda A: ((A(F34),), {}),
    "square-int": lambda A: ((A(I34),), {}),
    "reciprocal": lambda A: ((A(P34),), {}),
    "positive": lambda A: ((A(F34),), {}),
    "negative": lambda A: ((A(F34),), {}),
    "abs": lambda A: ((A(F34),), {}),
    "abs-int": lambda A: ((A(I34),), {}),
    "absolute": lambda A: ((A(F34),), {}),
    "fabs": lambda A: ((A(F34),), {}),
    "sign": lambda A: ((A(F34),), {}),
    "hypot": lambda A: ((A(F34), A(G34)), {}),
    "logaddexp": lambda A: ((A(F34), A(G34)), {}),
    "logaddexp2": lambda A: ((A(F34), A(G34)), {}),
    "sin": lambda A: ((A(F34),), {}),
    "cos": lambda A: ((A(F34),), {}),
    "tan": lambda A: ((A(U01),), {}),
    "arcsin": lambda A: ((A(U01),), {}),
    "arccos": lambda A: ((A(U01),), {}),
    "arctan": lambda A: ((A(F34),), {}),
    "arctan2": lambda A: ((A(F34), A(G34)), {}),
    "sinh": lambda A: ((A(F34),), {}),
    "cosh": lambda A: ((A(F34),), {}),
    "tanh": lambda A: ((A(F34),), {}),
    "arcsinh": lambda A: ((A(F34),), {}),
    "arccosh": lambda A: ((A(P34 + 1),), {}),
    "arctanh": lambda A: ((A(U01),), {}),
    "deg2rad": lambda A: ((A(F34),), {}),
    "rad2deg": lambda A: ((A(F34),), {}),
    "degrees": lambda A: ((A(F34),), {}),
    "radians": lambda A: ((A(F34),), {}),
    "sum": lambda A: ((A(F34),), {}),
    "sum-axis-keepdims": lambda A: ((A(F234),), {"axis": (0, 2),
                                                  "keepdims": True}),
    "sum-int": lambda A: ((A(I34),), {"axis": 1}),
    "mean": lambda A: ((A(F34),), {"axis": 0}),
    "mean-int": lambda A: ((A(I34),), {}),
    "prod": lambda A: ((A(P34),), {"axis": 1}),
    "prod-all": lambda A: ((A(P34),), {}),
    "std": lambda A: ((A(F34),), {"axis": 1, "ddof": 1}),
    "var": lambda A: ((A(F34),), {}),
    "median": lambda A: ((A(F34),), {"axis": 1}),
    "median-odd-all": lambda A: ((A(_f(3, 5)),), {}),
    "average": lambda A: ((A(F34),), {"axis": 1, "weights": A(P34[0])}),
    "ptp": lambda A: ((A(F34),), {"axis": 0}),
    "nansum": lambda A: ((A(F34),), {"axis": 1}),
    "nanmean": lambda A: ((A(F34),), {}),
    "nanprod": lambda A: ((A(P34),), {"axis": 0}),
    "cumsum": lambda A: ((A(F34),), {"axis": 1}),
    "cumsum-flat-int": lambda A: ((A(I34),), {}),
    "cumprod": lambda A: ((A(P34),), {"axis": 0}),
    "amin": lambda A: ((A(F34),), {"axis": 1}),
    "amax": lambda A: ((A(F34),), {}),
    "min": lambda A: ((A(F234),), {"axis": (1, 2)}),
    "max": lambda A: ((A(F34),), {"axis": 0, "keepdims": True}),
    "nanmin": lambda A: ((A(F34),), {"axis": 1}),
    "nanmax": lambda A: ((A(F34),), {}),
    "clip": lambda A: ((A(F34), -0.5, 0.7), {}),
    "interp": lambda A: ((A(_f(6) * 2), A(SORTED), A(_f(7))), {}),
    "reshape": lambda A: ((A(F34), (2, 6)), {}),
    "ravel": lambda A: ((A(F234),), {}),
    "transpose": lambda A: ((A(F234),), {"axes": (1, 0, 2)}),
    "swapaxes": lambda A: ((A(F234), 0, 2), {}),
    "moveaxis": lambda A: ((A(F234), 0, -1), {}),
    "rollaxis": lambda A: ((A(F234), 2), {}),
    "concatenate": lambda A: (([A(F34), A(G34)],), {"axis": 1}),
    "stack": lambda A: (([A(F34), A(G34)],), {"axis": 1}),
    "vstack": lambda A: (([A(F4), A(F34)],), {}),
    "hstack": lambda A: (([A(F34), A(G34)],), {}),
    "dstack": lambda A: (([A(F34), A(G34)],), {}),
    "column_stack": lambda A: (([A(F3), A(F34)],), {}),
    "row_stack": lambda A: (([A(F4), A(F34)],), {}),
    "split": lambda A: ((A(F34), 2), {"axis": 1}),
    "split-indices": lambda A: ((A(_f(7, 2)), [2, 5]), {}),
    "split-one": lambda A: ((A(F4), 1), {}),
    "array_split": lambda A: ((A(_f(7, 2)), 3), {}),
    "hsplit": lambda A: ((A(F34), 2), {}),
    "vsplit": lambda A: ((A(_f(4, 3)), 2), {}),
    "dsplit": lambda A: ((A(F234), [1, 3]), {}),
    "squeeze": lambda A: ((A(_f(3, 1, 4)),), {}),
    "expand_dims": lambda A: ((A(F34), (0, 2)), {}),
    "broadcast_to": lambda A: ((A(F4), (3, 4)), {}),
    "repeat": lambda A: ((A(F34), 2), {"axis": 0}),
    "repeat-flat": lambda A: ((A(F34), 3), {}),
    "tile": lambda A: ((A(F34), (2, 1)), {}),
    "flip": lambda A: ((A(F34),), {"axis": 1}),
    "fliplr": lambda A: ((A(F34),), {}),
    "flipud": lambda A: ((A(F34),), {}),
    "roll": lambda A: ((A(F34), 2), {"axis": 1}),
    "rot90": lambda A: ((A(F34),), {"k": 3}),
    "atleast_1d": lambda A: ((A(onp.float32(2.0)),), {}),
    "atleast_2d": lambda A: ((A(F4), A(F34)), {}),
    "atleast_3d": lambda A: ((A(F4),), {}),
    "where": lambda A: ((A(B34), A(F34), A(G34)), {}),
    "where-scalar": lambda A: ((A(B34), A(F34), 0.5), {}),
    "take": lambda A: ((A(F34), A(onp.array([[0, 2], [-1, 1]], onp.int32))),
                       {"axis": 1}),
    "take-flat": lambda A: ((A(F34), A(onp.array([0, 5, 11], onp.int32))),
                            {}),
    "take_along_axis": lambda A: ((A(F34), A(onp.argsort(F34, axis=1)
                                            .astype(onp.int32))),
                                  {"axis": 1}),
    "compress": lambda A: ((A(onp.array([True, False, True])), A(F34)),
                           {"axis": 0}),
    "extract": lambda A: ((A(B34), A(F34)), {}),
    "diag": lambda A: ((A(F44),), {"k": 1}),
    "diag-1d": lambda A: ((A(F3),), {}),
    "diagonal": lambda A: ((A(F234),), {"axis1": 1, "axis2": 2}),
    "trace": lambda A: ((A(F44),), {"offset": -1}),
    "tril": lambda A: ((A(F44),), {"k": -1}),
    "triu": lambda A: ((A(F234),), {}),
    "pad": lambda A: ((A(F34), ((1, 2), (0, 1))), {}),
    "pad-reflect": lambda A: ((A(F34), 2), {"mode": "reflect"}),
    "pad-edge": lambda A: ((A(F34), ((1, 0), (2, 1))), {"mode": "edge"}),
    "pad-wrap": lambda A: ((A(F34), 1), {"mode": "wrap"}),
    "real": lambda A: ((A(F34),), {}),
    "imag": lambda A: ((A(F34),), {}),
    "conj": lambda A: ((A(F34),), {}),
    "conjugate": lambda A: ((A(F34),), {}),
    "flatten": lambda A: ((A(F34),), {}),
    "delete": lambda A: ((A(F34), 1), {"axis": 1}),
    "delete-list": lambda A: ((A(F34), A(onp.array([0, 2], onp.int32))),
                              {"axis": 0}),
    "insert": lambda A: ((A(F34), 1, A(F3)), {"axis": 1}),
    "insert-flat": lambda A: ((A(F34), 3, 9.0), {}),
    "append": lambda A: ((A(F34), A(G34)), {"axis": 0}),
    "append-flat": lambda A: ((A(F34), A(F4)), {}),
    "select": lambda A: (([A(B34), A(~B34)], [A(F34), A(G34)]), {}),
    "heaviside": lambda A: ((A(F34), 0.5), {}),
    "nan_to_num": lambda A: ((A(onp.array([onp.nan, onp.inf, -onp.inf, 1.0],
                                          onp.float32)),), {}),
    "diff": lambda A: ((A(F34),), {"axis": 0}),
    "diff-n2": lambda A: ((A(F34),), {"n": 2}),
    "ediff1d": lambda A: ((A(F34),), {}),
    "gradient": lambda A: ((A(F34),), {}),
    "gradient-1d": lambda A: ((A(_f(6)),), {}),
    "trapz": lambda A: ((A(F34),), {}),
    "trapezoid": lambda A: ((A(F34),), {"dx": 0.5, "axis": 0}),
    "convolve": lambda A: ((A(_f(7)), A(_f(3))), {}),
    "convolve-same": lambda A: ((A(_f(3)), A(_f(6))), {"mode": "same"}),
    "correlate": lambda A: ((A(_f(7)), A(_f(3))), {}),
    "correlate-full": lambda A: ((A(_f(5)), A(_f(3))), {"mode": "full"}),
    # the quiet set
    "argmax": lambda A: ((A(F34),), {"axis": 1}),
    "argmax-flat": lambda A: ((A(F34),), {}),
    "argmin": lambda A: ((A(F34),), {"axis": 0}),
    "argsort": lambda A: ((A(F34),), {}),
    "sort": lambda A: ((A(F34),), {"axis": 0}),
    "searchsorted": lambda A: ((A(SORTED), A(F4)), {}),
    "searchsorted-right": lambda A: ((A(onp.array([1, 2, 2, 3], onp.int32)),
                                      A(onp.array([2, 0, 5], onp.int32))),
                                     {"side": "right"}),
    "nonzero": lambda A: ((A(B34),), {}),
    "flatnonzero": lambda A: ((A(B34),), {}),
    "unique": lambda A: ((A(onp.array([3, 1, 3, 7, 1], onp.int32)),), {}),
    "unique-all": lambda A: ((A(onp.array([3.0, 1, 3, 7, 1], onp.float32)),),
                             {"return_index": True, "return_inverse": True,
                              "return_counts": True}),
    "count_nonzero": lambda A: ((A(I34),), {"axis": 1}),
    "bincount": lambda A: ((A(onp.array([0, 2, 2, 5], onp.int32)),),
                           {"minlength": 7}),
    "bincount-weights": lambda A: ((A(onp.array([0, 2, 2], onp.int32)),),
                                   {"weights": A(onp.array([0.5, 1., 2.],
                                                           onp.float32))}),
    "digitize": lambda A: ((A(F34), A(SORTED)), {}),
    "digitize-right": lambda A: ((A(F4), A(SORTED)), {"right": True}),
    "histogram": lambda A: ((A(_f(50)),), {"bins": 6}),
    "histogram-range": lambda A: ((A(_f(50)),), {"bins": 4,
                                                 "range": (-1.0, 1.0)}),
    "histogram2d": lambda A: ((A(_f(40)), A(_f(40))), {"bins": 3}),
    "histogramdd": lambda A: ((A(_f(30, 2)),), {"bins": 4}),
    "floor": lambda A: ((A(F34 * 3),), {}),
    "floor-int": lambda A: ((A(I34),), {}),
    "ceil": lambda A: ((A(F34 * 3),), {}),
    "rint": lambda A: ((A(onp.array([0.5, 1.5, -2.5, 2.7], onp.float32)),),
                       {}),
    "rint-int": lambda A: ((A(I34),), {}),
    "trunc": lambda A: ((A(F34 * 3),), {}),
    "round": lambda A: ((A(F34 * 10),), {"decimals": 1}),
    "around": lambda A: ((A(onp.array([0.5, 1.5, -2.5], onp.float32)),), {}),
    "fix": lambda A: ((A(F34 * 3),), {}),
    "signbit": lambda A: ((A(F34),), {}),
    "equal": lambda A: ((A(I34), A(I34.T.copy().T)), {}),
    "not_equal": lambda A: ((A(I34), 2), {}),
    "greater": lambda A: ((A(F34), A(G34)), {}),
    "greater_equal": lambda A: ((A(F34), 0.0), {}),
    "less": lambda A: ((A(F34), A(G34)), {}),
    "less_equal": lambda A: ((A(I34), A(J34)), {}),
    "isclose": lambda A: ((A(F34), A(F34 + 1e-6)), {}),
    "allclose": lambda A: ((A(F34), A(F34 * (1 + 1e-7))), {}),
    "array_equal": lambda A: ((A(I34), A(I34)), {}),
    "array_equiv": lambda A: ((A(F4), A(onp.tile(F4, (3, 1)))), {}),
    "isnan": lambda A: ((A(onp.array([onp.nan, 1.0, onp.inf], onp.float32)),),
                        {}),
    "isinf": lambda A: ((A(onp.array([onp.nan, 1.0, -onp.inf],
                                     onp.float32)),), {}),
    "isfinite": lambda A: ((A(onp.array([onp.nan, 1.0, onp.inf],
                                        onp.float32)),), {}),
    "isneginf": lambda A: ((A(onp.array([-onp.inf, 1.0, onp.inf],
                                        onp.float32)),), {}),
    "isposinf": lambda A: ((A(onp.array([-onp.inf, 1.0, onp.inf],
                                        onp.float32)),), {}),
    "iscomplex": lambda A: ((A(F34),), {}),
    "isreal": lambda A: ((A(F34),), {}),
    "all": lambda A: ((A(B34),), {"axis": 0}),
    "any": lambda A: ((A(B34),), {}),
    "logical_and": lambda A: ((A(B34), A(~B34)), {}),
    "logical_or": lambda A: ((A(B34), A(F34)), {}),
    "logical_not": lambda A: ((A(I34),), {}),
    "logical_xor": lambda A: ((A(B34), True), {}),
    "bitwise_and": lambda A: ((A(I34), A(J34)), {}),
    "bitwise_or": lambda A: ((A(I34), 6), {}),
    "bitwise_xor": lambda A: ((A(B34), A(~B34)), {}),
    "bitwise_not": lambda A: ((A(I34),), {}),
    "invert": lambda A: ((A(B34),), {}),
    "left_shift": lambda A: ((A(J34), A(J34)), {}),
    "right_shift": lambda A: ((A(I34 * 16), 2), {}),
    "floor_divide": lambda A: ((A(F34 * 5), A(P34)), {}),
    "floor_divide-int": lambda A: ((A(I34), A(J34)), {}),
    "divmod": lambda A: ((A(F34 * 5), A(P34)), {}),
    "shape": lambda A: ((A(F234),), {}),
    "size": lambda A: ((A(F234),), {}),
    "ndim": lambda A: ((A(F234),), {}),
    "result_type": lambda A: ((A(I34), A(F34)), {}),
    "result_type-weak": lambda A: ((A(I34), 1.0), {}),
    "can_cast": lambda A: (("int32", "float64"), {}),
    "promote_types": lambda A: (("int32", "float32"), {}),
    "meshgrid": lambda A: ((A(F3), A(F4)), {}),
    "meshgrid-ij": lambda A: ((A(F3), A(F4)), {"indexing": "ij"}),
    "indices": lambda A: (((2, 3),), {}),
    "unravel_index": lambda A: ((A(onp.array([1, 7, 11], onp.int32)), (3, 4)),
                                {}),
    "ravel_multi_index": lambda A: (((A(onp.array([0, 2], onp.int32)),
                                      A(onp.array([1, 3], onp.int32))),
                                     (3, 4)), {}),
    "tril_indices": lambda A: ((4,), {"k": -1}),
    "triu_indices": lambda A: ((3,), {"m": 5}),
    "diag_indices": lambda A: ((3,), {}),
    "ix_": lambda A: ((A(onp.array([0, 2], onp.int32)),
                       A(onp.array([1, 3, 0], onp.int32))), {}),
    "asarray": lambda A: ((A(F34),), {}),
    "asarray-dtype": lambda A: ((A(I34),), {"dtype": "float32"}),
    "ascontiguousarray": lambda A: ((A(F34),), {}),
    "empty_like": lambda A: ((A(F34),), {}),
    "zeros_like": lambda A: ((A(I34),), {}),
    "ones_like": lambda A: ((A(F34),), {"dtype": "int32"}),
    "full_like": lambda A: ((A(I34), 2.5), {}),
    "copy": lambda A: ((A(F34),), {}),
    "astype": lambda A: ((A(F34 * 4), "int32"), {}),
    "broadcast_shapes": lambda A: (((3, 1), (4,)), {}),
    "array2string": lambda A: ((A(F3),), {}),
    "array_repr": lambda A: ((A(F3),), {}),
    "array_str": lambda A: ((A(F3),), {}),
    "base_repr": lambda A: ((37, 3), {}),
    "binary_repr": lambda A: ((-5,), {"width": 8}),
    "isscalar": lambda A: ((A(F3),), {}),
    "iterable": lambda A: ((A(F3),), {}),
    "may_share_memory": lambda A: ((A(F3), A(F3)), {}),
}


LINALG = {
    "norm": lambda A: ((A(F34),), {}),
    "norm-axis": lambda A: ((A(F34),), {"axis": 1, "ord": 1}),
    "cholesky": lambda A: ((A(SPD),), {}),
    "inv": lambda A: ((A(SPD),), {}),
    "det": lambda A: ((A(SPD),), {}),
    "slogdet": lambda A: ((A(F44),), {}),
    "solve": lambda A: ((A(SPD), A(F4)), {}),
    "pinv": lambda A: ((A(F34),), {}),
    "eigvalsh": lambda A: ((A(SPD),), {}),
    "matrix_rank": lambda A: ((A(F34),), {}),
    "matrix_power": lambda A: ((A(F44), 3), {}),
    "multi_dot": lambda A: (([A(F34), A(_f(4, 2)), A(_f(2, 3))],), {}),
    "tensorinv": lambda A: ((A((onp.eye(6, dtype=onp.float32) * 3
                                + 0.3 * _f(6, 6)).reshape(6, 2, 3)),),
                            {"ind": 1}),
    "tensorsolve": lambda A: ((A((onp.eye(6, dtype=onp.float32) * 3
                                  + 0.3 * _f(6, 6)).reshape(2, 3, 6)),
                               A(_f(2, 3))), {}),
    "cond": lambda A: ((A(SPD),), {}),
    "lstsq": lambda A: ((A(_f(6, 3)), A(_f(6))), {}),
}


#: name -> (kwargs, mean, variance) of the draws
N = 20000
RANDOM = {
    "uniform": (dict(low=-1.0, high=3.0, size=N), 1.0, 16 / 12),
    "normal": (dict(loc=2.0, scale=0.5, size=N), 2.0, 0.25),
    "randint": (dict(low=2, high=7, size=N), 4.0, 2.0),
    "gamma": (dict(shape=2.0, scale=1.5, size=N), 3.0, 4.5),
    "beta": (dict(a=2.0, b=3.0, size=N), 0.4, 0.04),
    "exponential": (dict(scale=2.0, size=N), 2.0, 4.0),
    "lognormal": (dict(mean=0.0, sigma=0.5, size=N),
                  onp.exp(0.125), (onp.exp(0.25) - 1) * onp.exp(0.25)),
    "laplace": (dict(loc=1.0, scale=0.5, size=N), 1.0, 0.5),
    "pareto": (dict(a=5.0, size=N), 0.25, 5 / (16 * 3)),
    "power": (dict(a=3.0, size=N), 0.75, 3 / 80),
    "rayleigh": (dict(scale=2.0, size=N), 2.0 * onp.sqrt(onp.pi / 2),
                 (4 - onp.pi) / 2 * 4),
    "weibull": (dict(a=2.0, size=N), onp.sqrt(onp.pi) / 2, 1 - onp.pi / 4),
    "choice": (dict(a=5, size=N), 2.0, 2.0),
}


#: name -> make(A), as ``CASES``, for ``mx.npx``
NPX = {
    "softmax": lambda A: ((A(F34),), {"axis": 0}),
    "log_softmax": lambda A: ((A(F34),), {}),
    "relu": lambda A: ((A(F34),), {}),
    "sigmoid": lambda A: ((A(F34),), {}),
    "batch_norm": lambda A: ((A(_f(4, 3, 5, 5)), A(_p(3)), A(_f(3)),
                              A(_f(3)), A(_p(3))),
                             {"eps": 1e-5, "fix_gamma": False}),
    "fully_connected": lambda A: ((A(F234), A(_f(5, 12)), A(_f(5))),
                                  {"num_hidden": 5}),
    "convolution": lambda A: ((A(_f(2, 3, 9, 9)), A(_f(4, 3, 3, 3)),
                               A(_f(4))),
                              {"kernel": (3, 3), "num_filter": 4,
                               "stride": (2, 2), "pad": (1, 1)}),
    "pooling-max": lambda A: ((A(_f(2, 3, 9, 9)),),
                              {"kernel": (3, 3), "stride": (2, 2),
                               "pad": (1, 1), "pool_type": "max"}),
    "pooling-avg-global": lambda A: ((A(_f(2, 3, 7, 7)),),
                                     {"kernel": (1, 1), "global_pool": True,
                                      "pool_type": "avg"}),
    "one_hot": lambda A: ((A(onp.array([0, 3, 1], onp.int32)), 5), {}),
    "pick": lambda A: ((A(F34), A(onp.array([0, 3, 1], onp.int32))), {}),
    "topk": lambda A: ((A(F34),), {"k": 2}),
    "reshape_like": lambda A: ((A(F34), A(_f(2, 6))), {}),
    "batch_dot": lambda A: ((A(F234), A(_f(2, 4, 5))), {}),
    "gamma": lambda A: ((A(P34 + 0.5),), {}),
}


#: ``CASES`` of the names that take any shape, at moderate shapes (the
#: card runs these beside the small ones)
MODERATE = {}
for _n in ("exp expm1 log1p sqrt cbrt sin cos tanh arctan arcsinh square "
           "reciprocal abs negative sign floor ceil rint trunc "
           "isfinite signbit").split():
    MODERATE[_n + "-moderate"] = lambda A: ((A(_p(192, 256)),), {})
# (not mod, fmod, floor_divide: a quotient within an ulp of an integer
# rounds either way on either device, once in ~1e6 elements)
for _n in ("add subtract multiply divide power maximum minimum fmax hypot "
           "arctan2 logaddexp heaviside greater isclose").split():
    MODERATE[_n + "-moderate"] = lambda A: ((A(_p(192, 256)),
                                             A(_p(192, 256))), {})
for _n in ("sum mean prod std var median amax amin ptp nansum cumsum "
           "cumprod argmax argmin argsort sort count_nonzero").split():
    MODERATE[_n + "-moderate"] = lambda A: ((A(_p(192, 256)),), {"axis": 1})
MODERATE.update({
    "matmul-moderate": lambda A: ((A(_f(192, 256)), A(_f(256, 128))), {}),
    "dot-moderate": lambda A: ((A(_f(8, 96, 64)), A(_f(64, 32))), {}),
    "einsum-moderate": lambda A: (("bij,bjk->bik", A(_f(8, 64, 48)),
                                   A(_f(8, 48, 32))), {}),
    "tensordot-moderate": lambda A: ((A(_f(16, 32, 24)), A(_f(32, 24, 8))),
                                     {"axes": 2}),
    "where-moderate": lambda A: ((A(_R.rand(192, 256) > 0.5),
                                  A(_f(192, 256)), A(_f(192, 256))), {}),
    "clip-moderate": lambda A: ((A(_f(192, 256)), -0.5, 0.5), {}),
    "take-moderate": lambda A: ((A(_f(192, 256)),
                                 A(_R.randint(-192, 192, (64, 3)).astype(
                                     onp.int32))), {"axis": 0}),
    "concatenate-moderate": lambda A: (([A(_f(96, 256)), A(_f(96, 256))],),
                                       {"axis": 0}),
    "pad-moderate": lambda A: ((A(_f(64, 96)), 3), {"mode": "reflect"}),
    "unique-moderate": lambda A: ((A(_R.randint(0, 50, 4096).astype(
        onp.int32)),), {"return_counts": True}),
    "histogram-moderate": lambda A: ((A(_f(8192)),), {"bins": 64}),
    "convolve-moderate": lambda A: ((A(_f(1024)), A(_f(31))), {}),
})
del _n

#: the registry's samplers: (op, arrays, attrs, mean, variance) of the
#: draws along their last axis
SAMPLERS = [
    ("_random_gamma", [], dict(alpha=2.0, beta=1.5, shape=(N,)), 3.0, 4.5),
    ("_random_exponential", [], dict(lam=2.0, shape=(N,)), 0.5, 0.25),
    ("_random_poisson", [], dict(lam=3.0, shape=(N,)), 3.0, 3.0),
    ("_random_negative_binomial", [], dict(k=3, p=0.4, shape=(N,)), 4.5,
     11.25),
    ("_random_generalized_negative_binomial", [],
     dict(mu=2.0, alpha=0.5, shape=(N,)), 2.0, 4.0),
    ("_sample_uniform", [onp.array([0.0, 2.0], onp.float32),
                         onp.array([1.0, 6.0], onp.float32)],
     dict(shape=(N,)), (0.5, 4.0), (1 / 12, 16 / 12)),
    ("_sample_normal", [onp.array([-1.0, 3.0], onp.float32),
                        onp.array([0.5, 2.0], onp.float32)],
     dict(shape=(N,)), (-1.0, 3.0), (0.25, 4.0)),
    ("_npi_normal_n", [], dict(loc=1.0, scale=2.0, size=(N,)), 1.0, 4.0),
    ("_npi_uniform_n", [], dict(low=-1.0, high=3.0, size=(N,)), 1.0,
     16 / 12),
    ("_npi_choice", [], dict(a=5, size=(N,)), 2.0, 2.0),
    ("_npi_choice", [], dict(a=3, size=(N,),
                             weights=onp.array([0.2, 0.3, 0.5])), 1.3, 0.61),
    ("_sample_multinomial", [onp.array([0.1, 0.2, 0.7], onp.float32)],
     dict(shape=(N,)), 1.6, 0.44),
]


def case_name(case):
    """The function a case calls (its id up to the first ``-``)."""
    return case.split("-")[0]


def build(table, case, A):  # noqa: N803 - the cases' argument
    """``table[case](A)`` with ``_R`` seeded from the case's name."""
    _R.seed(sum(map(ord, case)))
    return table[case](A)
