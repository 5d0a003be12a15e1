"""Holding the port's registered ops against the JAX package's on the CPU
(shared by ``test_torch_parity_tail.py`` and ``test_torch_contrib_tail.py``).

A case is (op name, numpy arrays, attributes).  Both registries get the
same arrays.  For a differentiable op both sides also differentiate a
fixed random projection of their floating outputs with respect to their
floating inputs.  :func:`reference` runs every traceable case of a table
in one ``jax.jit`` (eager JAX calls of these ops take seconds each); an
op the reference marks ``no_trace`` runs eagerly.  :func:`check` holds
a case: integer outputs and cases listed as exact equal, floating ones
within ``TOL`` of the output's (gradient's) largest magnitude, at least
``TOL`` absolute, and dtypes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TOL = 1e-5


def floating(a):
    dt = np.asarray(a).dtype
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"


def _cotangents(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, np.shape(o)).astype(np.asarray(o).dtype)
            if floating(o) else None for o in outs]


def _job(op, arrays, attrs, seed):
    """The reference's case as a function of its floating inputs returning
    (outputs, gradients), and those inputs."""
    fn = op.fn
    attrs = dict(attrs)
    wrt = [i for i, a in enumerate(arrays) if floating(a)] \
        if op.differentiable else []

    def run(*xs):
        # a no_trace op reads its non-differentiated inputs on the host
        full = [None if a is None else a if op.no_trace else jnp.asarray(a)
                for a in arrays]
        for i, x in zip(wrt, xs):
            full[i] = x
        out = fn(*full, **attrs)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    xs = [arrays[i] for i in wrt]
    shapes = run(*xs) if op.no_trace else jax.eval_shape(run, *xs)
    if not any(floating(np.zeros((), o.dtype)) for o in shapes):
        wrt = []
    if not wrt:
        return lambda: (run(), None), []
    cots = _cotangents([np.zeros(o.shape, o.dtype) for o in shapes], seed)

    def proj(*ys):
        outs = run(*ys)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)
                   if c is not None), outs

    grad = jax.value_and_grad(proj, argnums=tuple(range(len(wrt))),
                              has_aux=True)

    def job(*ys):
        (_, outs), grads = grad(*ys)
        full = [None] * len(arrays)
        for i, g in zip(wrt, grads):
            full[i] = g
        return outs, full

    return job, xs


def reference(jops, cases):
    """{case: (outputs, gradients or None)} of the reference, every
    traceable case in one compiled program."""
    done, jobs = {}, {}
    for c, (name, arrays, attrs) in cases.items():
        job = _job(jops[name], arrays, attrs, sum(map(ord, c)))
        if jops[name].no_trace:
            outs, grads = job[0](*job[1])
            done[c] = ([np.asarray(o) for o in outs], None if grads is None
                       else [None if g is None else np.asarray(g)
                             for g in grads])
        else:
            jobs[c] = job
    run_all = jax.jit(lambda inputs: {c: jobs[c][0](*inputs[c])
                                      for c in jobs})
    for c, (outs, grads) in run_all({c: jobs[c][1] for c in jobs}).items():
        done[c] = ([np.asarray(o) for o in outs],
                   None if grads is None else
                   [None if g is None else np.asarray(g) for g in grads])
    return done


def port(op, arrays, attrs, seed):
    """The port's outputs and gradients of the same case on the CPU."""
    ts = [None if a is None else
          torch.tensor(np.asarray(a), requires_grad=floating(a)
                       and op.differentiable) for a in arrays]
    if not arrays:
        attrs = dict(attrs, ctx="cpu")
    out = op.fn(*ts, **attrs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    np_outs = [o.detach().numpy() for o in outs]
    live = [t for t in ts if t is not None and t.requires_grad]
    if not live or not any(o.requires_grad for o in outs):
        return np_outs, None
    cots = _cotangents(np_outs, seed)
    total = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)
                if c is not None and o.requires_grad)
    grads = iter(torch.autograd.grad(total, live, allow_unused=True))
    full = []
    for t in ts:
        if t is None or not t.requires_grad:
            full.append(None)
            continue
        g = next(grads)
        full.append(np.zeros(tuple(t.shape), t.detach().numpy().dtype)
                    if g is None else g.numpy())
    return np_outs, full


def close(got, want, what, exact=False):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if exact or not floating(want):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    w = want.astype(np.float64)
    err = float(np.max(np.abs(got.astype(np.float64) - w))) if w.size \
        else 0.0
    limit = TOL * max(1.0, float(np.max(np.abs(w))) if w.size else 0.0)
    assert err <= limit, "%s: max abs err %g over %g" % (what, err, limit)


def check(case, cases, ref, jops, tops, exact=False):
    """Hold ``case`` of ``cases`` against the reference's result ``ref``."""
    name, arrays, attrs = cases[case]
    assert tops[name].name == jops[name].name
    want, want_g = ref
    got, got_g = port(tops[name], arrays, attrs, sum(map(ord, case)))
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, "%s output %d" % (case, i), exact)
    if want_g is None:
        assert got_g is None or all(g is None for g in got_g), case
        return
    if got_g is None:
        # no output of the port's depends on an input differentiably
        # (a comparison): the reference's gradients are zeros
        assert not any(np.any(w) for w in want_g if w is not None), case
        return
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        if w is not None:
            assert g is not None, "%s: no gradient of input %d" % (case, i)
            close(g, w, "%s gradient of input %d" % (case, i), exact)
