"""The port's sequence parallelism and multi-axis meshes against the JAX
package, on the CPU.

One job of 4 ranks over gloo (``tools/launch_torch.py``,
``tests/torch_mp_worker.py`` in mode ``seq``, which imports no JAX) runs
every case; the parent draws the inputs from numpy seeds and runs the
reference on its 8-device CPU mesh meanwhile.  A second job of 2 ranks
runs ``example/long_context/train_lm_torch.py --devices 2`` itself.

- ``sharded_self_attention``, ring and Ulysses, causal and not, at sp=4
  (``make_mesh({"sp": 4})``) and sp=2 (the ``sp`` lines of
  ``make_mesh({"dp": 2, "sp": 2})``), at the shapes of the reference's
  ``tests/test_parallel.py:30-80`` (B 2, S 32, D 8; H 4, or 8 for causal
  Ulysses), against the reference's ``sharded_self_attention`` on as
  many devices: outputs within rtol 2e-4 / atol 2e-5, the q/k/v
  gradients of ``sum(out * cot)`` within rtol 1e-3 / atol 1e-4, every
  rank's equal bit for bit, and the collectives each call makes;
- the multi-axis meshes: each rank at the coordinates of the
  reference's device of that index, each axis's group the ranks of its
  line, a sum over each axis;
- the LM of ``train_lm_torch.py`` at sp=2 (dim 64, 4 heads, seq 64,
  batch 2, vocab 64, 2 layers), ring and Ulysses, 2 steps of its update
  (lr 0.05, momentum 0.9), against ``train_lm.py``'s step at sp=2:
  losses within 1e-5 relative, parameters within 2e-5 absolute, the
  replicas equal bit for bit.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from incubator_mxnet_tpu.parallel import make_mesh as jmesh
from incubator_mxnet_tpu.parallel.ring_attention import \
    sharded_self_attention as jssa

import torch_dist_launch
import torch_mp_worker

RANKS = 4
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LM_LOSS_RTOL, LM_PARAM_ATOL = 1e-5, 2e-5


def _example(name):
    spec = importlib.util.spec_from_file_location(
        "_seq_" + name, os.path.join(torch_dist_launch.REPO, "example",
                                     "long_context", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tex = _example("train_lm_torch")


def _cases():
    out = []
    for sp, mesh in ((4, "sp4"), (2, "sp2")):
        for impl in ("ring", "ulysses"):
            for causal in (False, True):
                out.append(dict(
                    name="%s_sp%d_%s" % (impl, sp, "causal" if causal
                                         else "dense"),
                    mesh=mesh, sp=sp, impl=impl, causal=causal,
                    heads=8 if impl == "ulysses" and causal else 4))
    return out


CASES = _cases()


def _inputs(case, seed):
    rng = np.random.RandomState(seed)
    shape = (2, case["heads"], 32, 8)
    return {t: rng.normal(size=shape).astype(np.float32)
            for t in ("q", "k", "v", "cot")}


def _reference_attention(case, arrs):
    mesh = jmesh({"sp": case["sp"]}, devices=jax.devices()[:case["sp"]])
    q, k, v, cot = (jnp.asarray(arrs[t]) for t in ("q", "k", "v", "cot"))

    def f(q, k, v):
        return jssa(q, k, v, mesh, causal=case["causal"], impl=case["impl"])

    out = f(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * cot),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _reference_lm(impl):
    """``train_lm.py``'s forward, loss and step at sp=2 with ``impl``:
    2 steps from the example's weights and tokens; losses and the
    parameters after."""
    from incubator_mxnet_tpu.parallel.ring_attention import \
        sharded_self_attention

    args = tex.parse_args(torch_mp_worker.lm_args(impl))
    mesh = jmesh({"sp": 2}, devices=jax.devices()[:2])
    rng = np.random.RandomState(0)
    params = jax.tree.map(jnp.asarray, tex.build_params(
        rng, args.vocab, args.dim, args.layers))
    tokens = jnp.asarray(tex.synthetic_tokens(rng, args.vocab, args.batch,
                                              args.seq))
    H, D = args.heads, args.dim // args.heads

    def ln(x, g, b):
        m = x.mean(-1, keepdims=True)
        v = ((x - m) ** 2).mean(-1, keepdims=True)
        return (x - m) * jax.lax.rsqrt(v + 1e-5) * g + b

    def forward(params, tokens):
        x = params["embed"][tokens]
        B, S, dim = x.shape
        for li in range(args.layers):
            p = params["l%d" % li]
            h = ln(x, p["ln1_g"], p["ln1_b"])
            q = (h @ p["wq"]).reshape(B, S, H, D).transpose(0, 2, 1, 3)
            k = (h @ p["wk"]).reshape(B, S, H, D).transpose(0, 2, 1, 3)
            v = (h @ p["wv"]).reshape(B, S, H, D).transpose(0, 2, 1, 3)
            att = sharded_self_attention(q, k, v, mesh, seq_axis="sp",
                                         causal=True, impl=impl)
            att = att.transpose(0, 2, 1, 3).reshape(B, S, dim)
            x = x + att @ p["wo"]
            h = ln(x, p["ln2_g"], p["ln2_b"])
            x = x + jax.nn.gelu(h @ p["w1"]) @ p["w2"]
        return x @ params["out"]

    def loss_fn(params, tokens):
        logits = forward(params, tokens[:, :-1])
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(lp, tokens[:, 1:, None], -1).mean()

    @jax.jit
    def step(params, opt_m, tokens):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
        opt_m = jax.tree.map(lambda m, g: 0.9 * m + g, opt_m, grads)
        params = jax.tree.map(lambda p, m: p - args.lr * m, params, opt_m)
        return params, opt_m, loss

    opt_m = jax.tree.map(jnp.zeros_like, params)
    losses = []
    for _ in range(args.steps):
        params, opt_m, loss = step(params, opt_m, tokens)
        losses.append(float(loss))
    return losses, params


def _cli_job():
    """``train_lm_torch.py --devices 2 --impl ulysses`` as a user runs it
    on the CPU, through ``tools/launch_torch.py``."""
    root = torch_dist_launch.REPO
    cmd = [sys.executable, os.path.join(root, "tools", "launch_torch.py"), "-n",
           "2", sys.executable, os.path.join(root, "example", "long_context",
                                             "train_lm_torch.py"),
           "--device", "cpu", "--devices", "2", "--impl", "ulysses",
           "--seq", "64", "--dim", "64", "--heads", "4", "--steps", "3"]
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, env=env, cwd=root, start_new_session=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("seq_parallel")
    inputs, arrs = {}, {}
    for i, case in enumerate(CASES):
        arrs[case["name"]] = _inputs(case, i)
        for t, a in arrs[case["name"]].items():
            inputs["%s.%s" % (case["name"], t)] = a
    np.savez(os.path.join(str(outdir), "inputs.npz"), **inputs)
    with open(os.path.join(str(outdir), "cases.json"), "w") as f:
        json.dump(CASES, f)
    proc = torch_dist_launch.start("seq", outdir, ranks=RANKS,
                                   worker=torch_dist_launch.MP_WORKER)
    cli = _cli_job()
    try:
        ref = {c["name"]: _reference_attention(c, arrs[c["name"]])
               for c in CASES}
        lm = {impl: _reference_lm(impl) for impl in ("ring", "ulysses")}
    except BaseException:
        proc.kill()
        cli.kill()
        raise
    ranks = torch_dist_launch.finish(proc, outdir, ranks=RANKS)
    cli_out = torch_dist_launch.wait(cli)
    return ranks, ref, lm, cli_out


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_sharded_attention_matches_reference(job, case):
    ranks, ref = job[0], job[1]
    out, grads = ref[case]
    np.testing.assert_allclose(ranks[0][case + ".out"], out, **OUT_TOL)
    for t, g in zip("qkv", grads):
        np.testing.assert_allclose(ranks[0]["%s.d%s" % (case, t)], g,
                                   err_msg=t, **GRAD_TOL)
    # the whole output and identical full gradients on every rank
    for r in ranks[1:]:
        for key in ("out", "dq", "dk", "dv"):
            k = "%s.%s" % (case, key)
            assert r[k].tobytes() == ranks[0][k].tobytes(), k


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_collectives_per_attention(job, case):
    """Ring: 2n ppermutes forward (n rotations of K and V; the last
    one's result unused), 2(n - 1) backward, one all_gather of the
    output and three of the q/k/v gradients.  Ulysses: four all_to_alls
    each way and the same all_gathers."""
    c = next(c for c in CASES if c["name"] == case)
    calls = json.loads(str(job[0][0][case + ".calls"]))
    n = c["sp"]
    want = {"ppermute": 4 * n - 2, "all_gather": 4} if c["impl"] == "ring" \
        else {"all_to_all": 8, "all_gather": 4}
    assert calls == want


@pytest.mark.parametrize("i", range(len(torch_mp_worker.LAYOUTS)))
def test_mesh_layout_is_the_references(job, i):
    """Rank r sits where the reference's ``make_mesh`` puts device r
    (row-major in axis order); each axis's group is its line."""
    axes = torch_mp_worker.LAYOUTS[i]
    jm = jmesh(axes, devices=jax.devices()[:RANKS])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    names = list(jm.axis_names)
    for r, got in enumerate(job[0]):
        coords = tuple(int(c) for c in got["layout%d.coords" % i])
        assert ids[coords] == r, (axes, r, coords)
        for ax, name in enumerate(names):
            line = [int(d) for d in np.moveaxis(ids, ax, 0)[
                (slice(None),) + tuple(c for a, c in enumerate(coords)
                                       if a != ax)]]
            assert got["layout%d.%s.ranks" % (i, name)].tolist() == \
                sorted(line)
            assert float(got["layout%d.%s.sum" % (i, name)][0]) == sum(line)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_lm_matches_train_lm_at_sp2(job, impl):
    ranks, lm = job[0], job[2]
    losses, params = lm[impl]
    np.testing.assert_allclose(ranks[0]["lm_%s.loss" % impl], losses,
                               rtol=LM_LOSS_RTOL)
    names = [k[len("lm_%s." % impl):] for k in ranks[0]
             if k.startswith("lm_%s." % impl)
             and k not in ("lm_%s.loss" % impl, "lm_%s.calls" % impl)]
    assert len(names) == 2 + 10 * 2
    for n in names:
        node = params
        for part in n.split("."):
            node = node[part]
        np.testing.assert_allclose(ranks[0]["lm_%s.%s" % (impl, n)],
                                   np.asarray(node), atol=LM_PARAM_ATOL,
                                   rtol=0, err_msg=n)
    for r in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("lm_%s." % impl):
                assert r[k].tobytes() == ranks[0][k].tobytes(), k


def test_lm_cli_two_processes(job):
    rc, out = job[3]
    assert rc == 0, out[-4000:]
    passes = [line for line in out.splitlines() if line.startswith("PASS")]
    assert len(passes) == 2 and all("sp=2 (ulysses attention)" in line
                                    for line in passes), out[-4000:]
