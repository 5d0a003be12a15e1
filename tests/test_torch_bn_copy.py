"""K7 (``fused_bn.bn_copy``, the copy yardstick of K1) and
``tools/bn_kernel_bench_torch.py`` on the CPU.

K7's plain version is ``x.clone()``: exact.  The tool's ``--dry-run``
rows keep the JAX tool's JSON schema (``tools/bn_kernel_bench.py
--dry-run --format json``), with ``stock_xla`` renamed ``plain_torch``,
and the same legs; the nine ResNet-50 BN shapes are the JAX tool's.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from incubator_mxnet_tpu_torch import _kernels
from incubator_mxnet_tpu_torch.parallel import fused_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ng", [((32, 8, 5, 5), 16), ((6, 3, 7, 2), 3),
                                      ((4, 16, 1, 1), 1)])
def test_bn_copy_plain_is_an_exact_copy(dtype, shape, ng):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(0)) \
        .to(dtype)
    before = _kernels.launch_counts()
    y = fused_bn.bn_copy(x, ng)
    assert _kernels.launch_counts() == before     # CPU: no kernel
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_bn_copy_refuses_what_k1_refuses():
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        fused_bn.bn_copy(torch.zeros(4, 3, 2), 2)
    with pytest.raises(ValueError, match="does not divide"):
        fused_bn.bn_copy(torch.zeros(6, 3, 2, 2), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bn.bn_copy(torch.zeros(4, 3, 2, 2, dtype=torch.float16), 2)


def test_tool_shapes_are_the_jax_tools():
    assert _load("bn_kernel_bench_torch").SHAPES == \
        _load("bn_kernel_bench").SHAPES


def test_tool_legs():
    legs = _load("bn_kernel_bench_torch").legs
    shapes = [(8, 64, 2, 2), (8, 128, 2, 2)]
    assert legs(shapes, False, False) == [(8, 64, 2, 2, False, False),
                                          (8, 128, 2, 2, False, False)]
    assert legs(shapes, True, True)[1:] == [(8, 128, 2, 2, False, False),
                                            (8, 128, 2, 2, True, False),
                                            (8, 128, 2, 2, True, True)]


def test_dry_run_rows_keep_the_jax_tools_schema(capsys):
    _load("bn_kernel_bench_torch").main(["--dry-run", "--format", "json"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "bn_kernel_bench.py"),
         "--dry-run", "--format", "json"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    ref = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == len(ref) == 7
    want_keys = [k.replace("stock_xla", "plain_torch") for k in ref[0]]
    for row, r in zip(rows, ref):
        assert list(row) == want_keys
        assert (row["residual"], row["dual"]) == (r["residual"], r["dual"])
        assert row["variant"] == "k1" and row["bwd_variant"] == "k2"
        assert all(row[k] > 0 for k in row if k.endswith("_ms"))


def test_table_format_and_out_file(tmp_path, capsys):
    path = tmp_path / "rows.jsonl"
    _load("bn_kernel_bench_torch").main(["--dry-run", "--out", str(path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split()[:3] == ["shape", "residual", "dual"]
    assert len(lines) == 8
    assert len(path.read_text().splitlines()) == 7
