#!/usr/bin/env python3
"""Two probes behind the model-parallel path's numbers (card only).

``--collectives`` (run as two ranks: ``python3 tools/launch.py -n 2
python3 tools/torch_mp_probe.py --collectives``): the ms of the
differentiable ``collectives.ppermute`` and ``collectives.alltoall`` on
one K/V block of the long-context LM at sp=2, (4, 8, 1024, 128) f32,
between two ranks sharing the card over gloo (3 calls each, the first
warming up), and whether gloo takes ``all_to_all_single`` on CUDA
tensors.

``--embedding`` (one process): whether the gradient of an embedding
gather repeats bit for bit on the card, by three routes (``F.embedding``,
indexing, ``index_add_``) at the LM's (4, 2048) tokens, vocab 256, width
1024: the distinct results of 5 calls each, and the ms a call.

Prints the card's name and power limit first.
"""
import argparse
import hashlib
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch
import torch.nn.functional as F


def _digest(t):
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()


def _ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def collectives_probe():
    from incubator_mxnet_tpu_torch.parallel import collectives, distributed
    from incubator_mxnet_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize()
    dev = distributed.local_device()
    torch.cuda.set_device(dev)
    rank = distributed.process_index()
    mesh = make_mesh({"sp": distributed.process_count()})
    n = mesh.shape["sp"]
    block = torch.randn(4, 8, 1024, 128, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for name, fn in (
            ("ppermute", lambda: collectives.ppermute(block, "sp", perm,
                                                      mesh)),
            ("alltoall", lambda: collectives.alltoall(
                block, "sp", split_axis=1, concat_axis=2, mesh=mesh))):
        ms = [_ms(fn, 1) for _ in range(3)]
        print("rank %d backend %s %s of %.1f MB: %s ms" % (
            rank, distributed.backend(), name, block.numel() * 4 / 1e6,
            ["%.1f" % v for v in ms]), flush=True)
    distributed.barrier("probe")


def embedding_probe():
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    # the LM's tokens: next = (2 t + 1) mod 256 falls to 255 within 8
    # steps, so nearly every index repeats one row
    tok = torch.randint(0, 256, (4, 1), generator=g, device=dev)
    rows = [tok]
    for _ in range(2047):
        rows.append((rows[-1] * 2 + 1) % 256)
    idx = torch.cat(rows, dim=1)
    w = torch.randn(256, 1024, generator=g, device=dev, requires_grad=True)
    go = torch.randn(4, 2048, 1024, generator=g, device=dev)
    routes = {
        "F.embedding": lambda: torch.autograd.grad(F.embedding(idx, w), w,
                                                   go)[0],
        "indexing": lambda: torch.autograd.grad(w[idx], w, go)[0],
        "index_add_": lambda: torch.zeros_like(w).index_add_(
            0, idx.reshape(-1), go.reshape(-1, 1024)),
    }
    for name, fn in routes.items():
        distinct = len({_digest(fn()) for _ in range(5)})
        print("%-12s distinct results in 5 calls: %d  %.3f ms a call"
              % (name, distinct, _ms(fn, 20)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--embedding", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mp_probe: no CUDA device", file=sys.stderr)
        return 2
    if os.environ.get("DMLC_WORKER_ID", "0") == "0":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    if args.collectives:
        collectives_probe()
    if args.embedding:
        embedding_probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
