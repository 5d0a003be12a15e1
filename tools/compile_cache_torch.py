#!/usr/bin/env python
"""Damage the built kernel library and watch the compile cache rebuild it
(``parallel/aot.py`` ``CompileCache``, ``_kernels.build``).

Each step runs in a fresh process, as a restarted job would:

1. build (or find) the library: the cache's counters and the seconds;
2. ``fault_injection.corrupt_compile_cache(what=--what)`` damages it;
3. build again: a warning, the damaged entry dropped and rebuilt, never
   loaded (``dropped`` 1, the seconds of the rebuild);
4. build again: a hit, no build.

Prints one JSON line a step and exits 1 if a step broke the contract.
Needs ``nvcc`` (the card's host)::

  python3 tools/compile_cache_torch.py --what truncate
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STEP = r"""
import json, sys, time, warnings
sys.path.insert(0, %r)
from incubator_mxnet_tpu_torch import _kernels
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    t0 = time.perf_counter()
    built = _kernels.build()
    wall = time.perf_counter() - t0
cache = _kernels.compile_cache()
print(json.dumps({"build_s": built, "wall_s": wall,
                  "counters": cache.counters(),
                  "entry": cache.path(_kernels._source_key()),
                  "warnings": [str(x.message) for x in w
                               if "compile cache" in str(x.message)]}))
""" % ROOT


def _step(tag):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _STEP], capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit("%s: the build process failed:\n%s"
                         % (tag, out.stderr[-3000:]))
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec.update(step=tag, process_s=round(time.perf_counter() - t0, 3))
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", default="truncate",
                    choices=("truncate", "bitflip", "garbage"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from incubator_mxnet_tpu_torch import _kernels
    from incubator_mxnet_tpu_torch.parallel import fault_injection as fi

    first = _step("build")
    directory = str(_kernels._BUILD_DIR)
    # the directory may hold other source trees' libraries: damage this one
    entries = sorted(n for n in os.listdir(directory)
                     if n.endswith(".so") and ".tmp." not in n)
    touched = fi.corrupt_compile_cache(
        directory, what=args.what,
        which=entries.index(os.path.basename(first["entry"])))
    print(json.dumps({"step": "corrupt", "what": args.what,
                      "path": touched,
                      "bytes": os.path.getsize(touched)}), flush=True)
    rebuilt = _step("after_" + args.what)
    again = _step("again")
    failures = []
    if rebuilt["counters"]["dropped"] != 1 or not rebuilt["warnings"] \
            or rebuilt["build_s"] <= 0:
        failures.append("the damaged library was not dropped and rebuilt")
    if again["counters"] != {"hits": 1, "misses": 0, "dropped": 0,
                             "store_failures": 0} or again["build_s"] != 0:
        failures.append("the rebuilt library was not a hit")
    print(json.dumps({"step": "verdict", "failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
