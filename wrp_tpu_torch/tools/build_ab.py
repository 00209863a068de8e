#!/usr/bin/env python3
"""Wall time of the kernel library's build, every nvcc at once against a
pool bounded by the host's cores, on the machine with the CUDA toolkit.

    python3 -m wrp_tpu_torch.tools.build_ab [--turns N]     (from the repo root)

`ops/_build.py` starts one `nvcc -c` for each source in
``wrp_tpu_torch/csrc/`` together, so a build takes as long as its slowest
source while the host has a core for each.  With more sources than cores
they share the cores.  This tool compiles the same sources with the same
flags into a scratch folder under the git-ignored build directory, in
turns (all, cores, cores, all, for N turns), and prints one JSON line a
build: the pool size, the host's cores, the wall seconds of the compile
step (the link is left out: it is the same for both) and the slowest
source with its own seconds.  The last line holds the best of each pool.
It neither loads nor replaces the library `_build.load_library` uses.
Needs nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from wrp_tpu_torch.ops import _build


def compile_all(workers: int) -> dict:
    """One `nvcc -c` per source with `workers` at a time: {workers,
    wall_s, slowest: [source, s]}."""
    out_dir = _build.BUILD_DIR / f"build_ab.{os.getpid()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    srcs = sorted(_build.CSRC.glob("*.cu"))

    def one(src):
        t0 = time.perf_counter()
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o",
                        str(out_dir / f"{src.stem}.o"), str(src)],
                       check=True, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
        return src.name, time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            each = list(pool.map(one, srcs))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    name, secs = max(each, key=lambda r: r[1])
    return {"workers": workers, "sources": len(srcs), "wall_s": wall,
            "slowest": [name, secs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=1,
                    help="turns of (all, cores, cores, all)")
    args = ap.parse_args(argv)
    cores = os.cpu_count() or 1
    n = len(list(_build.CSRC.glob("*.cu")))
    best = {}
    for _ in range(args.turns):
        for workers in (n, cores, cores, n):
            r = compile_all(workers)
            r["cores"] = cores
            print(json.dumps(r), flush=True)
            best[workers] = min(best.get(workers, r["wall_s"]), r["wall_s"])
    print(json.dumps({"best_wall_s": {str(k): v for k, v in best.items()},
                      "cores": cores, "sources": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
