"""The int16 -> bf16 hi/lo split and its two tensor-core dots, on one CUDA
GPU.

    python3 -m wrp_tpu_torch.tools.int_split_repro [--variant int|f32]
        [--m 128] [--n 512]
    python3 -m wrp_tpu_torch.tools.int_split_repro --smoke     # the CPU

Counterpart of ``tools/int_split_repro.py`` (the JAX tool), with its flags
and JSON line: an int16 plane x [m, n] (seeded, the 14-bit ADC range) is
split into bf16 hi/lo planes and dotted with a bf16 operator A [m, m],
out = A @ hi + A @ lo (`ops.probes.int_split_dot`, csrc/int_split.cu).
`--variant int` splits with integer masks (lo = v & 63, hi = v - lo),
`f32` by casts (h = bf16(v), l = bf16(v - h)).

The line holds `variant`, `repro`, `backend` (the card's name and power
limit, or "cpu"), `rel_l2_vs_f32_matmul` (against torch.matmul of A and x
in float32, TF32 off), `ok` (under the JAX tool's 2e-2), `us_per_call`
(CUDA events over many calls) and `split_exact` (hi + lo == v for every
sample of x).  The exit code is 0 when `ok`, else 1.

The JAX tool reproduced a TPU compiler crash on the mask split: it caught
every exception as the repro and exited 2.  Here a build or launch failure
is a fault of the kernel, so nothing is caught: it raises and the exit code
is non-zero, and `repro` is always false.  `--smoke` runs the plain
version on the CPU; without CUDA and without `--smoke` (or `--device cpu`)
it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: the JAX tool's bound on the split product (`ok`)
TOL = 2e-2
CALLS = 200     # calls per timed span


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m wrp_tpu_torch.tools.int_split_repro",
        description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="int", choices=["int", "f32"])
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--smoke", action="store_true",
                    help="the CPU (the plain version): --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.device = "cpu"
    return ap, args


def run(argv=None) -> dict:
    """Run the check; returns the dict that `main` prints."""
    from ..bench import card_name
    from ..ops import probes
    from ._common import best_of, device_of

    ap, args = _args(argv)
    dev = device_of(ap, args.device)
    m, n = args.m, args.n
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-8192, 8192, (m, n), dtype=np.int16)).to(dev)
    a = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)
                         ).to(torch.bfloat16).to(dev)
    out = probes.int_split_dot(x, a, args.variant)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.matmul(a.float(), x.float())
    err = float((out.double() - ref.double()).norm() / ref.double().norm())

    def calls():
        for _ in range(CALLS):
            probes.int_split_dot(x, a, args.variant)
    dt, _ = best_of(calls, dev)
    return {
        "variant": args.variant,
        "repro": False,
        "backend": card_name(dev),
        "rel_l2_vs_f32_matmul": err,
        "ok": err < TOL,
        "us_per_call": round(dt / CALLS * 1e6, 3),
        "split_exact": probes.split_inexact_count(x, args.variant) == 0,
    }


def main(argv=None) -> int:
    r = run(argv)
    print(json.dumps(r), flush=True)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
