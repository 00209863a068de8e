"""Tensor-core throughput against dot width at the chain kernel's operand
shapes, on one CUDA GPU.

    python3 -m wrp_tpu_torch.tools.mxu_occupancy [--widths 512,1024,2048]
        [--m 128] [--k 384] [--lanes-total 12288] [--steps 512] [--distinct 4]
    python3 -m wrp_tpu_torch.tools.mxu_occupancy --device cpu --m 8 --k 16 \\
        --widths 16,32 --lanes-total 64 --steps 2 --distinct 2

Counterpart of ``tools/mxu_occupancy.py`` (the JAX tool), with its flags
and JSON line.  Each step dots ndots = lanes_total / width bf16 operators
A_d [m, k] with the `width` columns of one staged X slab [k, width] (slab b
mod distinct, so consecutive steps read different data) and writes the row
sums of the summed products: the same multiply-adds per step at every
width.  The kernel (`ops.probes.tc_dot_probe`, csrc/tc_occupancy.cu: bf16
wgmma fed by TMA) keeps 256 rows of the stacked A_d resident per block
and streams the slabs' columns past them, so the sweep measures what
operand reuse buys on the tensor cores.

Per width: `us_per_step`, `effective_tmacs`, `runs_s` (best of 3 spans of
one launch of `steps` steps, CUDA events) and `tensor_core_utilisation`,
against the H100 SXM data sheet's dense bf16 peak, 989.4 TFLOP/s: it
replaces the JAX tool's `mxu_utilisation` against TPU v5e's 197 TFLOP/s.
`library_us_per_step` times torch.matmul on the same bf16 operands and
slabs, batched [ndots, m, k] @ [k, width], one call per step, replayed
from a CUDA graph so that the host's issue rate does not set it (the
library's yardstick; the port never calls it).  It writes [ndots, m,
width] a step, which the probe never does; `library_kcat_us_per_step`
times the same multiply-adds as one GEMM a step, [m, ndots k] @ [ndots k,
width] (`library_kcat_steps`), whose [m, width] output is the probe's sum
over dots.  `device` names the card.
On the CPU (`--device cpu`) the plain version runs and
`tensor_core_utilisation` is null.  Without CUDA and without `--device
cpu` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), FLOP/s
PEAK_BF16 = 989.4e12


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m wrp_tpu_torch.tools.mxu_occupancy",
        description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="512,1024,2048")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--k", type=int, default=384)
    ap.add_argument("--lanes-total", type=int, default=24 * 512,
                    help="lanes dotted per step (equal MACs across widths); "
                         "default = the chain kernel's 24 dots x 512 lanes "
                         "per channel-step")
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--distinct", type=int, default=4,
                    help="distinct staged X slabs cycled by the steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    args.widths = [int(w) for w in args.widths.split(",")]
    if any(args.lanes_total % w for w in args.widths):
        ap.error(f"every width must divide --lanes-total {args.lanes_total}")
    return ap, args


def library_steps(a, x, width: int, steps: int, distinct: int, ndots: int):
    """fn() running the library's yardstick: one torch.matmul per step,
    a[:ndots] @ the step's slab.  On the card the calls are captured once
    in a CUDA graph and fn replays it, so the time is the device's, not
    that of issuing 512 calls from Python."""
    wmax = x.shape[1] // distinct

    def calls():
        for b in range(steps):
            c0 = (b % distinct) * wmax
            torch.matmul(a[:ndots], x[:, c0:c0 + width])

    return _graphed(calls, a.device)


def kcat_operands(a, x, ndots: int):
    """(a_cat [m, ndots k], x_rep [ndots k, cols]): the A_d side by side and
    X stacked ndots times, so that a_cat @ x_rep[:, slab] = sum_d A_d @
    X[:, slab], the probe's multiply-adds in one GEMM."""
    m, k = a.shape[1], a.shape[2]
    return (a[:ndots].permute(1, 0, 2).reshape(m, ndots * k).contiguous(),
            x.repeat(ndots, 1))


def library_kcat_steps(a, x, width: int, steps: int, distinct: int,
                       ndots: int):
    """fn() running the second yardstick: one GEMM a step, a_cat @
    x_rep[:, slab] (`kcat_operands`, built once here, outside the timed
    calls) -> [m, width].  On the card the calls replay from a CUDA graph,
    as `library_steps`'s do."""
    wmax = x.shape[1] // distinct
    a_cat, x_rep = kcat_operands(a, x, ndots)

    def calls():
        for b in range(steps):
            c0 = (b % distinct) * wmax
            torch.matmul(a_cat, x_rep[:, c0:c0 + width])

    return _graphed(calls, a.device)


def _graphed(calls, dev):
    """calls, or on the card a replay of them captured in a CUDA graph
    (cuBLAS warmed on a side stream first)."""
    if dev.type != "cuda":
        return calls
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        calls()
    return graph.replay


def run(argv=None) -> dict:
    """Run the sweep; returns the dict that `main` prints."""
    from ..bench import card_name
    from ..ops import probes
    from ._common import best_of, device_of

    ap, args = _args(argv)
    dev = device_of(ap, args.device)
    m, k, widths = args.m, args.k, args.widths
    wmax = max(widths)
    ndots_max = args.lanes_total // min(widths)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((ndots_max, m, k), dtype=np.float32)
                         ).to(torch.bfloat16).to(dev)
    x = torch.from_numpy(rng.standard_normal((k, args.distinct * wmax),
                                             dtype=np.float32)
                         ).to(torch.bfloat16).to(dev)
    macs = m * k * args.lanes_total * args.steps
    out = {"m": m, "k": k, "lanes_total": args.lanes_total,
           "steps": args.steps, "device": card_name(dev)}
    for width in widths:
        ndots = args.lanes_total // width
        res = []

        def kernel():
            res[:] = [probes.tc_dot_probe(a, x, width, args.steps,
                                          args.distinct, args.lanes_total)]

        dt, runs = best_of(kernel, dev)
        if not bool(torch.isfinite(res[0]).all()):
            raise RuntimeError(f"width {width}: non-finite output")
        lib_dt, _ = best_of(library_steps(a, x, width, args.steps,
                                            args.distinct, ndots), dev)
        kcat_dt, _ = best_of(library_kcat_steps(a, x, width, args.steps,
                                                  args.distinct, ndots), dev)
        out[f"n{width}"] = {
            "us_per_step": round(dt / args.steps * 1e6, 3),
            "effective_tmacs": round(macs / dt / 1e12, 2),
            "tensor_core_utilisation": (round(2 * macs / dt / PEAK_BF16, 3)
                                        if dev.type == "cuda" else None),
            "runs_s": [round(r, 4) for r in runs],
            "library_us_per_step": round(lib_dt / args.steps * 1e6, 3),
            "library_kcat_us_per_step": round(kcat_dt / args.steps * 1e6, 3),
        }
        print(f"N={width}: {out[f'n{width}']}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
