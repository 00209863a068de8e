"""Ablation breakdown of the fused radix kernel's time, on one CUDA GPU.

    python3 -m wrp_tpu_torch.tools.kernel_breakdown [--batch 16] [--distinct 2]
        [--repeats 128] [--modes dots,splits,combine,full]
    python3 -m wrp_tpu_torch.tools.kernel_breakdown --smoke --device cpu

Counterpart of ``tools/kernel_breakdown.py`` (the JAX tool), with its
flags, staging, modes and JSON line.  It times four kernels that read the
same staged input, each step i reading slab i mod D through the offset
entry at salt i, and that drop successive parts of the TPU algorithm's
work:

  dots     int16 -> f32, the salt, bf16 hi planes only ([xh; xh; xh]
           stacks), the 24 dots against the kcat operator [ah | ah | al];
           every branch consumed by a row sum, no combine
  splits   + the real hi/lo splits ([xh; xl; xh])
  combine  + the radix combine Y_s = sum_p fac[s][p] g_p, row sums of
           Yr + Yi
  full     + the Parseval epilogue: the whole salted chain

All four are ONE body (csrc/kernel_breakdown.cu: bf16 wgmma on the tensor
cores, the operator streamed by TMA, a cluster of the unit's pulse tiles
merging each row), on one grid at one dynamic shared memory, so at one
occupancy (`blocks_per_sm`).  The deltas attribute the time per
channel-step as the JAX tool does: `mxu_dma_cast_floor` = dots,
`lo_splits` = splits - dots, `butterfly_combine` = combine - splits,
`epilogue` = full - combine.  Beside them `astage` times the matrix-form
A-stage of csrc/radix_chain.cuh (fp32 SIMT; Y stored to device memory) on
the same slabs (unsalted), and `astage_at_fused_smem` again at the
breakdown body's dynamic shared memory (`fused_smem_bytes`).  On the card
the line also holds `sass`, each body's SASS instruction counts (HGMMA and
the others of SASS_OPCODES): equal HGMMA counts show that no mode's dots
were compiled away.

`--smoke` is the tiny geometry with one repeat, for `--device cpu`, where
the plain versions run (`blocks_per_sm` and `sass` are then null).
Without CUDA and without `--device cpu` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="python3 -m wrp_tpu_torch.tools.kernel_breakdown",
        description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16, help="sectors per step")
    ap.add_argument("--distinct", type=int, default=2,
                    help="distinct staged slabs cycled by the steps")
    ap.add_argument("--repeats", type=int, default=128,
                    help="passes over the slabs per timed span")
    ap.add_argument("--modes", default="dots,splits,combine,full",
                    help="comma list of dots, splits, combine, full")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry, 1 repeat (with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    from ..ops.probes import ABLATION_MODES

    args.modes = args.modes.split(",")
    bad = [m for m in args.modes if m not in ABLATION_MODES]
    if bad:
        ap.error(f"unknown modes {bad}; modes {', '.join(ABLATION_MODES)}")
    if args.smoke:
        args.repeats = 1
    return ap, args


#: the instructions `sass_counts` counts per body ("all": every one)
SASS_OPCODES = ("all", "HGMMA", "FFMA", "FADD", "FMUL", "LDG", "LDS", "STS",
                "BAR", "SHFL")


def sass_counts(plan) -> dict:
    """SASS instructions (SASS_OPCODES) of each body the tool launches:
    {dots, splits, combine, full, astage: {opcode: n}}; the modes are
    breakdown_kernel<mode> of csrc/kernel_breakdown.cu, the A-stage the
    matrix-form body at the plan's (radix, tile)."""
    from ..ops import _build, fullchain, probes
    from .kernel_ab import sass_opcode_counts

    counts = sass_opcode_counts(_build.library_path(),
                                Path(_build._nvcc()).parent, SASS_OPCODES,
                                only=("breakdown_kernel", "radix_chain_kernel"))
    S, Ta = plan.radix // 2, fullchain.astage_tile(plan)
    want = {mode: rf"breakdown_kernel<{v}>$" for mode, v in probes._MODE.items()}
    want["astage"] = (rf"radix_chain_kernel<wrp::PlanarSource<short>\s*,\s*{S}"
                      rf"\s*,\s*{Ta}\s*>")
    out = {}
    for mode in (*probes.ABLATION_MODES, "astage"):
        pat = re.compile(want[mode])
        hits = [v for k, v in counts.items() if pat.search(k)]
        if len(hits) != 1:
            raise RuntimeError(f"sass_counts: {len(hits)} kernels match {mode}")
        out[mode] = hits[0]
    return out


def run(argv=None) -> dict:
    """Run the breakdown; returns the dict that `main` prints.  Refusals
    exit 2 (argparse)."""
    from ..bench import card_name
    from ..config import DEFAULT_CONFIG, tiny_config
    from ..constants import PipelineConstants
    from ..ops import probes
    from ._common import best_of, device_of

    ap, args = _args(argv)
    dev = device_of(ap, args.device)
    cfg = tiny_config() if args.smoke else DEFAULT_CONFIG
    bp = probes.breakdown_plan(PipelineConstants.build(cfg), dev)
    plan = bp.plan
    c, m, n = cfg.sector_shape
    bcn = args.batch * c
    D = args.distinct
    steps = D * args.repeats
    rng = np.random.default_rng(0)
    x_all = torch.from_numpy(rng.integers(-8192, 8192, (D * bcn, 2, m, n),
                                          dtype=np.int16)).to(dev)
    on_card = dev.type == "cuda"

    def measure(step):
        last = []

        def span():
            for i in range(steps):
                last[:] = [step(i)]
        dt, runs = best_of(span, dev)
        if not bool(torch.isfinite(last[0]).all()):
            raise RuntimeError("non-finite output")
        return {"us_per_channel_step": round(dt / (steps * bcn) * 1e6, 3),
                "ms_per_launch": round(dt / steps * 1e3, 4),
                "sectors_per_second": round(steps * args.batch / dt, 0),
                "runs_s": [round(r, 4) for r in runs]}

    out = {"device": card_name(dev), "geometry": f"{c}x{m}x{n}",
           "batch": args.batch, "steps": steps}
    for mode in args.modes:
        out[mode] = measure(lambda i, mode=mode: probes.radix_chain_ablation(
            x_all, bp, mode, (i % D) * bcn, bcn, i))
        out[mode]["blocks_per_sm"] = (probes.blocks_per_sm(plan, mode)
                                      if on_card else None)
        print(f"{mode}: {out[mode]}", file=sys.stderr)
    smem = probes.fused_smem_bytes(plan)
    for key, min_smem in (("astage", 0), ("astage_at_fused_smem", smem)):
        out[key] = measure(lambda i, min_smem=min_smem: probes.radix_chain_astage(
            x_all[(i % D) * bcn:(i % D + 1) * bcn], plan, min_smem))
        out[key]["blocks_per_sm"] = (probes.blocks_per_sm(plan, "astage", min_smem)
                                     if on_card else None)
        print(f"{key}: {out[key]}", file=sys.stderr)
    out["fused_smem_bytes"] = smem

    d = {k: out[k]["us_per_channel_step"] for k in args.modes}
    if len(d) == 4:
        out["attribution_us"] = {
            "mxu_dma_cast_floor": d["dots"],
            "lo_splits": round(d["splits"] - d["dots"], 3),
            "butterfly_combine": round(d["combine"] - d["splits"], 3),
            "epilogue": round(d["full"] - d["combine"], 3),
        }
    out["sass"] = sass_counts(plan) if on_card else None
    return out


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
