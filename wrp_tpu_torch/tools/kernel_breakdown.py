"""Ablation breakdown of the fused radix kernel's time, on one CUDA GPU.

    python3 -m wrp_tpu_torch.tools.kernel_breakdown [--batch 16] [--distinct 2]
        [--repeats 128] [--modes dots,combine,full]
    python3 -m wrp_tpu_torch.tools.kernel_breakdown --smoke --device cpu

Counterpart of ``tools/kernel_breakdown.py`` (the JAX tool), with its
flags, staging and JSON line.  It times three kernels that read the same
staged input, each step i reading slab i mod D through the offset entry at
salt i, and that drop successive parts of the work:

  dots     the contraction (loads, int16 -> f32, the salt, the branch
           contractions); each g_p is added onto the Y rows of block
           p mod S (g_s + g_{s+S} per row, no combine), stored to shared
           memory, and a warp sums each row
  combine  + the radix combine, with the same store and row sum
  full     + the Parseval epilogue: the whole matrix-form chain

All three are ONE body, the TPU algorithm's matrix form of the salted
radix chain (csrc/radix_chain.cuh, the port's first production kernel; the
production chain now runs in FFT form, csrc/fft_chain.cuh), launched from
csrc/kernel_breakdown.cu on its grid with its dynamic shared memory, so at
its occupancy (`blocks_per_sm` from
cudaOccupancyMaxActiveBlocksPerMultiprocessor).  The deltas attribute the
time per channel-step: `dots_floor` (loads, conversion and the
contraction), `butterfly_combine` = combine - dots, `epilogue` = full -
combine.  Beside them `astage` times that body's A-stage on the same slabs
(unsalted): the same contraction and combine with Y stored to device
memory and 8 KB of shared memory per block; `astage_at_fused_smem` times
it again requesting the full body's dynamic shared memory
(`fused_smem_bytes`), so at the full body's blocks per SM: the direct
test of whether shared memory sets that body's pace.  On the card
the line also holds `sass`, each body's SASS instruction counts (FFMA and
the others of SASS_OPCODES), which show that no mode's contraction was
compiled away.

The JAX tool's `splits` mode (the bf16 hi/lo operand split) has no
counterpart, since the port's chain contracts in fp32: asking for it exits
2.  `--smoke` is the tiny geometry with one repeat, for `--device cpu`,
where the plain versions run (`blocks_per_sm` and `sass` are then null).
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
    ap.add_argument("--modes", default="dots,combine,full",
                    help="comma list of dots, combine, full")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry, 1 repeat (with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    from ..ops.probes import ABLATION_MODES, SPLITS_REFUSAL

    args.modes = args.modes.split(",")
    if "splits" in args.modes:
        ap.error(SPLITS_REFUSAL)
    bad = [m for m in args.modes if m not in ABLATION_MODES]
    if bad:
        ap.error(f"unknown modes {bad}; modes {', '.join(ABLATION_MODES)}")
    if args.smoke:
        args.repeats = 1
    return ap, args


#: the instructions `sass_counts` counts per body ("all": every one)
SASS_OPCODES = ("all", "FFMA", "FADD", "FMUL", "LDG", "LDS", "STS", "BAR")


def sass_counts(plan) -> dict:
    """SASS instructions (SASS_OPCODES) of each body the tool launches, at
    the plan's (radix, tile): {dots, combine, full, astage: {opcode: n}}."""
    from ..ops import _build, fullchain
    from .kernel_ab import sass_opcode_counts

    counts = sass_opcode_counts(_build.library_path(),
                                Path(_build._nvcc()).parent, SASS_OPCODES)
    S, T = plan.radix // 2, fullchain.kernel_tile(plan)
    Ta = fullchain.astage_tile(plan)
    salted = (r"wrp::Salted<wrp::PlanarSource<short>\s*>", T)
    want = {"dots": salted + (2,), "combine": salted + (3,),
            "full": salted + (0,),
            "astage": (r"wrp::PlanarSource<short>", Ta, 1)}
    out = {}
    for mode, (src, tile, body) in want.items():
        pat = re.compile(rf"radix_chain_kernel<{src}\s*,\s*{S}\s*,\s*{tile}\s*,"
                         rf"\s*body{body}\s*>")
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
    from ..ops import fullchain, probes
    from ._common import best_of_3, device_of

    ap, args = _args(argv)
    dev = device_of(ap, args.device)
    cfg = tiny_config() if args.smoke else DEFAULT_CONFIG
    plan = fullchain.build_plan(PipelineConstants.build(cfg), dev)
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
        dt, runs = best_of_3(span, dev)
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
            x_all, plan, mode, (i % D) * bcn, bcn, i))
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
    if len(d) == 3:
        out["attribution_us"] = {
            "dots_floor": d["dots"],
            "butterfly_combine": round(d["combine"] - d["dots"], 3),
            "epilogue": round(d["full"] - d["combine"], 3),
        }
    out["sass"] = sass_counts(plan) if on_card else None
    return out


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
