"""One staging of the bench's int16 slabs, the port's four routes to the
flagship power, timed one after another.  Counterpart of
``tools/ab_sweep.py``.

The JAX tool sweeps its radix kernel's TPU formulation knobs (xsplit, pair,
a_layout); the CUDA kernels have none of them.  This tool sweeps the routes
that `bench` reaches through `--in-dtype` and `--wire-decode`, all from one
staging of the slabs the bench stages (seeded as it seeds them):

  i16       #4, the salted radix offset entry (csrc/fused_chain_radix_
            salted.cu), on the int16 slabs
  f32       #4 on an f32 copy of the slabs, made on the device
  wire      #8, the salted wire offset entry (csrc/fused_chain_wire_
            salted.cu), on wire words encoded on the device from the slabs
  wire_xla  the torch decode of those wire bytes, then #4

Each variant runs the bench's own harness (`bench.pallas_step_power`,
`bench.salted_pass`, `bench.harness_parity`): step i reads slab i % D in
place through the offset entry with salt i, every step's products feed one
device accumulator, one D2H fetch closes the span; best of 3 spans.  Before
a variant is timed, its gate: the harness at salt 0 and at salt 7 against
the unsalted SectorProcessor(method="pallas") on slab 0, zdb rel-L2 under
1e-4 and 1e-3; a variant that misses it is not timed.

Prints one JSON line per variant and a summary line.  Exits 1 when a
variant misses its gate or a variant is unknown; an exception ends the run
with a traceback (the JAX tool records it and sweeps on).

    python -m wrp_tpu_torch.tools.ab_sweep                  # the card
    python -m wrp_tpu_torch.tools.ab_sweep --variants i16,wire --repeats 8
    python -m wrp_tpu_torch.tools.ab_sweep --smoke --device cpu   # plumbing
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import bench
from ..config import DEFAULT_CONFIG, tiny_config
from ..constants import PipelineConstants
from ..ops import fullchain
from ..pipeline import SectorProcessor

#: name -> (bench --in-dtype, bench --wire-decode)
VARIANTS = {
    "i16": ("i16", None),
    "f32": ("f32", None),
    "wire": ("wire", "fused"),
    "wire_xla": ("wire", "xla"),
}
GATE = (1e-4, 1e-3)       # the bench's: salt 0, salted


def wire_bytes(x: torch.Tensor) -> torch.Tensor:
    """Planar int16 [S, C, 2, m, n] -> the reference wire uint8 [S, m*n*C*4]
    on x's device: `bench._wire_bytes` (interleaved big-endian int16,
    natural row order) without the host."""
    s = x.shape[0]
    le = x.permute(0, 3, 4, 1, 2).contiguous()
    return le.view(torch.uint8).reshape(*le.shape, 2).flip(-1).reshape(s, -1)


class Sweep:
    """The bench's slabs staged once on `device` ([D, B, C, 2, m, n] int16,
    the bench's seed), the stagings derived from them on the device, and
    each variant's harness over them."""

    def __init__(self, cfg, batch: int, distinct: int, repeats: int,
                 device):
        self.cfg, self.B, self.D = cfg, batch, distinct
        self.steps = distinct * repeats
        self.dev = torch.device(device)
        c, m, n = cfg.sector_shape
        rng = np.random.default_rng(0)
        host = rng.integers(-8192, 8192, (distinct, batch, c, 2, m, n),
                            dtype=np.int16)
        self.x = torch.from_numpy(host).to(self.dev)
        consts = PipelineConstants.build(cfg)
        self.plan = fullchain.build_plan(consts, self.dev)
        if self.plan.radix == 1:
            raise ValueError(f"m={m} takes the dense kernel: no wire route "
                             "to sweep")
        self.proc = SectorProcessor(cfg, method="pallas", device=self.dev,
                                    consts=consts)
        self.products = bench.harness_products(
            torch.from_numpy(consts.gain).to(self.dev), batch, c)
        self.acc0 = torch.zeros(cfg.num_output_bins, device=self.dev)
        self._wire = None

    def staging(self, variant: str) -> torch.Tensor:
        """The variant's staged slabs, as the bench stages them for its
        --in-dtype (and --wire-decode), made on the device."""
        in_dtype, decode = VARIANTS[variant]
        if in_dtype == "i16":
            return self.x
        if in_dtype == "f32":
            return self.x.float()
        if self._wire is None:
            c, m, n = self.cfg.sector_shape
            self._wire = wire_bytes(self.x.reshape(self.D * self.B, c, 2,
                                                   m, n))
        return self._wire.view(torch.int32) if decode == "fused" else \
            self._wire

    def step_power(self, variant: str, staged: torch.Tensor):
        in_dtype, decode = VARIANTS[variant]
        return bench.pallas_step_power(
            staged, self.plan, self.cfg, self.D, self.B,
            self.B * self.cfg.num_channels, in_dtype, decode)

    def run(self, variant: str) -> dict:
        """The variant's row: its first pass (with the library build), its
        gate, then 3 timed spans if the gate passed."""
        staged = self.staging(variant)
        step_power = self.step_power(variant, staged)
        timed_pass = bench.salted_pass(step_power, self.products, self.acc0,
                                       self.steps)
        launches0 = (fullchain.RADIX_OFFSET_LAUNCHES,
                     fullchain.WIRE_OFFSET_LAUNCHES)
        t0 = time.perf_counter()
        timed_pass()
        build_s = time.perf_counter() - t0
        err0, err1 = bench.harness_parity(self.proc, self.x[0], step_power,
                                          self.products)
        ok = err0 < GATE[0] and err1 < GATE[1]
        runs = []
        if ok:
            for _ in range(3):
                t0 = time.perf_counter()
                acc = timed_pass()
                runs.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(acc[1:]).all()):
                raise RuntimeError(f"{variant}: non-finite zdb accumulator")
        rate = self.steps * self.B / min(runs) if runs else 0.0
        in_dtype, decode = VARIANTS[variant]
        return {
            "variant": variant,
            "in_dtype": in_dtype,
            "wire_decode": decode,
            "sectors_per_second": round(rate, 2),
            "vs_baseline": round(rate / bench.BASELINE_3CH, 2),
            "parity_rel_l2": [round(err0, 9), round(err1, 9)],
            "parity_ok": ok,
            "timed_runs_s": [round(r, 3) for r in runs],
            "build_s": round(build_s, 1),
            "batch": self.B,
            "steps": self.steps,
            "launches": {
                "radix_offset": fullchain.RADIX_OFFSET_LAUNCHES - launches0[0],
                "wire_offset": fullchain.WIRE_OFFSET_LAUNCHES - launches0[1]},
        }


def run(cfg=DEFAULT_CONFIG, batch: int = 128, distinct: int = 2,
        repeats: int = 48, variants=tuple(VARIANTS), device="cuda",
        emit=None) -> tuple:
    """(rows, summary): one row per variant, in the order given, each
    passed to `emit` as soon as it is measured."""
    sweep = Sweep(cfg, batch, distinct, repeats, device)
    rows = []
    for name in variants:
        rows.append(sweep.run(name))
        if emit is not None:
            emit(rows[-1])
    best = max(rows, key=lambda r: r["sectors_per_second"])
    summary = {"summary": {r["variant"]: r["sectors_per_second"]
                           for r in rows},
               "best": best["variant"],
               "best_sectors_per_second": best["sectors_per_second"],
               "device": bench.card_name(sweep.dev)}
    return rows, summary


def main(argv=None) -> int:
    from ._common import device_of

    ap = argparse.ArgumentParser(prog="python -m wrp_tpu_torch.tools.ab_sweep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--distinct", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=48,
                    help="passes over the slabs (96 steps by default, as "
                         "the bench)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="a comma list of: " + ", ".join(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits 2 without CUDA) or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry, batch 4, 2 repeats: plumbing and "
                         "gates only, the rates mean nothing")
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    for v in names:
        if v not in VARIANTS:
            sys.exit(f"unknown variant {v!r}; pick from {list(VARIANTS)}")
    dev = device_of(ap, args.device)
    cfg = DEFAULT_CONFIG
    if args.smoke:
        cfg = tiny_config(m=256, n=128)
        args.batch, args.repeats = 4, 2
    rows, summary = run(cfg, args.batch, args.distinct, args.repeats, names,
                        dev, emit=lambda r: print(json.dumps(r), flush=True))
    print(json.dumps(summary), flush=True)
    return 0 if all(r["parity_ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
