#!/usr/bin/env python3
"""A/B timing of the port's kernels across source trees, on one GPU.

    python3 wrp_tpu_torch/tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
`git archive` into a git-ignored directory); each runs in its own process,
in the order given, so list them in turns (parent, change, change, parent)
to separate a code change from drift.  For each it builds the tree's kernel
library and prints one JSON line: the card, the CUDA-event ms per call of
the radix kernel (int16 and f32 input) and the wire kernel at 16 sectors
of 3 x 1024 x 512, and, where the tree has them, the A-stage kernel at
w = 512 and the row-epilogue kernel on its Y, each with its rel-L2 against
the plain version, and the A-stage at each tile height it is built for
(the sweep that chose `fullchain.astage_tile`).  Needs CUDA; imports only
the tree's wrp_tpu_torch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from wrp_tpu_torch import oracle
    from wrp_tpu_torch.config import DEFAULT_CONFIG as cfg
    from wrp_tpu_torch.constants import PipelineConstants
    from wrp_tpu_torch.io import codec
    from wrp_tpu_torch.ops import _build, device_codec, fullchain

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA GPU")
    _build.load_library()
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")
    noise = [oracle.synthetic_iq(cfg, kind="noise", seed=2024 + b)
             for b in range(16)]
    x16 = torch.from_numpy(np.stack([
        np.stack([s.real, s.imag], -3).astype(np.int16) for s in noise
    ])).cuda().reshape(-1, 2, cfg.m, cfg.n)

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def rel(ref, got):
        return float((got.double() - ref.double()).norm() / ref.double().norm())

    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    out["radix_ms"] = ms(lambda: fullchain.fused_chain_power_radix(x16, plan))
    xf = x16.float()
    out["radix_f32_ms"] = ms(lambda: fullchain.fused_chain_power_radix(xf, plan))
    out["radix_rel"] = rel(fullchain.fused_chain_power_reference(x16, plan),
                           fullchain.fused_chain_power_radix(x16, plan))
    wplan = fullchain.build_plan(consts, "cuda", channels=cfg.num_channels)
    wires = np.stack([np.frombuffer(codec.encode_iq(s, cfg), np.uint8)
                      for s in noise])
    w32 = device_codec.wire_words_i32(torch.from_numpy(wires).cuda(),
                                      cfg).contiguous()
    out["wire_ms"] = ms(lambda: fullchain.fused_chain_power_wire(
        w32, wplan, cfg.num_channels))
    if hasattr(fullchain, "fused_chain_astage"):
        y = fullchain.fused_chain_astage(x16, plan)
        out["astage_ms"] = ms(lambda: fullchain.fused_chain_astage(x16, plan))
        out["astage_rel"] = rel(
            fullchain.fused_chain_astage_reference(x16, plan), y)
        out["rows_ms"] = ms(lambda: fullchain.parseval_rows_power(y, plan))
        out["rows_rel"] = rel(fullchain.parseval_rows_power_reference(y, plan),
                              fullchain.parseval_rows_power(y, plan))
        out["astage_tiles"] = _astage_tiles(x16, plan, y, ms, rel)
    return out


def _astage_tiles(x16, plan, y_default, ms, rel) -> dict:
    """The A-stage kernel at every instantiated tile height T, through the
    library's entry (the wrapper always takes `astage_tile`): {"T=t":
    [ms, rel-L2 vs the default tile's Y]}."""
    import torch

    from wrp_tpu_torch.ops import _build, fullchain

    lib = _build.load_library()
    bc, w = x16.shape[0], x16.shape[3]
    y = torch.empty_like(y_default)

    def launch(tile):
        rc = lib.wrp_fused_chain_astage(
            x16.data_ptr(), 1, plan.a_kernel.data_ptr(), plan.fac_t.data_ptr(),
            y.data_ptr(), bc, plan.m, w, plan.radix, tile,
            torch.cuda.current_stream().cuda_stream)
        fullchain._raise_on_error(lib, rc, "fused_chain_astage")

    out = {}
    for tile in fullchain.KERNEL_TILES:
        if (plan.m // plan.radix) % tile == 0:
            launch(tile)
            err = rel(y_default, y)
            out[f"T={tile}"] = [ms(lambda: launch(tile)), err]
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(_measure(argv[2])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv[1:]:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], timeout=600)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
