#!/usr/bin/env python3
"""The pulse-sharded step across N ranks, one process each, held against
the single-device fused chain and timed.

    python3 wrp_tpu_torch/tools/pulse_shard_ranks.py --ranks 4            # N GPUs, NCCL
    python3 wrp_tpu_torch/tools/pulse_shard_ranks.py --ranks 4 --method halo,mxu
    python3 wrp_tpu_torch/tools/pulse_shard_ranks.py --ranks 4 --device cpu --m 128 --n 64

Every rank builds the step of each `--method` (a comma list) over the N
ranks as one seq group, each holding n/N pulses of every sector:
pallas-seq (the default: PulseShardedProcessor(method="pallas"), the
A-stage kernel on its pulses, the all_to_all, the row-epilogue kernel, the
all_gather), mxu and fft (PulseShardedProcessor's transpose-FFT torch
paths) and halo (parallel/halo.py: the B operator's column shard and the
overlap-save matched filter, torch matmuls).  Each rank steps the same
seeded batch and checks the full products against
SectorProcessor(method="pallas") on its own device (zdb/zdr rel-L2 <= 1e-5;
mxu and halo <= 1e-4, the halo's bound in tests/test_sharding.py) and
sector 0 against the fp64 oracle (<= 2e-4), then times `reps` steps of
each (this rank's part of the host batch in, products on the device,
synchronised; wall ms, median).  Rank k runs on cuda:k (NCCL) or the CPU (gloo).  Prints one JSON
line per rank and method and exits non-zero if any check failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

METHODS = ("pallas-seq", "mxu", "fft", "halo")
#: zdb/zdr rel-L2 against the single-device fused chain
TOLERANCE = {"pallas-seq": 1e-5, "fft": 1e-5, "mxu": 1e-4, "halo": 1e-4}


def _rank(args) -> list:
    import numpy as np
    import torch
    import torch.distributed as dist

    from wrp_tpu_torch import oracle
    from wrp_tpu_torch.config import DEFAULT_CONFIG
    from wrp_tpu_torch.io import codec
    from wrp_tpu_torch.ops import fullchain
    from wrp_tpu_torch.parallel import build_halo_processor, make_mesh
    from wrp_tpu_torch.parallel.multihost import (PulseShardedProcessor,
                                                  init_distributed)
    from wrp_tpu_torch.pipeline import SectorProcessor

    torch.set_num_threads(2)
    dev = init_distributed(f"127.0.0.1:{args.port}", args.ranks, args.rank,
                           args.device, timeout_s=300)
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=args.m,
                              num_pulses=args.n)
    iqs = [oracle.produce_sector_iq(cfg, args.seed, j)
           for j in range(args.batch)]
    planar = np.stack([np.stack([iq.real, iq.imag], 1) for iq in iqs]
                      ).astype(np.int16)
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    labels = np.stack([np.arange(args.batch), np.zeros(args.batch)],
                      1).astype(np.int32)
    single = SectorProcessor(cfg, method="pallas", device=dev)
    zdb64, zdr64 = oracle.process_sector(iqs[0], cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wall_ms(fn):
        times = []
        for _ in range(args.reps):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    want_db, want_dr = (t.cpu().numpy() for t in single(planar))
    single_ms = wall_ms(lambda: single(planar))
    rows = []
    for method in args.method.split(","):
        if method == "halo":
            # this rank's pulses cut from the host batch and copied in the
            # step, as PulseShardedProcessor.step_local does for the others
            mesh = make_mesh(seq=args.ranks, device=dev)
            step = build_halo_processor(cfg, mesh)
            n_loc = cfg.n // args.ranks
            cols = slice(mesh.seq_index * n_loc, (mesh.seq_index + 1) * n_loc)

            def run():
                return step(torch.as_tensor(planar)[..., cols].contiguous())
        else:
            proc = PulseShardedProcessor.build(
                cfg, batch=args.batch,
                method="pallas" if method == "pallas-seq" else method,
                device_decode=args.device_decode, device=dev)
            feed = wires if args.device_decode else planar

            def run():
                return proc.step_local(feed, labels=labels)
        fullchain.ASTAGE_LAUNCHES = fullchain.PARSEVAL_ROWS_LAUNCHES = 0
        zdb, zdr = (t.cpu().numpy() for t in run())
        out = {"rank": args.rank, "ranks": args.ranks, "method": method,
               "device": str(dev), "backend": dist.get_backend(),
               "name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "geometry": [cfg.num_channels, cfg.m, cfg.n],
               "batch": args.batch, "device_decode": args.device_decode,
               "zdb_rel_vs_single": oracle.relative_l2(want_db, zdb),
               "zdr_rel_vs_single": oracle.relative_l2(want_dr, zdr),
               "zdb_rel_vs_oracle": oracle.relative_l2(zdb64, zdb[0]),
               "zdr_rel_vs_oracle": oracle.relative_l2(zdr64, zdr[0])}
        out["step_ms"] = wall_ms(run)
        out["single_device_ms"] = single_ms
        out["launches"] = {"astage": fullchain.ASTAGE_LAUNCHES,
                           "rows": fullchain.PARSEVAL_ROWS_LAUNCHES}
        tol = TOLERANCE[method]
        ok = (out["zdb_rel_vs_single"] <= tol
              and out["zdr_rel_vs_single"] <= tol
              and out["zdb_rel_vs_oracle"] <= 2e-4
              and out["zdr_rel_vs_oracle"] <= 2e-4 and zdb[0][0] == -np.inf)
        if dev.type == "cuda":
            # the kernels run on the pallas-seq path only, once a step
            kernel_steps = 1 + args.reps if method == "pallas-seq" else 0
            ok = ok and (out["launches"]["astage"]
                         == out["launches"]["rows"] == kernel_steps)
        out["ok"] = bool(ok)
        rows.append(out)
    dist.destroy_process_group()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--method", default="pallas-seq",
                    help="a comma list of " + ", ".join(METHODS))
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--device-decode", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    methods = args.method.split(",")
    if not methods or any(m not in METHODS for m in methods):
        ap.error(f"--method {args.method}: a comma list of {METHODS}")
    if args.device_decode and methods != ["pallas-seq"]:
        ap.error("--device-decode applies to --method pallas-seq only")
    if args.rank is not None:
        rows = _rank(args)
        for out in rows:
            print(json.dumps(out), flush=True)
        return 0 if all(out["ok"] for out in rows) else 1
    from wrp_tpu_torch.parallel.launch import run_ranks

    base = [sys.executable, os.path.abspath(__file__)]
    for k, v in vars(args).items():
        if k in ("rank", "port") or v is None or v is False:
            continue
        flag = "--" + k.replace("_", "-")
        base += [flag] if v is True else [flag, str(v)]
    results = run_ranks(
        lambda rank, port: base + ["--rank", str(rank), "--port", str(port)],
        args.ranks, args.timeout)
    rc = 0
    for r in results:
        sys.stdout.write(r.out)
        if r.rc != 0:
            sys.stderr.write(f"rank {r.rank} exit {r.rc}:\n{r.err[-3000:]}\n")
        rc = rc or r.rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
