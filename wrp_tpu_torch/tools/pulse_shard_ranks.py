#!/usr/bin/env python3
"""The pulse-sharded step across N ranks, one process each, held against
the single-device fused chain and timed.

    python3 wrp_tpu_torch/tools/pulse_shard_ranks.py --ranks 4            # N GPUs, NCCL
    python3 wrp_tpu_torch/tools/pulse_shard_ranks.py --ranks 4 --device cpu --m 128 --n 64

Every rank builds PulseShardedProcessor(method="pallas") (the A-stage
kernel on its n/N pulses, the all_to_all, the row-epilogue kernel, the
all_gather) and steps the same seeded batch; each checks the full products
against SectorProcessor(method="pallas") on its own device (zdb/zdr
rel-L2 <= 1e-5) and sector 0 against the fp64 oracle (<= 2e-4), then times
`reps` steps of each (host batch in, products on the device, synchronised;
wall ms, median).  Rank k runs on cuda:k (NCCL) or the CPU (gloo).  Prints
one JSON line per rank and exits non-zero if any rank failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _rank(args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from wrp_tpu_torch import oracle
    from wrp_tpu_torch.config import DEFAULT_CONFIG
    from wrp_tpu_torch.io import codec
    from wrp_tpu_torch.ops import fullchain
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
    proc = PulseShardedProcessor.build(cfg, batch=args.batch, method="pallas",
                                       device_decode=args.device_decode,
                                       device=dev)
    feed = wires if args.device_decode else planar
    single = SectorProcessor(cfg, method="pallas", device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fullchain.ASTAGE_LAUNCHES = fullchain.PARSEVAL_ROWS_LAUNCHES = 0
    zdb, zdr = (t.cpu().numpy() for t in proc.step_local(feed, labels=labels))
    want_db, want_dr = (t.cpu().numpy() for t in single(planar))
    out = {"rank": args.rank, "ranks": args.ranks, "device": str(dev),
           "backend": dist.get_backend(),
           "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "geometry": [cfg.num_channels, cfg.m, cfg.n], "batch": args.batch,
           "device_decode": args.device_decode,
           "zdb_rel_vs_single": oracle.relative_l2(want_db, zdb),
           "zdr_rel_vs_single": oracle.relative_l2(want_dr, zdr)}
    zdb64, zdr64 = oracle.process_sector(iqs[0], cfg)
    out["zdb_rel_vs_oracle"] = oracle.relative_l2(zdb64, zdb[0])
    out["zdr_rel_vs_oracle"] = oracle.relative_l2(zdr64, zdr[0])

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

    out["step_ms"] = wall_ms(lambda: proc.step_local(feed, labels=labels))
    out["single_device_ms"] = wall_ms(lambda: single(planar))
    out["launches"] = {"astage": fullchain.ASTAGE_LAUNCHES,
                       "rows": fullchain.PARSEVAL_ROWS_LAUNCHES}
    ok = (out["zdb_rel_vs_single"] <= 1e-5 and out["zdr_rel_vs_single"] <= 1e-5
          and out["zdb_rel_vs_oracle"] <= 2e-4
          and out["zdr_rel_vs_oracle"] <= 2e-4 and zdb[0][0] == -np.inf)
    if dev.type == "cuda":
        ok = ok and out["launches"]["astage"] == out["launches"]["rows"] == \
            1 + args.reps
    out["ok"] = bool(ok)
    dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
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
    if args.rank is not None:
        out = _rank(args)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    base = [sys.executable, os.path.abspath(__file__), "--port", str(port)]
    for k, v in vars(args).items():
        if k in ("rank", "port") or v is None or v is False:
            continue
        flag = "--" + k.replace("_", "-")
        base += [flag] if v is True else [flag, str(v)]
    procs = [subprocess.Popen(base + ["--rank", str(k)], stdout=subprocess.PIPE,
                              text=True) for k in range(args.ranks)]
    rc = 0
    deadline = time.monotonic() + args.timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            rc = rc or 124
        sys.stdout.write(out)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
