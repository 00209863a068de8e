"""Multi-host weak scaling of the data-parallel step: one world of ranks,
then N, each rank stepping its own sectors.  Counterpart of
``tools/multihost_bench.py``.

The JAX tool forms one global mesh of virtual CPU devices per host.  Here
each of the `hosts x devices-per-host` devices is a rank process
(parallel/launch.run_ranks): NCCL with one GPU a rank on CUDA, gloo with
`--device cpu`.  Every rank builds `MultiHostProcessor` (parallel/
multihost.py, a [world, 1] mesh) and steps its share of its host's
per-host batch, host planar in and products on its device, `steps` times
after one warm step; the span ends with a fetch of the last products.  A
world's rate is the sectors of all its ranks over the slowest rank's span
(the JAX tool takes the least of its workers' rates, the same number).

    python -m wrp_tpu_torch.tools.multihost_bench --hosts 4 --method pallas \
        --m 1024 --n 512 --per-host-batch 16            # 4 GPUs
    python -m wrp_tpu_torch.tools.multihost_bench --hosts 2 --device cpu

Prints the JAX tool's one JSON line (`metric` multihost_weak_scaling, the
rates of 1 host and of N, `efficiency_raw` = N-host rate / (N x 1-host
rate)) with `backend` naming nccl or gloo and the device, and each rank's
kernel launches as one `launches: {...}` line on stderr.  On the CPU every
rank shares this machine's cores, so the JAX tool's shared-core ceiling
divides the raw efficiency; on CUDA every rank has its own card and the
ceiling is 1.0.  Exits 2 when the world needs more GPUs than the host has,
when the per-host batch does not divide by devices-per-host, or without
CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

METHODS = ("mxu", "fft", "pallas", "pallas-seq")
RANK_TIMEOUT_S = 600.0


def _rank(args) -> None:
    """One rank: `steps` timed steps of its share, one JSON line with its
    span and launches on stdout, then the bounded ending."""
    from ..config import tiny_config
    from ..ops import fullchain
    from ..parallel.launch import end_rank
    from ..parallel.multihost import MultiHostProcessor, init_distributed

    torch.set_num_threads(1)
    dev = init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                           args.device, timeout_s=args.timeout)
    share = args.per_host_batch // args.devices_per_host
    cfg = tiny_config(m=args.m, n=args.n)
    proc = MultiHostProcessor.build(cfg, per_host_batch=share,
                                    method=args.method, device=dev)
    rng = np.random.default_rng(args.rank)
    planar = rng.integers(-2048, 2048, (share, cfg.num_channels, 2, args.m,
                                        args.n)).astype(np.float32)
    proc.step_local(planar)[0].cpu()          # kernel build, warm groups
    fullchain.LAUNCHES = fullchain.ASTAGE_LAUNCHES = 0
    fullchain.PARSEVAL_ROWS_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(args.steps):
        out = proc.step_local(planar)
    out[0].cpu()                               # the fetch closes the span
    span = time.perf_counter() - t0
    print(json.dumps({"rank": args.rank, "span_s": span, "sectors": share,
                      "launches": {"radix": fullchain.LAUNCHES,
                                   "astage": fullchain.ASTAGE_LAUNCHES,
                                   "rows": fullchain.PARSEVAL_ROWS_LAUNCHES}}),
          flush=True)
    end_rank(0, 30.0)


def run_world(args, world: int) -> tuple:
    """(sectors/s of a world of `world` ranks, each rank's launches)."""
    from ..parallel.launch import ROOT, module_env, run_ranks

    base = [sys.executable, "-m", "wrp_tpu_torch.tools.multihost_bench",
            "--world", str(world)]
    for k, v in vars(args).items():
        if k not in ("hosts", "rank", "port", "world"):
            base += ["--" + k.replace("_", "-"), str(v)]
    env = module_env()
    env["OMP_NUM_THREADS"] = "1"
    results = run_ranks(
        lambda rank, port: base + ["--rank", str(rank), "--port", str(port)],
        world, args.timeout, env=env, cwd=ROOT)
    rows = []
    for r in results:
        lines = [ln for ln in r.out.splitlines() if ln.startswith("{")]
        if r.rc != 0 or not lines:
            raise RuntimeError(f"world {world}: rank {r.rank} exit {r.rc}: "
                               f"{r.err[-3000:]}")
        rows.append(json.loads(lines[-1]))
    sectors = sum(row["sectors"] for row in rows) * args.steps
    return (sectors / max(row["span_s"] for row in rows),
            [row["launches"] for row in rows])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wrp_tpu_torch.tools.multihost_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=1,
                    help="ranks a host, one GPU each (the JAX tool's 4 were "
                         "virtual CPU devices)")
    ap.add_argument("--per-host-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--method", default="mxu", choices=METHODS,
                    help="mxu | fft (torch paths) | pallas (the fused "
                         "chain, data-parallel) | pallas-seq (the A-stage "
                         "and row-epilogue kernels, each rank one seq "
                         "group)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): NCCL, one GPU a rank; cpu: gloo")
    ap.add_argument("--timeout", type=float, default=RANK_TIMEOUT_S,
                    help="each world's time limit, and its group's")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args)
    if args.hosts < 1 or args.devices_per_host < 1:
        ap.error("--hosts and --devices-per-host take N >= 1")
    if args.per_host_batch % args.devices_per_host:
        ap.error(f"--per-host-batch {args.per_host_batch} must divide by "
                 f"--devices-per-host {args.devices_per_host}")
    world = args.hosts * args.devices_per_host
    name = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            ap.error("CUDA is not available; pass --device cpu for gloo "
                     "ranks on the CPU")
        if world > torch.cuda.device_count():
            ap.error(f"{world} ranks need {world} GPUs, this host has "
                     f"{torch.cuda.device_count()} (NCCL takes one rank a "
                     "GPU)")
        name = torch.cuda.get_device_name(0)

    base, base_launches = run_world(args, args.devices_per_host)
    multi, multi_launches = run_world(args, world)
    eff = multi / (base * args.hosts)
    # On the CPU every rank shares this machine's cores, so the raw
    # efficiency is bounded by cpus / hosts when there are fewer cores than
    # hosts (the JAX tool's ceiling); the adjusted figure divides it out.
    # On CUDA each rank has its own card.
    cpus = os.cpu_count() or 1
    ceiling = 1.0
    if args.device == "cpu" and cpus < args.hosts:
        ceiling = cpus / args.hosts
    print("launches: " + json.dumps({"1host": base_launches,
                                      "nhost": multi_launches}),
          file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "multihost_weak_scaling",
        "method": args.method,
        "hosts": args.hosts,
        "devices_per_host": args.devices_per_host,
        "per_host_batch": args.per_host_batch,
        "sectors_per_second_1host": round(base, 2),
        "sectors_per_second_nhost": round(multi, 2),
        "efficiency_raw": round(eff, 3),
        "physical_cpus": cpus,
        "shared_cpu_ceiling": round(ceiling, 3),
        "efficiency_vs_ceiling": round(eff / ceiling, 3),
        "backend": (f"nccl on {name}" if args.device == "cuda"
                    else "gloo on cpu"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
