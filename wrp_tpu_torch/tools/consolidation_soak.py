"""N radar feeds through one card: a soak at each feed's real sector rate
through one StreamingExecutor in multi-feed mode.  Counterpart of
``tools/consolidation_soak.py``.

Feed k < `--udp-feeds` arrives over UDP (the reference's per-row wire), the
others over ZMQ (the v2 whole-sector wire); each feed has its own `cli
produce` process of the port (`--headers --per-sector-seed --pool`),
started from the executor's `on_ready` once the chain is warm and every
ingest thread listens.  Every feed has its own volume and stats.  The
record gives per feed the sectors processed, sent and dropped, the volume's
coverage, p50 and p99 latency; and the active span (first to last batch
tick), the executor process's CPU time and its share of a core.

The contamination check pins each feed's stored zdb to that feed's own
fp64 oracle: sampled labels, each recomputed from (feed seed, k) alone
(`oracle.produce_sector_iq`, the last k with that label, pool entry
k % pool); its teeth: one label per feed against the neighbouring feed's
oracle must read a rel-L2 above 10 x the tolerance.

`--stub-device` replaces the device step with an instant host stub: the
executor's host path alone (ingest, reassembly, the host decode, staging,
egress to an unlistened UDP port, the volumes) at the feeds' rate, with
coverage, rates and drops and no oracle.

    python -m wrp_tpu_torch.tools.consolidation_soak --feeds 4 --duration 60
    python -m wrp_tpu_torch.tools.consolidation_soak --feeds 8 --device-decode
    python -m wrp_tpu_torch.tools.consolidation_soak --feeds 8 --stub-device
    python -m wrp_tpu_torch.tools.consolidation_soak --smoke --device cpu

Prints one JSON line per feed and the record; `--out FILE` appends the
record to a JSON list.  Exits 1 on a contamination failure or, outside
`--smoke`, on any dropped sector; 2 for `--feeds` < 2, for `--stub-device`
with `--device-decode`, and without CUDA unless `--device cpu`.  Ports are
free ones unless `--base-port` gives the first of a range.  The tool reads
net.core.rmem_max and warns when it is small; it sets nothing on the host.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

#: one volume scan a minute: ~21.45 sectors/s a radar
REAL_RADAR_RATE = 143 * 9 / 60.0
#: the UDP receive buffer UdpIngest asks for (one sector is 6.3 MB)
RCVBUF_BYTES = 1 << 27


def last_k_for_label(sector: int, elevation: int, sent: int,
                     num_sectors: int = 143, num_elevations: int = 9):
    """The largest global index k < sent whose label is (sector,
    elevation): the write that survives in the volume (labels cycle with
    period num_sectors * num_elevations)."""
    period = num_sectors * num_elevations
    base = sector + num_sectors * elevation
    if base >= sent:
        return None
    return base + period * ((sent - 1 - base) // period)


def warn_small_rmem(need: int = RCVBUF_BYTES) -> None:
    """Say on stderr when net.core.rmem_max would clamp a UDP feed's
    receive buffer below `need`.  Reads only: the limit is the host's."""
    try:
        with open("/proc/sys/net/core/rmem_max") as f:
            cur = int(f.read().strip())
    except (OSError, ValueError):
        return
    if cur < need:
        print(f"net.core.rmem_max is {cur} bytes, below the {need} a UDP "
              "feed asks for: a sector's datagram burst may overflow the "
              "receive buffer (an administrator can raise it; this tool "
              "does not)", file=sys.stderr, flush=True)


def check_feeds(volumes, cfg, seeds, sent: int, pool: int, samples: int,
                tol: float, rng):
    """The contamination check.  Returns ([(labels checked, max zdb rel-L2
    or None) per feed], failures): each sampled label of feed k against
    feed k's fp64 oracle (< tol), and one label per feed against the next
    feed's (> 10 tol, the check's teeth)."""
    from .. import oracle

    period = cfg.num_sectors * cfg.num_elevations
    per_feed, failures = [], []
    for k, vol in enumerate(volumes):
        covered = np.argwhere(vol.coverage)
        # prefer labels sent once: a label sent again whose last write was
        # dropped holds an earlier write, which the last-k oracle would
        # misread as contamination
        once = np.array([[s, e] for s, e in covered
                         if (s + cfg.num_sectors * e) + period >= sent])
        cand = once if len(once) else covered
        picked = cand[rng.choice(len(cand), min(samples, len(cand)),
                                 replace=False)] if len(cand) else []
        errs = []
        for j, (s, e) in enumerate(picked):
            klast = last_k_for_label(int(s), int(e), sent, cfg.num_sectors,
                                     cfg.num_elevations)
            if pool:
                klast %= pool           # the producer's pool entry
            stored = vol.data[0, :, s, e]
            zdb64, _ = oracle.process_sector(
                oracle.produce_sector_iq(cfg, seeds[k], klast), cfg)
            err = float(oracle.relative_l2(zdb64, stored))
            errs.append(err)
            if not err < tol:
                failures.append({"feed": k, "sector": int(s),
                                 "elevation": int(e), "rel_l2": err})
            if j == 0:
                # zdb is log-domain: a wrong feed's noise sector reads ~1e-2
                # (the same gain ramp), far above tol; demand a decade
                wrong, _ = oracle.process_sector(oracle.produce_sector_iq(
                    cfg, seeds[(k + 1) % len(volumes)], klast), cfg)
                cross = float(oracle.relative_l2(wrong, stored))
                if not cross > 10 * tol:
                    failures.append({"feed": k, "teeth": cross})
        per_feed.append((len(errs), max(errs) if errs else None))
    return per_feed, failures


def _args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m wrp_tpu_torch.tools.consolidation_soak",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--feeds", type=int, default=4)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="each producer's span in seconds")
    ap.add_argument("--rate", type=float, default=REAL_RADAR_RATE,
                    help="sectors/s a feed (default: one real radar)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--method", default="pallas",
                    help="the SectorProcessor method (pallas: the fused "
                         "chain)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits 2 without CUDA) or 'cpu'")
    ap.add_argument("--device-decode", action="store_true",
                    help="ship raw wire bytes and decode them on the card "
                         "(the wire kernel): frees the host decode")
    ap.add_argument("--timeout", type=float, default=1.0,
                    help="an ingest's receive timeout, s")
    ap.add_argument("--verify-samples", type=int, default=6,
                    help="labels a feed pinned to the feed's fp64 oracle")
    ap.add_argument("--udp-feeds", type=int, default=1,
                    help="feeds on the per-row UDP wire (the first ones); "
                         "the rest on the whole-sector ZMQ wire")
    ap.add_argument("--pool", type=int, default=16,
                    help="distinct sectors a producer pre-encodes and "
                         "replays (0: synthesise every sector)")
    ap.add_argument("--zdb-tol", type=float, default=1e-4,
                    help="zdb rel-L2 bound of a sampled label")
    ap.add_argument("--base-port", type=int, default=0,
                    help="feed k's port is base + k (the stub's egress "
                         "base + feeds and + feeds + 1); 0: free ports")
    ap.add_argument("--out", default=None,
                    help="append the record to this JSON list file")
    ap.add_argument("--workdir", default=None,
                    help="keep the producers' logs here (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--smoke", action="store_true",
                    help="2 feeds, 3 s at 4 sectors/s, batch 2: plumbing, "
                         "the rates mean nothing")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="a torch.profiler trace of every thread with the "
                         "executor's stages annotated (DIR/trace.json) and "
                         "DIR/host_intervals.json, for trace_summary "
                         "--overlap")
    ap.add_argument("--producer-nice", type=int, default=0,
                    help="run the producers at this niceness (on one host "
                         "they share the executor's cores; remote radars "
                         "would not)")
    ap.add_argument("--stub-device", action="store_true",
                    help="an instant host stub in place of the device step: "
                         "the executor's host path alone; no oracle")
    args = ap.parse_args(argv)
    if args.feeds < 2:
        # the teeth probe reads the next feed's oracle, and per-feed stats
        # exist only with more than one transport
        ap.error("--feeds must be >= 2 (the soak is a multi-feed "
                 "consolidation check; use `cli stream` for one feed)")
    if args.stub_device and args.device_decode:
        ap.error("--stub-device has no device to decode on; drop "
                 "--device-decode (the host decode is part of what the stub "
                 "run measures)")
    if args.smoke:
        args.feeds, args.duration, args.rate = 2, 3.0, 4.0
        args.batch, args.verify_samples = 2, 2
    return ap, args


def main(argv=None) -> int:
    from ..cli import _chain_launches
    from ..config import DEFAULT_CONFIG
    from ..io.udp import UdpEgress, UdpIngest
    from ..parallel.launch import ROOT, free_port, module_env
    from ..runtime import StreamingExecutor, VolumeScan, configure_logging
    from ._common import device_of

    ap, args = _args(argv)
    dev = device_of(ap, args.device)
    configure_logging("info")      # progress lines make a hung run readable
    cfg = DEFAULT_CONFIG
    sent = int(args.rate * args.duration)
    seeds = [1000 + k for k in range(args.feeds)]
    kinds = ["udp" if k < args.udp_feeds else "zmq"
             for k in range(args.feeds)]
    if "udp" in kinds:
        warn_small_rmem()

    def port(k, kind):
        return args.base_port + k if args.base_port else free_port(kind)

    transports, commands = [], []
    for k, kind in enumerate(kinds):
        cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
               "--transport", kind, "--sectors", str(sent), "--rate",
               str(args.rate), "--headers", "--per-sector-seed", "--seed",
               str(seeds[k])]
        if args.pool:
            cmd += ["--pool", str(args.pool)]
        if kind == "udp":
            p = port(k, socket.SOCK_DGRAM)
            transports.append(UdpIngest(cfg, port=p, timeout_s=args.timeout))
            cmd += ["--ingest-port", str(p)]
        else:
            from ..io.zmq_io import ZmqIngest

            p = port(k, socket.SOCK_STREAM)
            transports.append(ZmqIngest(cfg, endpoint=f"tcp://127.0.0.1:{p}",
                                        timeout_ms=int(args.timeout * 1e3)))
            cmd += ["--zmq-bind", f"tcp://127.0.0.1:{p}"]
        commands.append(cmd)
    volumes = [VolumeScan(cfg) for _ in range(args.feeds)]

    with tempfile.TemporaryDirectory(prefix="wrp_soak_") as tmp:
        workdir = args.workdir or tmp
        os.makedirs(workdir, exist_ok=True)
        producers = []
        started = threading.Event()

        def start_producers():
            # `nice -n N` as a prefix keeps the spawn path posix_spawn
            prefix = (["nice", "-n", str(args.producer_nice)]
                      if args.producer_nice else [])
            for k, cmd in enumerate(commands):
                with open(os.path.join(workdir, f"producer{k}.err"),
                          "wb") as log:
                    producers.append(subprocess.Popen(
                        prefix + cmd, stdout=log, stderr=log,
                        stdin=subprocess.DEVNULL, env=module_env(), cwd=ROOT))
            started.set()

        processor = publish = None
        if args.stub_device:
            stub = np.zeros((args.batch, cfg.num_output_bins), np.float32)

            def processor(planar):     # noqa: F811 - the instant stub step
                return stub, stub

            # egress on: the result wire's send syscalls belong to the host
            # path; nothing listens on these ports
            publish = UdpEgress(
                cfg, zdb_port=port(args.feeds, socket.SOCK_DGRAM),
                zdr_port=port(args.feeds + 1, socket.SOCK_DGRAM),
                extended=True)
        ex = StreamingExecutor(
            cfg, transport=transports, publish=publish, batch=args.batch,
            method=args.method, device=dev, device_decode=args.device_decode,
            processor=processor, volume=volumes, checkpoint_every_s=None,
            max_sectors=sent,
            # generous: producer start-up (interpreter, imports, the pool's
            # synthesis) follows on_ready; the normal end is each feed's
            # last sector, and the drain below after the producers exit
            idle_limit=max(5, math.ceil((90.0 + 0.06 * args.pool * args.feeds)
                                        / args.timeout)),
            on_ready=start_producers)

        def stop_when_drained():
            # a feed that lost a sector never reaches max_sectors: once
            # every producer has exited and a grace passes with no batch
            # completed (the backlog processed), stop
            started.wait()
            for p in producers:
                p.wait()
            last = None
            while last != ex.throughput.last_tick:
                last = ex.throughput.last_tick
                time.sleep(max(2.0, 3 * args.timeout))
            ex.stop()
        threading.Thread(target=stop_when_drained, daemon=True,
                         name="wrp-soak-drain").start()

        prof = None
        if args.trace:
            from ..cli import _start_trace

            os.makedirs(args.trace, exist_ok=True)
            ex.timers.enable_intervals(annotate=True)
            prof = _start_trace(dev)
        launches0 = _chain_launches()
        cpu0 = time.process_time()      # every thread of this process
        try:
            stats = ex.run()
        finally:
            if prof is not None:
                prof.stop()
            for t in transports:
                t.close()
            if publish is not None:
                publish.close()
        executor_cpu_s = time.process_time() - cpu0
        launches = {k: v - launches0[k]
                    for k, v in _chain_launches().items()}
        if prof is not None:
            from ..cli import _write_trace

            _write_trace(prof, ex.timers.intervals, args.trace)
        span_s = ex.throughput.last_tick - ex.throughput.first_tick
        rcs = [p.wait(timeout=60) for p in producers]
        if any(rcs):
            logs = []
            for k in range(len(producers)):
                with open(os.path.join(workdir, f"producer{k}.err")) as f:
                    logs.append(f"producer {k}: {f.read()[-1500:]}")
            sys.exit(f"producer exit codes {rcs}\n" + "\n".join(logs))

    if span_s <= 0:
        raise RuntimeError(f"no active span: {stats['batches']} batches")
    per_feed, failures = [], []
    checks = [(0, None)] * args.feeds
    if not args.stub_device:
        checks, failures = check_feeds(
            volumes, cfg, seeds, sent, args.pool, args.verify_samples,
            args.zdb_tol, np.random.default_rng(2024))
    for k, fstats in enumerate(stats["feeds"]):
        tr, lat = fstats["transport"], fstats["latency_ms"] or {}
        row = {
            "feed": k, "kind": kinds[k],
            "processed_sectors": fstats["processed_sectors"],
            "sent_sectors": sent,
            "sectors_per_second": round(fstats["processed_sectors"]
                                        / span_s, 2),
            "p50_ms": lat.get("p50_ms"), "p99_ms": lat.get("p99_ms"),
            "drops": (tr.get("dropped_sectors", 0)
                      + tr.get("dropped_datagrams", 0)),
            "coverage_sectors": int(volumes[k].coverage.sum()),
            "verify_labels": checks[k][0],
            "verify_rel_l2_max": checks[k][1],
        }
        per_feed.append(row)
        print(json.dumps(row), flush=True)

    processed = stats["processed_sectors"]
    record = {
        "metric": "consolidation_soak",
        "feeds": args.feeds,
        "kinds": kinds,
        "duration_s": round(span_s, 1),
        "rate_per_feed": args.rate,
        "method": "stub" if args.stub_device else args.method,
        # a processor override takes the host's int16 planar: the stub run
        # pays the host decode of the default path
        "decode": "device" if args.device_decode else "host-i16",
        "device_decode": args.device_decode,
        "batch": args.batch,
        "backend": "stub" if args.stub_device else dev.type,
        "device": stats["device"],
        "host_cores": os.cpu_count(),
        "producer_nice": args.producer_nice,
        "total_sectors": processed,
        "total_sectors_per_second": round(processed / span_s, 2),
        "executor_cpu_s": round(executor_cpu_s, 2),
        "executor_cpu_ms_per_sector": round(
            1e3 * executor_cpu_s / max(1, processed), 3),
        "executor_core_fraction": round(executor_cpu_s / span_s, 3),
        "kernel_launches": launches,
        "timers": stats["timers"],
        "latency_ms": stats["latency_ms"],
        "per_feed": per_feed,
        "contamination_failures": failures,
        "smoke": args.smoke,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
            if not isinstance(existing, list):
                existing = [existing]
        existing.append(record)
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    if failures:
        return 1
    if sum(r["drops"] for r in per_feed) and not args.smoke:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
