"""Command-line entry points of the port (counterpart of wrp_tpu/cli.py):

  process  — single-shot: IQ in, zdb/zdr out (reference read.cc).
  stream   — streaming processor on the v1 UDP wire (reference
             gpu_1fp_streamcasc.cu); with --coordinator, one rank of a
             lock-step multi-rank fleet (--pulse-shard: every rank reads
             one broadcast wire and computes a pulse slice of each sector).
  produce  — synthesise/replay sectors onto the wire.
  consume  — receive result frames, optionally into a volume checkpoint.

Flags are wrp_tpu's where they apply, plus --device (default cuda; without
CUDA the command exits non-zero rather than running on the CPU).

Usage: python -m wrp_tpu_torch.cli <subcommand> --help
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--method", default="mxu",
                   choices=["mxu", "parseval", "pallas", "radix", "fft"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) fails without CUDA, "
                        "'cpu' runs the plain torch versions")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--structured-logs", action="store_true")


def _add_channels(p):
    p.add_argument("--channels", type=int, default=3, choices=[2, 3],
                   help="wire/chain channel count: 3 = hh+vv+vh (the "
                        "reference's wire) or 2 = hh+vv (identical "
                        "products: vh never reaches zdb/zdr)")


def _cfg_from_args(args):
    """DEFAULT_CONFIG with the --channels override applied."""
    from .config import DEFAULT_CONFIG

    ch = getattr(args, "channels", None)
    if ch and ch != DEFAULT_CONFIG.num_channels:
        return dataclasses.replace(DEFAULT_CONFIG, num_channels=ch).validate()
    return DEFAULT_CONFIG


def _device_or_exit(name: str):
    """The requested torch.device, or a usage error (rc 2) when CUDA was
    asked for on a host without it."""
    from .pipeline import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return None


def cmd_process(args):
    from . import oracle
    from .config import DEFAULT_CONFIG
    from .io import codec
    from .io.files import read_ascii_iq, write_ascii_matrix
    from .pipeline import SectorProcessor

    device = _device_or_exit(args.device)
    if device is None:
        return 2
    cfg = DEFAULT_CONFIG
    if args.input == "synthetic":
        iq = oracle.synthetic_iq(cfg, kind="noise", seed=args.seed)
        planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    elif args.input == "-" or args.input.endswith(".altb"):
        # reference-era ASCII IQ (read.cc:106-123): all hh then all vv
        stream = sys.stdin if args.input == "-" else open(args.input)
        try:
            iq = read_ascii_iq(stream, cfg.m, cfg.n, channels=2)
        finally:
            if stream is not sys.stdin:
                stream.close()
        cfg = dataclasses.replace(cfg, num_channels=2)
        planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    elif args.input.endswith(".npy"):
        planar = np.load(args.input)
    else:  # raw wire bytes
        with open(args.input, "rb") as f:
            planar = codec.decode_iq(f.read(), cfg)

    if args.dump_stages:
        # the reference's staged-golden methodology: every stage boundary
        # of the fft path as XXname.altb files
        from pathlib import Path

        import torch

        from . import pipeline as pl_mod
        from .constants import PipelineConstants

        iq_c = torch.complex(torch.from_numpy(planar[:, 0]),
                             torch.from_numpy(planar[:, 1]))
        stages = pl_mod.all_stages(iq_c, PipelineConstants.build(cfg))
        outdir = Path(args.dump_stages)
        outdir.mkdir(parents=True, exist_ok=True)
        for name, arr in stages.items():
            arr = arr.abs() if arr.is_complex() else arr
            arr = arr.numpy()
            write_ascii_matrix(outdir / f"{name}.altb",
                               arr[0] if arr.ndim == 3 else arr)
        print(f"stage dumps -> {outdir}", file=sys.stderr)

    proc = SectorProcessor(cfg, method=args.method, device=device)
    t0 = time.perf_counter()
    zdb, zdr = proc(planar[None])
    zdb, zdr = zdb[0].cpu().numpy(), zdr[0].cpu().numpy()
    print(f"processing: {(time.perf_counter() - t0) * 1e6:.0f} us "
          f"(first call, {device})", file=sys.stderr)
    if args.output:
        write_ascii_matrix(args.output, np.stack([zdb, zdr], 1))
    else:
        for a, b in zip(zdb, zdr):
            print(f"{a:g} {b:g}")
    return 0


def _ready_marker(path):
    """--ready-file: touch the file once warmup is done and ingest is
    listening, so harnesses gate the producer on it, not on a sleep."""
    if not path:
        return None

    def _touch():
        from pathlib import Path

        Path(path).touch()

    return _touch


def _open_volume(cfg, path):
    """Resume the volume scan from an existing checkpoint (geometry must
    match cfg), else start fresh."""
    from pathlib import Path

    from .runtime import VolumeScan
    from .runtime.metrics import log

    if Path(path).exists():
        vs = VolumeScan.load(path, cfg)
        log.info("resuming volume scan from %s (%.1f%% covered)",
                 path, 100 * vs.fraction())
        if 0 < vs.fraction() < 1:
            log.warning(
                "resume correctness depends on the wire carrying "
                "sector/elevation (extended ingest headers); a bare v1 "
                "feed restarts labeling at sector 0, elevation 0")
        return vs
    return VolumeScan(cfg, path)


def cmd_stream(args):
    import signal
    import threading

    from .io.udp import UdpEgress, UdpIngest
    from .runtime import StreamingExecutor, configure_logging

    configure_logging(args.log_level, args.structured_logs)
    device = _device_or_exit(args.device)
    if device is None:
        return 2
    # refusals come before any socket is bound or group joined: a refusal
    # after setup would leave peers blocked in the group's handshake
    if args.device_decode and args.method != "pallas":
        print("--device-decode requires --method pallas", file=sys.stderr)
        return 2
    if args.device_decode and args.coordinator and not args.pulse_shard:
        # the data-parallel lock-step processor takes planar input; only
        # the pulse-shard processor has a wire-bytes path
        print("--device-decode with --coordinator needs --pulse-shard "
              "(the data-parallel lock-step processor takes planar input)",
              file=sys.stderr)
        return 2
    if args.pulse_shard and not args.coordinator:
        print("--pulse-shard needs the lock-step fleet (--coordinator)",
              file=sys.stderr)
        return 2
    if args.pulse_shard and args.method not in ("mxu", "fft", "pallas"):
        print("--pulse-shard supports --method mxu, fft, or pallas (pallas "
              "runs the seq-sharded fused chain, parallel/sharded.py "
              "pallas-seq)", file=sys.stderr)
        return 2

    # service managers stop daemons with SIGTERM: take the graceful path
    # (only the main thread may install handlers; an embedding thread
    # keeps its process's handling)
    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _sigterm)
    cfg = _cfg_from_args(args)
    feeds = args.feed_port or []
    if args.feed_checkpoint:
        if not feeds or len(args.feed_checkpoint) != len(feeds):
            print("--feed-checkpoint needs one path per --feed-port",
                  file=sys.stderr)
            return 2
        if len(set(args.feed_checkpoint)) != len(args.feed_checkpoint):
            print("duplicate --feed-checkpoint paths", file=sys.stderr)
            return 2
    processor = None
    if args.coordinator:
        # lock-step multi-rank streaming: every rank runs this command with
        # its own --host-id; one rank per device, cuda:(rank % devices)
        from .parallel.multihost import (MultiHostProcessor,
                                         PulseShardedProcessor,
                                         init_distributed)

        # the group's own timeout must exceed the executor's bound, so that
        # a dead peer ends in the bounded exit (checkpoint, rc 3)
        group_timeout = (None if args.collective_timeout is None
                         else 2.0 * args.collective_timeout + 60.0)
        device = init_distributed(args.coordinator, args.num_hosts,
                                  args.host_id, device,
                                  timeout_s=group_timeout)
        if args.pulse_shard:
            processor = PulseShardedProcessor.build(
                cfg, batch=args.batch, method=args.method,
                device_decode=args.device_decode, device=device).step_local
        else:
            processor = MultiHostProcessor.build(
                cfg, per_host_batch=args.batch, method=args.method,
                device=device).step_local
    if feeds:
        transport = [UdpIngest(cfg, port=p, timeout_s=args.timeout)
                     for p in feeds]
    else:
        # pulse-shard ranks on one host read ONE broadcast port; elsewhere
        # no sharing (unicast datagrams would be split between the sockets)
        transport = UdpIngest(cfg, port=args.ingest_port,
                              timeout_s=args.timeout,
                              reuse_port=args.pulse_shard)
    publish = UdpEgress(cfg, zdb_port=args.zdb_port, zdr_port=args.zdr_port,
                        extended=args.extended_results)

    volume = None
    if args.feed_checkpoint:
        volume = [_open_volume(cfg, p) for p in args.feed_checkpoint]
    elif args.checkpoint:
        if isinstance(transport, list):
            from pathlib import Path

            base = Path(args.checkpoint)
            volume = [_open_volume(cfg, str(base.with_suffix(f".feed{k}.npz")))
                      for k in range(len(transport))]
        else:
            volume = _open_volume(cfg, args.checkpoint)
    ex = StreamingExecutor(
        cfg, transport=transport, publish=publish, batch=args.batch,
        method=args.method, debug_sync=args.debug_sync, volume=volume,
        max_sectors=args.max_sectors, idle_limit=args.idle_limit,
        checkpoint_every_s=(None if args.checkpoint_every < 0
                            else args.checkpoint_every),
        on_ready=_ready_marker(args.ready_file), device=device,
        device_decode=args.device_decode, processor=processor,
        lockstep=args.coordinator is not None,
        # a peer that missed its receive timeout shows in this rank's log
        # shortly after, not as a silent hang
        stall_warning_s=max(10.0, 2.0 * (args.timeout or 0.0)),
        collective_timeout_s=args.collective_timeout)
    try:
        stats = ex.run()
    finally:
        for t in (transport if isinstance(transport, list) else [transport]):
            t.close()
        publish.close()
    if volume is not None:
        vols = volume if isinstance(volume, list) else [volume]
        for v in vols:
            v.save()
        cov = [v.fraction() for v in vols]
        stats["volume_coverage"] = cov if len(cov) > 1 else cov[0]
    print(json.dumps(stats, indent=2))
    if args.coordinator:
        _bounded_exit(args.collective_timeout)
    return 0


def _bounded_exit(collective_timeout):
    """Leave the process group and end the process within a bound.  With a
    dead peer, tearing the group down can block; a hard-exit timer bounds
    that, while a healthy group leaves in milliseconds.  Never returns."""
    import os
    import threading

    import torch.distributed as dist

    sys.stdout.flush()
    sys.stderr.flush()
    bound = max(10.0, collective_timeout or 0.0)
    threading.Timer(bound, lambda: os._exit(0)).start()
    try:
        dist.destroy_process_group()
    except Exception:
        pass
    os._exit(0)


def cmd_produce(args):
    from .io import codec
    from .io.udp import UdpProducer
    from .oracle import produce_sector_iq

    cfg = _cfg_from_args(args)
    producer = UdpProducer(cfg, host=args.host, port=args.ingest_port,
                           extended_headers=args.headers)
    replay_wire = None
    if args.input:
        # replay a reference-era ASCII IQ capture: 2 recorded channels, vh
        # zero-padded; encoded once
        from .io.files import read_ascii_iq

        with open(args.input) as f:
            iq2 = read_ascii_iq(f, cfg.m, cfg.n, channels=2)
        replay = np.zeros(cfg.sector_shape, np.complex128)
        replay[:2] = iq2[: cfg.num_channels]
        replay_wire = codec.encode_iq(replay, cfg)
    # pre-encoded pool: entry j is produce_sector_iq(cfg, seed, j), so a
    # verifier recomputes sector k as entry k % pool
    pool = [codec.encode_iq(produce_sector_iq(cfg, args.seed, j), cfg)
            for j in range(args.pool)]
    rng = np.random.default_rng(args.seed)
    sent = 0
    t_next = time.perf_counter()
    try:
        for k0 in range(args.sectors):
            k = args.start_sector + k0
            sector = k % cfg.num_sectors
            elevation = (k // cfg.num_sectors) % cfg.num_elevations
            if replay_wire is not None:
                wire = replay_wire
            elif pool:
                wire = pool[k % args.pool]
            elif args.per_sector_seed:
                wire = codec.encode_iq(produce_sector_iq(cfg, args.seed, k),
                                       cfg)
            else:
                iq = (rng.integers(-8192, 8192, cfg.sector_shape)
                      + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
                wire = codec.encode_iq(iq, cfg)
            producer.send_sector(wire, sector, elevation)
            sent += 1
            if args.rate:
                # absolute schedule: sector k goes out at t0 + k / rate
                t_next += 1.0 / args.rate
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
    finally:
        producer.close()
    print(f"sent {sent} sectors", file=sys.stderr)
    return 0


def cmd_consume(args):
    import select
    import socket
    import struct

    from .io import frames
    from .runtime import VolumeScan

    cfg = _cfg_from_args(args)
    vs = VolumeScan(cfg, args.volume) if args.volume else None
    have: dict = {}

    def bind(port):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", port))
        return s

    # zdb and zdr ride separate ports; zdr is only needed for a volume
    socks = {bind(args.port or cfg.udp_zdb_port): 0}
    if vs is not None:
        socks[bind(args.zdr_port or cfg.udp_zdr_port)] = 1

    def add(product, sector, elevation, values):
        if not (0 <= sector < cfg.num_sectors
                and 0 <= elevation < cfg.num_elevations):
            return
        vals = np.asarray(values, np.float32)
        if vals.shape != (cfg.num_output_bins,):
            return
        vs.data[product, :, sector, elevation] = vals
        seen = have.setdefault((sector, elevation), set())
        seen.add(product)
        if len(seen) == 2:   # covered once BOTH products arrived
            vs.coverage[sector, elevation] = True

    def drain_ready(wait_s):
        """One select slice; returns the number of zdb frames seen."""
        zdbs = 0
        ready, _, _ = select.select(list(socks), [], [], wait_s)
        for s in ready:
            buf, _ = s.recvfrom(65536)
            try:
                sector, elev, values = frames.unpack_result_udp(buf)
            except (struct.error, ValueError):
                print("dropped malformed result frame", file=sys.stderr)
                continue
            product = socks[s]
            if product == 0:
                tag = "" if elev is None else f" elev {elev}"
                print(f"sector {sector}{tag}: {values[:4]} ...")
                zdbs += 1
            if vs is not None:
                # bare v1 frames carry no elevation: accumulate at cut 0
                add(product, sector, elev or 0, values)
        return zdbs

    got = 0
    try:
        # rolling deadline on zdb progress, not on mere traffic
        deadline = time.monotonic() + args.timeout
        while got < args.count and time.monotonic() < deadline:
            n = drain_ready(0.25)
            if n:
                got += n
                deadline = time.monotonic() + args.timeout
        if vs is not None:
            # grace drain: the final sector's zdr frame may trail its zdb
            end = time.monotonic() + 0.5
            while time.monotonic() < end:
                drain_ready(0.1)
    finally:
        for s in socks:
            s.close()
    if vs is not None:
        p = vs.save()
        print(f"volume -> {p} (coverage {vs.fraction():.4f})", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="wrp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="single-shot processing")
    _add_common(p)
    p.add_argument("--input", default="synthetic",
                   help="'synthetic', raw wire .bin, planar .npy, ASCII IQ "
                        ".altb, or '-' for ASCII IQ on stdin (read.cc "
                        "format)")
    p.add_argument("--output", default=None, help="99result-format output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dump-stages", default=None, metavar="DIR",
                   help="write per-stage .altb dumps of the fft path "
                        "(computed on the CPU)")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("stream", help="streaming processor (UDP v1 wire)")
    _add_common(p)
    _add_channels(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--ingest-port", type=int, default=None)
    p.add_argument("--feed-port", type=int, action="append", default=None,
                   metavar="PORT",
                   help="repeat to multiplex several radar feeds into one "
                        "processor (one ingest per port, per-feed stats "
                        "and checkpoints); overrides --ingest-port")
    p.add_argument("--zdb-port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="volume .npz path; resumes coverage if it exists")
    p.add_argument("--feed-checkpoint", action="append", default=None,
                   metavar="PATH",
                   help="explicit per-feed volume .npz (once per "
                        "--feed-port, same order)")
    p.add_argument("--checkpoint-every", type=float, default=30.0,
                   help="periodic save interval in seconds (0 saves "
                        "every batch; negative disables periodic saves)")
    p.add_argument("--extended-results", action="store_true",
                   help="emit v1x result frames carrying the elevation")
    p.add_argument("--debug-sync", action="store_true",
                   help="validate numerics every batch (rpv2 gpuErrchk mode)")
    p.add_argument("--max-sectors", type=int, default=None)
    p.add_argument("--idle-limit", type=int, default=None,
                   help="exit after N consecutive idle recv timeouts")
    p.add_argument("--ready-file", default=None,
                   help="touch this file once warmup is done and ingest is "
                        "listening (harness readiness gate)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="lock-step multi-rank mode: rank 0's address for "
                        "torch.distributed (NCCL on CUDA, gloo on the CPU)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="ranks in the fleet (with --coordinator)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this rank (with --coordinator); it runs on "
                        "cuda:(rank %% device count)")
    p.add_argument("--pulse-shard", action="store_true",
                   help="every rank reads the same broadcast wire (one "
                        "port, SO_REUSEPORT) and computes 1/N of each "
                        "sector's pulses; every rank publishes the full "
                        "products (needs --coordinator)")
    p.add_argument("--collective-timeout", type=float, default=None,
                   metavar="S",
                   help="lock-step: when a step blocks on a silent peer "
                        "(or no batch starts or fills) for S seconds, save "
                        "the checkpoint, print stats to stderr and exit 3")
    p.add_argument("--device-decode", action="store_true",
                   help="ship raw wire bytes and decode them on the device "
                        "(needs --method pallas): the wire kernel decodes "
                        "in registers, or, when m does not split into "
                        "radix branches, a decode pass feeds the dense "
                        "kernel.  Rows stay in natural order (no "
                        "--wire-order)")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("produce", help="send sectors onto the UDP wire")
    _add_channels(p)
    p.add_argument("--sectors", type=int, default=143)
    p.add_argument("--start-sector", type=int, default=0,
                   help="label offset: resume a feed mid-volume")
    p.add_argument("--rate", type=float, default=0.0, help="sectors/s cap")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--per-sector-seed", action="store_true",
                   help="derive sector k's IQ from (seed, k) so a verifier "
                        "can recompute any sector")
    p.add_argument("--pool", type=int, default=0, metavar="N",
                   help="pre-encode N (seed, j)-derived sectors and replay "
                        "them cyclically (sector k = entry k %% N)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ingest-port", type=int, default=None)
    p.add_argument("--headers", action="store_true",
                   help="extended ingest headers (drop detection)")
    p.add_argument("--input", default=None, metavar="IQ.altb",
                   help="replay a captured ASCII IQ sector (read.cc "
                        "format, 2 channels) instead of synthesising")
    p.set_defaults(fn=cmd_produce)

    p = sub.add_parser("consume", help="receive UDP result frames")
    _add_channels(p)
    p.add_argument("--volume", default=None, metavar="OUT.npz",
                   help="accumulate received zdb/zdr frames into a volume "
                        "checkpoint")
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None,
                   help="zdr result port for --volume (defaults to the "
                        "config port)")
    p.set_defaults(fn=cmd_consume)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
