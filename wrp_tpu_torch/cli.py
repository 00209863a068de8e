"""Command-line entry points of the port (counterpart of wrp_tpu/cli.py):

  process   — single-shot: IQ in, zdb/zdr out (reference read.cc), per-stage
              dumps and timings on request.
  compare   — relative-L2 comparator of two result files (error.cpp).
  stream    — streaming processor: the v1 UDP wire (reference
              gpu_1fp_streamcasc.cu), TCP, or the reference's v2 ZMQ wire
              (rpv2.cu); with --coordinator, one rank of a lock-step
              multi-rank fleet (--pulse-shard: every rank reads one
              broadcast wire and computes a pulse slice of each sector).
  supervise — launch and watch a fleet of `stream` workers with per-feed
              checkpoints; regroup on a worker death (runtime/supervisor.py).
  produce   — synthesise/replay sectors onto the wire.
  consume   — receive result frames, optionally into a volume checkpoint.
  volume    — inspect, export or render a volume checkpoint.

Flags are wrp_tpu's where they apply, plus --device (default cuda; without
CUDA the command exits non-zero rather than running on the CPU).  compare
and volume are host commands, as in wrp_tpu: they touch no device.

Usage: python -m wrp_tpu_torch.cli <subcommand> --help
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
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


def _add_transport(p):
    p.add_argument("--transport", default="udp", choices=["udp", "tcp", "zmq"],
                   help="udp: the reference's v1 wire; tcp: framed, "
                        "lossless replay (io/tcp.py); zmq: the reference's "
                        "v2 pub/sub wire (io/zmq_io.py, needs pyzmq)")


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

    if args.timings:
        for name, us in _stage_timings(planar, cfg, device):
            print(f"stage {name}: {us:.0f} us", file=sys.stderr)

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


def _stage_timings(planar: np.ndarray, cfg, device) -> list:
    """[(stage, us)]: the fft path's six stages, from the window to the
    pulse sum, one after the other on `device` (the read_gpu.cu tick/tock
    methodology): each stage boundary is fenced with a device synchronise
    before the timestamp, as `jax.block_until_ready` fences it in
    ``wrp_tpu``.  The first call of each stage includes its one-time costs
    (cuFFT plans, allocations)."""
    import torch

    from . import pipeline as pl_mod
    from .constants import PipelineConstants

    consts = PipelineConstants.build(cfg)
    hamming = torch.from_numpy(np.asarray(consts.hamming, np.float32)).to(device)
    stages = [
        ("01hamm", lambda x: pl_mod.stage01_window(x, hamming)),
        ("02fft1", pl_mod.stage02_range_fft),
        ("03fft2", pl_mod.stage03_doppler),
        ("04abs", pl_mod.stage04_power),
        ("07conv", lambda p: pl_mod.matched_filter_direct(p, consts.ma_taps)),
        ("08pow", pl_mod.stage08_pulse_sum),
    ]

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    x = torch.complex(torch.from_numpy(np.asarray(planar[:, 0], np.float32)),
                      torch.from_numpy(np.asarray(planar[:, 1], np.float32)))
    x = x.to(device)
    fence()
    marks = []
    t_last = time.perf_counter()
    for name, fn in stages:
        x = fn(x)
        fence()
        now = time.perf_counter()
        marks.append((name, (now - t_last) * 1e6))
        t_last = now
    return marks


def cmd_compare(args):
    """The reference's accuracy comparator (error.cpp:9-36): relative L2
    over the mutually finite values of two result files.  A `.bin` file is
    the reference's native-endian zdb capture (out/cpu.bin), any other an
    ASCII matrix.  Host only."""
    from . import oracle
    from .io.files import read_ascii_matrix, read_zdb_dump

    def load(path):
        return read_zdb_dump(path) if path.endswith(".bin") else \
            read_ascii_matrix(path)

    expected, actual = load(args.expected), load(args.actual)
    if expected.shape != actual.shape:
        print(f"shape mismatch: {expected.shape} vs {actual.shape}",
              file=sys.stderr)
        return 2
    err = oracle.relative_l2(expected, actual)
    print(json.dumps({"relative_l2": err, "threshold": args.threshold,
                      "pass": err <= args.threshold}))
    return 0 if err <= args.threshold else 1


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

    from .runtime import StreamingExecutor, configure_logging

    configure_logging(args.log_level, args.structured_logs)
    device = _device_or_exit(args.device)
    if device is None:
        return 2
    # refusals come before any socket is bound or group joined: a refusal
    # after setup would leave peers blocked in the group's handshake
    if args.feed_port and args.transport == "zmq":
        # zmq feeds are endpoints: ignoring the ports would listen on one
        # default endpoint and lose the feeds without a word
        print("--feed-port supports the udp and tcp transports only; "
              "zmq feeds are endpoints (--feed-endpoint)", file=sys.stderr)
        return 2
    if args.feed_endpoint and args.transport != "zmq":
        print("--feed-endpoint supports the zmq transport only; "
              "udp/tcp feeds are ports (--feed-port)", file=sys.stderr)
        return 2
    if args.feed_endpoint and len(set(args.feed_endpoint)) != len(
            args.feed_endpoint):
        # two SUBs on one endpoint would each receive every message:
        # duplicated sectors under colliding per-feed labels
        print("duplicate --feed-endpoint values", file=sys.stderr)
        return 2
    feeds = args.feed_port or args.feed_endpoint or []
    if args.feed_checkpoint:
        # the supervisor keys checkpoints by feed, so that they follow a
        # feed across regroups; counts must match or volumes shift feeds
        if not feeds or len(args.feed_checkpoint) != len(feeds):
            print("--feed-checkpoint needs one path per --feed-port/"
                  "--feed-endpoint", file=sys.stderr)
            return 2
        if len(set(args.feed_checkpoint)) != len(args.feed_checkpoint):
            print("duplicate --feed-checkpoint paths", file=sys.stderr)
            return 2
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
    transport, publish = _stream_transport(args, cfg)

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
    prof = None
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        ex.timers.enable_intervals(annotate=True)
        prof = _start_trace(device)
    try:
        stats = ex.run()
    finally:
        if prof is not None:
            prof.stop()
        for t in (transport if isinstance(transport, list) else [transport]):
            t.close()
        publish.close()
    if prof is not None:
        _write_trace(prof, ex.timers.intervals, args.trace)
    if volume is not None:
        vols = volume if isinstance(volume, list) else [volume]
        for v in vols:
            v.save()
        cov = [v.fraction() for v in vols]
        stats["volume_coverage"] = cov if len(cov) > 1 else cov[0]
    stats["kernel_launches"] = _chain_launches()
    print(json.dumps(stats, indent=2))
    if args.coordinator:
        from .parallel.launch import end_rank

        # with a dead peer the teardown can block: the barrier and the
        # teardown wait at most the collective timeout (10 s at least)
        end_rank(0, max(10.0, args.collective_timeout or 0.0))
    return 0


#: the chrome trace `stream --trace DIR` writes, as `bench --profile DIR`
TRACE_FILE = "trace.json"


def _start_trace(device):
    """A running torch.profiler over every thread of this process (the
    ingest threads start inside `ex.run()`): CPU activity, and CUDA
    activity on a CUDA device, so the executor's stage spans
    (`StageTimers` with annotate) lie in one trace with the kernels."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))
    prof.start()
    return prof


def _write_trace(prof, intervals, out_dir) -> None:
    """DIR/trace.json (chrome trace) and DIR/host_intervals.json, the
    executor's [name, thread, t0, t1] rows, for tools/trace_summary.py
    --overlap."""
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
    ipath = os.path.join(out_dir, "host_intervals.json")
    with open(ipath, "w") as f:
        json.dump(intervals, f)
    print(f"trace written to {out_dir} (host intervals: {ipath})",
          file=sys.stderr)


def _stream_transport(args, cfg):
    """(ingest or list of ingests, egress) for `stream --transport`.
    Multi-feed consolidation: one ingest per --feed-port (udp, tcp) or
    --feed-endpoint (zmq), one SHARED egress (result frames carry only
    sector/elevation, so the per-feed checkpoints are the authoritative
    volumes); one ingest on --ingest-port / --zmq-sub otherwise.  Called
    after every refusal: it binds sockets."""
    if args.transport == "zmq":
        from .io.zmq_io import ZmqEgress, ZmqIngest

        timeout_ms = int(args.timeout * 1e3) if args.timeout else None
        if args.feed_endpoint:
            # a single SUB cannot attribute messages to feeds
            transport = [ZmqIngest(cfg, endpoint=e, timeout_ms=timeout_ms)
                         for e in args.feed_endpoint]
        else:
            transport = ZmqIngest(cfg, endpoint=args.zmq_sub,
                                  timeout_ms=timeout_ms)
        return transport, ZmqEgress(cfg, endpoint=args.zmq_pub)
    if args.transport == "tcp":
        from .io.tcp import TcpEgress, TcpIngest

        ingest_cls, kw = TcpIngest, {}
        publish = TcpEgress(cfg, port=args.result_port)
    else:
        from .io.udp import UdpEgress, UdpIngest

        # pulse-shard ranks on one host read ONE broadcast port; elsewhere
        # no sharing (unicast datagrams would be split between the sockets)
        ingest_cls, kw = UdpIngest, {"reuse_port": args.pulse_shard}
        publish = UdpEgress(cfg, zdb_port=args.zdb_port,
                            zdr_port=args.zdr_port,
                            extended=args.extended_results)
    if args.feed_port:
        transport = [ingest_cls(cfg, port=p, timeout_s=args.timeout)
                     for p in args.feed_port]
    else:
        transport = ingest_cls(cfg, port=args.ingest_port,
                               timeout_s=args.timeout, **kw)
    return transport, publish


def _chain_launches() -> dict:
    """This process's launches of the chain kernels (the wrappers' counters
    in ops/fullchain.py; 0 on the CPU), for a worker's stats."""
    from .ops import fullchain

    return {"radix": fullchain.LAUNCHES, "wire": fullchain.WIRE_LAUNCHES,
            "dense": fullchain.DENSE_LAUNCHES,
            "astage": fullchain.ASTAGE_LAUNCHES,
            "rows": fullchain.PARSEVAL_ROWS_LAUNCHES}


def cmd_supervise(args):
    """Coordinator-led failure recovery for a fleet of stream workers
    (runtime/supervisor.py): on a worker death the survivors are drained,
    the dead host's feeds are reassigned to survivors, and a smaller
    lock-step group relaunches from the per-feed checkpoints.  The
    reference's dataflow (rpv2.cu) loses the whole in-memory volume in
    this scenario.  The workers run on --device, which they receive with
    the other worker flags."""
    import signal
    import threading
    from pathlib import Path

    from .runtime import configure_logging
    from .runtime.supervisor import FeedSpec, Supervisor

    configure_logging(args.log_level, args.structured_logs)

    # service managers stop the supervisor with SIGTERM: the graceful path
    # (stop the fleet, report "interrupted"), as in cmd_stream
    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _sigterm)
    if args.device_decode and args.method != "pallas":
        # refuse here, not through every worker exiting 2 at warmup, which
        # the supervisor would retry as infra flake until max_generations
        print("--device-decode requires --method pallas", file=sys.stderr)
        return 2
    ckdir = Path(args.checkpoint_dir)
    ckdir.mkdir(parents=True, exist_ok=True)
    if args.transport == "zmq":
        if args.feed_port:
            print("--feed-port supports the udp and tcp transports "
                  "only; zmq feeds are endpoints (--feed-endpoint)",
                  file=sys.stderr)
            return 2
        if not args.feed_endpoint:
            print("zmq supervision needs --feed-endpoint (zmq feeds are "
                  "endpoints the workers' SUB sockets connect to)",
                  file=sys.stderr)
            return 2
        # checkpoint names derive from the sanitised endpoint, so the same
        # feed maps to the same file across supervisor restarts too
        feeds = [FeedSpec(port=None, endpoint=e,
                          checkpoint=ckdir / ("feed-" + re.sub(
                              r"[^A-Za-z0-9_.-]+", "-", e) + ".npz"))
                 for e in args.feed_endpoint]
    else:
        if args.feed_endpoint:
            print("--feed-endpoint supports the zmq transport only; "
                  "udp/tcp feeds are ports (--feed-port)", file=sys.stderr)
            return 2
        if not args.feed_port:
            print(f"{args.transport} supervision needs --feed-port",
                  file=sys.stderr)
            return 2
        feeds = [FeedSpec(port=p, checkpoint=ckdir / f"feed{p}.npz")
                 for p in args.feed_port]
    try:
        sup = Supervisor(
            feeds, args.hosts if args.hosts is not None else len(feeds),
            transport=args.transport,
            batch=args.batch, method=args.method, timeout=args.timeout,
            collective_timeout=args.collective_timeout,
            target_sectors=args.target_sectors,
            max_generations=args.max_generations,
            regrow_after_s=args.regrow_after,
            zdb_port=args.zdb_port, zdr_port=args.zdr_port,
            result_port=args.result_port,
            ready_timeout_s=args.ready_timeout,
            state_file=args.state_file,
            log_dir=ckdir / "logs",   # postmortems of host deaths
            pulse_shard=args.pulse_shard,
            extra_args=(["--log-level", args.log_level,
                         "--device", args.device]
                        + (["--device-decode"] if args.device_decode
                           else [])
                        + (["--channels", str(args.channels)]
                           if args.channels != 3 else [])),
        )
    except ValueError as e:          # usage errors, as in the other
        print(e, file=sys.stderr)    # subcommands
        return 2
    summary = sup.run()
    print(json.dumps(summary, indent=2))
    return 0 if summary["ok"] else 4


def cmd_volume(args):
    """Inspect, export or render a volume-scan checkpoint (the persistent
    form of the reference's in-memory result[2, 512, 143, 9] buffer,
    rpv2.cu:292).  Host only."""
    from pathlib import Path

    from .runtime import VolumeScan

    vs = VolumeScan.load(args.checkpoint)   # geometry is self-describing
    covered = vs.coverage
    info = {
        "coverage": round(vs.fraction(), 4),
        "sectors_covered": int(covered.sum()),
        "elevations_touched": int(covered.any(axis=0).sum()),
        "complete": vs.complete(),
    }
    if covered.any():
        # zdb = data[0], zdr = data[1] (read_single.cc:496-498)
        for name, plane in (("zdb", vs.data[0]), ("zdr", vs.data[1])):
            vals = plane[1:, covered]    # skip the always -inf/NaN bin 0
            finite = vals[np.isfinite(vals)]
            if finite.size:
                info[f"{name}_min"] = round(float(finite.min()), 2)
                info[f"{name}_max"] = round(float(finite.max()), 2)
                info[f"{name}_mean"] = round(float(finite.mean()), 2)
    print(json.dumps(info))
    if args.export:
        np.savez(args.export, zdb=vs.data[0], zdr=vs.data[1],
                 coverage=vs.coverage)
        print(f"exported -> {args.export}", file=sys.stderr)
    if args.export_ascii:
        # one 99result-format file per covered sector (lines of "zdb zdr",
        # out/99result.cpu.out), for reference-era tooling and `compare`
        from .io.files import write_ascii_matrix

        outdir = Path(args.export_ascii)
        outdir.mkdir(parents=True, exist_ok=True)
        n_files = 0
        for sec, elev in np.argwhere(covered):
            pair = np.stack([vs.data[0, :, sec, elev],
                             vs.data[1, :, sec, elev]], axis=1)
            write_ascii_matrix(outdir / f"s{int(sec):03d}e{int(elev)}.out",
                               pair)
            n_files += 1
        print(f"exported {n_files} sectors (99result format) -> {outdir}",
              file=sys.stderr)
    plane = {"zdb": 0, "zdr": 1}[args.product]
    if args.render:
        from . import viz

        field = np.array(vs.data[plane, :, :, args.elevation])
        field[:, ~vs.coverage[:, args.elevation]] = np.nan  # uncovered
        viz.write_ppm(args.render, viz.render_ppi(field, size=args.render_size))
        print(f"rendered {args.product} elevation {args.elevation} "
              f"-> {args.render}", file=sys.stderr)
    if args.render_all:
        from . import viz

        img = viz.render_volume_mosaic(np.asarray(vs.data[plane]), vs.coverage,
                                       size=min(args.render_size, 256))
        viz.write_ppm(args.render_all, img)
        print(f"rendered {args.product} mosaic of {vs.data.shape[-1]} cuts "
              f"-> {args.render_all}", file=sys.stderr)
    return 0


def cmd_produce(args):
    from .io import codec
    from .oracle import produce_sector_iq

    cfg = _cfg_from_args(args)
    if args.transport == "tcp":
        from .io.tcp import TcpProducer

        producer = TcpProducer(cfg, host=args.host, port=args.ingest_port)
    elif args.transport == "zmq":
        from .io.zmq_io import ZmqProducer

        producer = ZmqProducer(cfg, endpoint=args.zmq_bind,
                               extended_headers=args.headers)
        time.sleep(args.connect_delay)  # PUB/SUB join grace
    else:
        from .io.udp import UdpProducer

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
        # a zmq PUB queues sends to an io thread: close() flushes the tail
        # (bounded linger) before the process exits
        producer.close()
    print(f"sent {sent} sectors", file=sys.stderr)
    return 0


def cmd_consume(args):
    from .runtime import VolumeScan

    cfg = _cfg_from_args(args)
    vs = VolumeScan(cfg, args.volume) if args.volume else None
    have: dict = {}

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

    if args.transport == "udp":
        _consume_udp(args, cfg, add if vs is not None else None)
    else:
        _consume_v2(args, cfg, add if vs is not None else None)
    if vs is not None:
        p = vs.save()
        print(f"volume -> {p} (coverage {vs.fraction():.4f})", file=sys.stderr)
    return 0


def _consume_v2(args, cfg, add) -> None:
    """consume --transport tcp|zmq: topic-tagged v2 frames on one
    connection, zdb (topic B) and zdr (topic C) alike; `add` accumulates
    them into the volume when there is one."""
    if args.transport == "tcp":
        from .io.tcp import TcpResultConsumer

        consumer = TcpResultConsumer(cfg, port=args.port,
                                     timeout_s=args.timeout)
    else:
        from .io.zmq_io import ZmqResultConsumer

        consumer = ZmqResultConsumer(cfg, endpoint=args.zmq_sub,
                                     timeout_ms=int(args.timeout * 1e3))
    got = 0
    try:
        while got < args.count:
            item = consumer.recv()
            if item is None:
                break
            topic, sector, elevation, values = item
            print(f"{topic.decode()}: sector {sector} elev {elevation}: "
                  f"{values[:4]} ...")
            got += 1
            if add is not None:
                add(0 if topic == cfg.zmq_zdb_topic else 1,
                    sector, elevation, values)
    finally:
        consumer.close()


def _consume_udp(args, cfg, add) -> None:
    """consume --transport udp: v1/v1x frames, zdb and zdr on separate
    ports (the zdr port is bound only to accumulate a volume)."""
    import select
    import socket
    import struct

    from .io import frames

    def bind(port):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", port))
        return s

    socks = {bind(args.port or cfg.udp_zdb_port): 0}
    if add is not None:
        socks[bind(args.zdr_port or cfg.udp_zdr_port)] = 1

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
            if add is not None:
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
        if add is not None:
            # grace drain: the final sector's zdr frame may trail its zdb
            end = time.monotonic() + 0.5
            while time.monotonic() < end:
                drain_ready(0.1)
    finally:
        for s in socks:
            s.close()


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: wrp_tpu's subcommands and flags (all but stream's
    --wire-order: rows stay in natural order), plus --device."""
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
    p.add_argument("--timings", action="store_true",
                   help="per-stage wall-clock breakdown of the fft path on "
                        "--device, each stage fenced by a synchronise "
                        "(read_gpu.cu tick/tock equivalent)")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("compare",
                       help="relative-L2 comparator (error.cpp equivalent)")
    p.add_argument("expected")
    p.add_argument("actual")
    p.add_argument("--threshold", type=float, default=1e-4)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("stream", help="streaming processor (udp, tcp or "
                                      "zmq transport)")
    _add_common(p)
    _add_channels(p)
    _add_transport(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--ingest-port", type=int, default=None)
    p.add_argument("--feed-port", type=int, action="append", default=None,
                   metavar="PORT",
                   help="udp/tcp: repeat to multiplex several radar feeds "
                        "into one processor (one ingest per port, per-feed "
                        "stats and checkpoints); overrides --ingest-port")
    p.add_argument("--feed-endpoint", action="append", default=None,
                   metavar="ENDPOINT",
                   help="zmq: repeat to multiplex several v2 feeds into one "
                        "processor (one SUB socket per endpoint, per-feed "
                        "stats and checkpoints); overrides --zmq-sub")
    p.add_argument("--zdb-port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None)
    p.add_argument("--zmq-sub", default=None,
                   help="zmq: the ingest endpoint to subscribe to")
    p.add_argument("--zmq-pub", default=None,
                   help="zmq: the endpoint the result PUB socket binds")
    p.add_argument("--result-port", type=int, default=None,
                   help="tcp: result collector port")
    p.add_argument("--checkpoint", default=None,
                   help="volume .npz path; resumes coverage if it exists")
    p.add_argument("--feed-checkpoint", action="append", default=None,
                   metavar="PATH",
                   help="explicit per-feed volume .npz (once per "
                        "--feed-port/--feed-endpoint, same order): keyed "
                        "by feed, so a supervisor can move feeds between "
                        "hosts across regroups")
    p.add_argument("--checkpoint-every", type=float, default=30.0,
                   help="periodic save interval in seconds (0 saves "
                        "every batch; negative disables periodic saves)")
    p.add_argument("--extended-results", action="store_true",
                   help="udp: emit v1x result frames carrying the elevation")
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
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace (DIR/"
                        "trace.json) with every executor stage annotated, "
                        "from every thread, plus DIR/host_intervals.json; "
                        "summarise with `python -m wrp_tpu_torch.tools."
                        "trace_summary DIR --overlap`")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser(
        "supervise",
        help="launch and watch a fleet of stream workers; regroup on death")
    _add_common(p)
    _add_channels(p)
    _add_transport(p)
    p.add_argument("--feed-port", type=int, action="append", default=None,
                   metavar="PORT", help="udp/tcp: one radar feed per flag")
    p.add_argument("--feed-endpoint", action="append", default=None,
                   metavar="ENDPOINT",
                   help="zmq: one v2 feed (PUB endpoint to subscribe) per "
                        "flag; pair with `produce --headers` so sectors "
                        "carry labels (the bare v2 wire is positional and "
                        "cannot resume soundly after a regroup)")
    p.add_argument("--result-port", type=int, default=None,
                   help="tcp: result collector port")
    p.add_argument("--hosts", type=int, default=None,
                   help="initial worker-process count (default: one per "
                        "feed); more than one needs a GPU per host (NCCL) "
                        "or --device cpu (gloo)")
    p.add_argument("--pulse-shard", action="store_true",
                   help="redundant fleet: exactly ONE broadcast feed (udp "
                        "broadcast / zmq pub) that every host ingests "
                        "whole; workers run `stream --pulse-shard`, a host "
                        "death re-slices, and the freshest per-host volume "
                        "copy seeds each generation")
    p.add_argument("--checkpoint-dir", required=True,
                   help="per-feed volumes land here as feed<PORT>.npz and "
                        "FOLLOW the feed across regroups; worker logs in "
                        "its logs/")
    p.add_argument("--target-sectors", type=int, default=None,
                   help="stop successfully once every feed's checkpoint "
                        "holds N sectors")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--device-decode", action="store_true",
                   help="workers decode wire bytes on the device (needs "
                        "--method pallas; see stream --device-decode)")
    p.add_argument("--collective-timeout", type=float, default=30.0)
    p.add_argument("--ready-timeout", type=float, default=300.0,
                   metavar="S",
                   help="a generation whose warmup (group join, kernel "
                        "load) exceeds S without any worker dying ends the "
                        "run with reason ready_timeout")
    p.add_argument("--max-generations", type=int, default=8)
    p.add_argument("--regrow-after", type=float, default=None, metavar="S",
                   help="after a shrink, once the smaller fleet has been "
                        "ready and healthy S seconds, probe one host back "
                        "up toward the starting count")
    p.add_argument("--zdb-port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None)
    p.add_argument("--state-file", default=None,
                   help="append one JSON line per supervisor event "
                        "(launch/ready/host_death/regroup/grow/done)")
    p.set_defaults(fn=cmd_supervise)

    p = sub.add_parser("volume", help="inspect/export a volume checkpoint")
    p.add_argument("checkpoint", help="volume .npz path")
    p.add_argument("--export", default=None, help="write plain .npz arrays")
    p.add_argument("--export-ascii", default=None, metavar="DIR",
                   help="write one 99result-format ASCII file per covered "
                        "sector ('zdb zdr' lines) for reference-era tooling "
                        "and `compare`")
    p.add_argument("--render", default=None, metavar="OUT.ppm",
                   help="render a PPI image of one elevation cut (binary "
                        "PPM, no imaging dependencies)")
    p.add_argument("--render-all", default=None, metavar="OUT.ppm",
                   help="render every elevation cut as one tiled mosaic "
                        "with a shared color scale")
    p.add_argument("--product", default="zdb", choices=["zdb", "zdr"])
    p.add_argument("--elevation", type=int, default=0)
    p.add_argument("--render-size", type=int, default=512)
    p.set_defaults(fn=cmd_volume)

    p = sub.add_parser("produce", help="send sectors onto the wire")
    _add_channels(p)
    _add_transport(p)
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
    p.add_argument("--zmq-bind", default="tcp://*:5563",
                   help="zmq: the endpoint the sector PUB socket binds")
    p.add_argument("--headers", action="store_true",
                   help="extended ingest headers (drop detection; zmq: a "
                        "label frame)")
    p.add_argument("--input", default=None, metavar="IQ.altb",
                   help="replay a captured ASCII IQ sector (read.cc "
                        "format, 2 channels) instead of synthesising")
    p.add_argument("--connect-delay", type=float, default=0.5,
                   help="zmq: seconds to wait for subscribers to join "
                        "before the first send")
    p.set_defaults(fn=cmd_produce)

    p = sub.add_parser("consume", help="receive result frames")
    _add_channels(p)
    _add_transport(p)
    p.add_argument("--volume", default=None, metavar="OUT.npz",
                   help="accumulate received zdb/zdr frames into a volume "
                        "checkpoint")
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None,
                   help="udp --volume: zdr result port (defaults to the "
                        "config port)")
    p.add_argument("--zmq-sub", default="tcp://localhost:5564",
                   help="zmq: the result endpoint to subscribe to")
    p.set_defaults(fn=cmd_consume)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
