"""Headline benchmark of the port: the full 11-stage chain on one CUDA GPU,
in sectors per second.

    python3 -m wrp_tpu_torch.bench                       # the card, defaults
    python3 -m wrp_tpu_torch.bench --in-dtype wire       # decode on the card
    python3 -m wrp_tpu_torch.bench --smoke --device cpu  # tiny, plain versions

Counterpart of the JAX package's ``bench.py``, with its methodology and its
JSON line (one line on stdout):

* D distinct slabs of seeded int16 IQ (f32 for the non-fused methods) are
  staged on the device, [D*B*C, 2, m, n] (1.61 GB at the defaults: batch
  128, 3 x 1024 x 512, D = 2); the timed span runs `repeats` passes over
  them.
* method "pallas" (the fused CUDA chain): step i reads slab i % D through
  the kernel's OFFSET entry (no copy) with salt i, so no two steps compute
  the same function of the staged input; `--in-dtype wire` stages raw wire
  bytes and decodes them on the card inside the span (`--wire-decode
  fused`: in the wire kernel, from int32 words; `xla`: a torch decode pass
  feeding the planar kernel).  Other methods add a per-repeat salt
  8 (r % 127 + 1) / w_d[j], which the chain's mean subtraction cancels.
* Every step's products are summed into a device accumulator; one D2H
  fetch of it closes the span (kernel launches are asynchronous: a host
  clock without that fence would time the enqueue).  Best of 3 spans.
* A parity gate runs before the span: the harness at salt 0 (and at a
  salt) against the unsalted SectorProcessor, ``oracle.relative_l2`` of zdb
  under 1e-4 (1e-3 salted), else it prints {"error": ...} and exits 1.
* Secondary metrics: the H2D rate of the staging, sectors/s with the H2D of
  each batch (plain and pipelined: the next batch's copy on a copy stream
  from pinned memory while the current one computes), and `calib_tflops`,
  256 serial 4096^3 bf16 torch.matmuls, the card's delivered rate.

`--sharded N` runs the pallas harness data-parallel on N ranks, one
process each (rank k on cuda:k over NCCL, or on the CPU over gloo with
`--device cpu`): each rank stages its B/N sectors of every slab and runs
the salted offset loop over them; a timed span is the slowest rank's
(all_reduce MAX between two barriers), and `value` is B * steps over it.
Its parity gate: every rank's salted harness on its own share (the offset
entry at that rank's offsets, salt 0 and 7, against the unsalted processor
on the same sectors; `parity_rel_l2` is the worst rank's), and the JAX
bench's sharded gate on the same [N, 1] mesh: the data-parallel pallas
step, the mxu step and the halo step (parallel/halo.py), each gathered to
rank 0, against the unsharded processor there (1e-4 pallas, 1e-3 mxu and
halo).  `h2d_gbps` is every rank's staged bytes over the slowest rank's
copy; the one-card secondary metrics (sectors/s with H2D, plain and
pipelined, and the calibration) are null.  It refuses what
the JAX bench refuses, with its exit code 1 (a method other than pallas,
`--in-dtype wire`, a batch N does not divide), and N above the GPU count
(exit 2: NCCL takes one rank a GPU, and fewer ranks would be another
measurement).

`--profile DIR` traces one pass of the harness with torch.profiler, after
the gate and before the timed spans (CUDA activity on the card, the CPU
activity alone under `--device cpu`), into DIR/trace.json; under
`--sharded N` each rank traces its own pass, between two barriers, into
DIR/rank{r}/trace.json, and rank 0 gathers every rank's busy share (device
kernel time over the pass's wall time) and logs them with --verbose.  The
JSON line has no profile fields, as the JAX bench's.  The profiled pass
launches the offset entry `steps` more times: a rank's `sharded_launches`
is then (1 profiled + 1 warm + 3 timed) x steps + 2.  A rank whose
profiler fails ends with a non-zero code, and so does the bench.

Not ported: the TPU formulation knobs (`--a-layout`, `--clip`, `--xsplit`,
`--xpair`, `--wire-order`; the CUDA kernels have no such variants) and
their JSON fields.  Without CUDA the bench exits 2 unless `--device cpu`
asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .parallel.launch import end_rank

BASELINE_3CH = 36.1   # the reference's GeForce 930M, prof/g7.prof
BASELINE_2CH = 73.5   # prof/nocin-sep.prof

#: the calibration probe's reading in the run that anchors
#: `value_normalized`: NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi
#: power.limit), the default run of chip_smoke.py's bench phase, whose value
#: was 9,708.94 sectors/s (readings 814.0-833.0 across that call's 8 runs)
RECORD_CALIB_TFLOPS = 821.3

#: the time limit of a --sharded run's ranks, and of its group's collectives
SHARDED_TIMEOUT_S = 900.0


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m wrp_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry (256 x 256), batch 4, 2 x 2 steps; "
                         "runs on --device like any other run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--batch", type=int, default=128, help="sectors per step")
    ap.add_argument("--distinct", type=int, default=2,
                    help="distinct device-staged batches scanned per repeat")
    ap.add_argument("--repeats", type=int, default=48,
                    help="sequential passes over the distinct batches")
    ap.add_argument("--method", default="pallas",
                    choices=["mxu", "parseval", "pallas", "radix", "fft"])
    ap.add_argument("--matched-filter", default="direct",
                    choices=["direct", "fold", "spectral"])
    ap.add_argument("--channels", type=int, default=3, choices=[2, 3],
                    help="2 compares against the reference's 2-channel "
                         "baseline (73.5 sectors/s)")
    # range cells per pulse (default 1024, 256 with --smoke); not in the
    # help: no cell of the benchmark runs another m yet.  It gives other
    # geometries a path through the bench, for chip_smoke.py and the tests:
    # the dense offset entry (fused_chain_power_at) at an m that does not
    # split into radix branches (1000), and the long-ray body of the
    # radix and wire offset entries with their salt (2048)
    ap.add_argument("--range-cells", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--in-dtype", default=None, choices=["f32", "i16", "wire"],
                    help="staged input: default i16 for pallas, f32 "
                         "otherwise; wire stages raw wire bytes and decodes "
                         "them on the device inside the span")
    ap.add_argument("--wire-decode", default="fused", choices=["fused", "xla"],
                    help="with --in-dtype wire: fused = inside the wire "
                         "kernel; xla = a torch decode pass feeding the "
                         "planar kernel (the name is kept from wrp_tpu)")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="the pallas harness data-parallel on N ranks, one "
                         "process and one GPU each, with the sharded parity "
                         "gate (pallas, mxu, halo)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one timed pass to "
                         "DIR/trace.json (under --sharded: each rank's to "
                         "DIR/rank{r}/trace.json)")
    ap.add_argument("--verbose", action="store_true")
    # a rank of --sharded N, started by the launching process
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sharded:
        # the JAX bench's refusals, with its exit code (sys.exit(str): 1)
        if args.method != "pallas":
            sys.exit("--sharded measures the flagship kernel; use --method "
                     "pallas (the mxu sharded path is covered by the parity "
                     "check it runs)")
        if args.in_dtype == "wire":
            sys.exit("--in-dtype wire does not support --sharded")
        if args.sharded < 0:
            ap.error("--sharded N takes N >= 1 ranks")
        if (torch.device(args.device).type == "cuda"
                and torch.cuda.is_available()
                and args.sharded > torch.cuda.device_count()):
            ap.error(f"--sharded {args.sharded} needs {args.sharded} GPUs, "
                     f"this host has {torch.cuda.device_count()} (NCCL takes "
                     "one rank a GPU; fewer ranks would measure something "
                     "else)")
    if args.method == "pallas" and args.matched_filter != "direct":
        ap.error("--matched-filter applies to the non-fused methods")
    if args.in_dtype is None:
        args.in_dtype = "i16" if args.method == "pallas" else "f32"
    if args.in_dtype == "wire" and args.method != "pallas":
        ap.error("--in-dtype wire applies to the pallas method only")
    if args.in_dtype == "wire" and args.distinct < 2:
        # the kernel is salted per step, but the decode's only per-step
        # variation is the slab: with one slab it would be the same work
        ap.error("--in-dtype wire needs --distinct >= 2")
    return ap, args


def card_name(dev: torch.device) -> str:
    """'name, power limit' as nvidia-smi gives them (the CPU: 'cpu')."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        return torch.cuda.get_device_name(dev)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def calibration_probe(dev: torch.device) -> float:
    """The card's delivered bf16 rate: 256 serial 4096^3 torch.matmuls
    (35 TFLOP; each consumes the previous product), TFLOP/s, best of 3."""
    N, STEPS = 4096, 256
    a = torch.full((N, N), 1.0 / N, dtype=torch.bfloat16, device=dev)
    bufs = [a.clone(), torch.empty_like(a)]

    def probe():
        for i in range(STEPS):
            torch.matmul(bufs[i % 2], a, out=bufs[(i + 1) % 2])
        return float(bufs[STEPS % 2][0, 0])      # the D2H fetch fences it

    probe()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        probe()
        runs.append(time.perf_counter() - t0)
    return 2 * N ** 3 * STEPS / min(runs) / 1e12


def _wire_bytes(host_iq: np.ndarray) -> np.ndarray:
    """Planar int16 [S, C, 2, m, n] -> the reference wire [S, m*n*C*4] uint8:
    interleaved big-endian int16, natural row order (io/codec.encode_iq)."""
    s = host_iq.shape[0]
    return (host_iq.transpose(0, 3, 4, 1, 2).astype(">i2", order="C")
            .view(np.uint8).reshape(s, -1))


def consume(acc, zdb, zdr):
    """The accumulator after one step: every output element feeds it."""
    return acc + zdb.sum(dim=0) + torch.where(
        torch.isfinite(zdr), zdr, torch.zeros_like(zdr)).sum(dim=0)


def harness_products(gain: torch.Tensor, b: int, c: int):
    """products(pw): the step's power [b * c, 2, m/2] -> (zdb, zdr)."""
    from .pipeline import stage09_10_products

    def products(pw):
        pw = pw.reshape(b, c, -1)
        return stage09_10_products(pw[:, 0], pw[:, 1], gain)
    return products


def pallas_step_power(staged: torch.Tensor, plan, cfg, D: int, B: int,
                      bcn: int, in_dtype: str, wire_decode: str):
    """step_power(i, salt) of the pallas harness: the power of slab i % D of
    the staged slabs, read in place through the kernel's offset entry with
    `salt`.  `staged`: int16 or f32 planar (`in_dtype` i16 / f32, bcn
    channel-sectors a slab), or the wire (`in_dtype` wire, B sectors a
    slab): int32 words for `wire_decode` fused (the wire kernel), bytes for
    xla (a torch decode pass, then the planar entry)."""
    from .ops import device_codec, fullchain

    c, m, n = cfg.sector_shape
    if plan.radix > 1:
        def power_at(x_all, off, salt):
            return fullchain.fused_chain_power_radix(
                x_all, plan, offset=off, bc=bcn, salt=salt)
    else:
        def power_at(x_all, off, salt):
            del salt            # the dense entry has offsets only
            return fullchain.fused_chain_power_at(x_all, off, bcn, plan)

    if in_dtype != "wire":
        x_all = staged.reshape(D * bcn, 2, m, n)

        def step_power(i, salt):
            return power_at(x_all, (i % D) * bcn, salt)
    elif wire_decode == "fused":
        w32_all = device_codec.wire_words_i32(staged, cfg)

        def step_power(i, salt):
            return fullchain.fused_chain_power_wire(
                w32_all, plan, c, offset=(i % D) * B, bs=B, salt=salt)
    else:
        def step_power(i, salt):
            w = staged[(i % D) * B:(i % D + 1) * B]
            x = device_codec.decode_wire_i16(w, cfg).reshape(bcn, 2, m, n)
            return power_at(x, 0, salt)
    return step_power


def salted_pass(step_power, products, acc0: torch.Tensor, steps: int):
    """timed_pass(): `steps` steps, step i at salt i, their products summed
    into one device accumulator and fetched once (the D2H closes the span:
    launches are asynchronous)."""
    def timed_pass():
        acc = acc0
        for i in range(steps):
            acc = consume(acc, *products(step_power(i, i)))
        return acc.cpu()
    return timed_pass


def harness_parity(proc, x0: torch.Tensor, step_power, products) -> list:
    """The gate's two errors: zdb rel-L2 of the harness's slab 0 at salt 0
    and at salt 7 against the unsalted processor on the same sectors x0."""
    from .oracle import relative_l2

    zdb_ref = proc(x0)[0]
    return [relative_l2(zdb_ref.cpu().numpy(),
                        products(step_power(0, salt))[0].cpu().numpy())
            for salt in (0, 7)]


def run(argv=None) -> dict:
    """Run the benchmark; returns the result dict that `main` prints.
    Refusals exit 2 (argparse; the JAX bench's `--sharded` refusals exit
    1); a failed parity gate prints {"error": ...} and exits 1.  With
    `--sharded N` this process starts the N ranks and returns rank 0's
    result."""
    from .config import DEFAULT_CONFIG, tiny_config
    from .constants import PipelineConstants, hamming_factors
    from .oracle import relative_l2
    from .ops import fullchain
    from .pipeline import SectorProcessor, resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    ap, args = _args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if args.smoke:
        # the smallest geometry where every method runs its own path (the
        # radix method's split needs m and n of at least 2 x 128)
        cfg = tiny_config(m=args.range_cells or 256, n=256,
                          channels=args.channels)
        args.batch, args.distinct, args.repeats = 4, 2, 2
    else:
        import dataclasses

        cfg = dataclasses.replace(
            DEFAULT_CONFIG, num_channels=args.channels,
            num_range_cells=args.range_cells or DEFAULT_CONFIG.m).validate()
    mesh = None
    if args.sharded:
        if args.batch % args.sharded:
            sys.exit(f"--batch {args.batch} must divide by --sharded "
                     f"{args.sharded}")
        if args.rank is None:
            return _launch_ranks(argv, args)
        from .parallel.mesh import init_distributed, make_mesh

        dev = init_distributed(f"127.0.0.1:{args.port}", args.sharded,
                               args.rank, args.device,
                               timeout_s=SHARDED_TIMEOUT_S)
        mesh = make_mesh(data=args.sharded, seq=1, device=dev)
        fullchain.RADIX_OFFSET_LAUNCHES = 0
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or mesh.rank == 0
    baseline = BASELINE_3CH if args.channels == 3 else BASELINE_2CH
    log = ((lambda *a: print(*a, file=sys.stderr, flush=True))
           if args.verbose else (lambda *a: None))
    card = card_name(dev)
    log(f"device: {card}, batch {args.batch}, method {args.method}")

    calib = None
    if not args.smoke and dev.type == "cuda" and mesh is None:
        calib = calibration_probe(dev)
        log(f"calibration: {calib:.1f} TFLOP/s (record {RECORD_CALIB_TFLOPS})")

    c, m, n = cfg.sector_shape
    B, D = args.batch, args.distinct
    b_loc = B // (args.sharded or 1)      # this rank's sectors of a slab
    bcn = b_loc * c
    steps = D * args.repeats
    rng = np.random.default_rng(0)
    host_iq = rng.integers(-8192, 8192, (D, B, c, 2, m, n), dtype=np.int16)
    if args.in_dtype == "f32":
        host_iq = host_iq.astype(np.float32)
    host_wire = None
    if args.in_dtype == "wire":
        host_wire = _wire_bytes(host_iq.reshape(D * B, c, 2, m, n))
        # the fused kernel takes the same bytes viewed as int32 words
        host_stage = (host_wire.view("<i4") if args.wire_decode == "fused"
                      else host_wire)
    else:
        host_stage = host_iq

    if mesh is not None:
        from .parallel.sharded import host_share

        # this rank's B/N sectors of every slab (pallas int16 or f32 only),
        # cut on the host before the copy is timed
        host_stage = np.stack([host_share(host_stage[d], mesh, "data")
                               for d in range(D)])
        _barrier(dev)
    t0 = time.perf_counter()
    staged = torch.from_numpy(host_stage).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_h2d = time.perf_counter() - t0
    h2d_bytes = staged.numel() * staged.element_size()
    if mesh is not None:
        # every rank's bytes over the slowest rank's copy
        t = torch.tensor([t_h2d], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        t_h2d, h2d_bytes = float(t.item()), h2d_bytes * mesh.world
    h2d_gbps = h2d_bytes / t_h2d / 1e9

    consts = PipelineConstants.build(cfg)
    gain = torch.from_numpy(consts.gain).to(dev)
    try:
        proc = SectorProcessor(cfg, method=args.method,
                               matched_filter=args.matched_filter, device=dev,
                               consts=consts)
    except ValueError as e:
        ap.error(str(e))
    acc0 = torch.zeros(cfg.num_output_bins, device=dev)
    products = harness_products(gain, b_loc, c)

    if args.method == "pallas":
        plan = fullchain.build_plan(consts, dev)
        if (plan.radix == 1 and args.in_dtype == "wire"
                and args.wire_decode == "fused"):
            ap.error(f"--wire-decode fused needs the radix kernel; m={m} "
                     "uses the dense kernel (--wire-decode xla)")
        step_power = pallas_step_power(staged, plan, cfg, D, B, bcn,
                                       args.in_dtype, args.wire_decode)
        timed_pass = salted_pass(step_power, products, acc0, steps)

        def parity():
            """The harness at salt 0 and 7 vs the unsalted processor on the
            same sectors (under --sharded, this rank's share of slab 0)."""
            x0 = (staged[0] if mesh is not None
                  else torch.from_numpy(host_iq[0]).to(dev))
            return harness_parity(proc, x0, step_power, products)
    else:
        _, wd, _ = hamming_factors(cfg)
        inv_wd = torch.from_numpy((1.0 / wd).astype(np.float32)).to(dev)
        batches = staged.reshape(D, B, c, 2, m, n)

        def timed_pass():
            acc = acc0
            for r in range(args.repeats):
                salt = (8.0 * (r % 127 + 1)) * inv_wd
                for d in range(D):
                    acc = consume(acc, *proc(batches[d] + salt))
            return acc.cpu()

        def parity():
            """0 (the harness calls proc itself; only the salt varies) and
            the salted batch vs the unsalted one."""
            zdb_ref = proc(batches[0])[0].cpu().numpy()
            return [0.0, relative_l2(
                zdb_ref, proc(batches[0] + 8.0 * inv_wd)[0].cpu().numpy())]

    # the first pass builds the kernel library at first use, then warms up
    t0 = time.perf_counter()
    timed_pass()
    t_compile = time.perf_counter() - t0

    thr0, thr1 = 1e-4, 1e-3
    sharded_parity = None
    err0, err1 = parity()
    ok = err0 < thr0 and err1 < thr1
    if mesh is None:
        log(f"parity: salt 0 {err0:.3e}, salted {err1:.3e}")
        if not ok:
            print(json.dumps({"error": "salted-harness parity check failed",
                              "salt0_rel_l2": err0, "salted_rel_l2": err1}),
                  flush=True)
            sys.exit(1)
    else:
        # every rank's salted harness on its own share, and the JAX bench's
        # sharded gate on rank 0; one MAX gives every rank the worst errors
        # and the verdict
        log(f"rank {mesh.rank} parity: salt 0 {err0:.3e}, salted {err1:.3e}")
        nat = rng.integers(-8192, 8192, (B, c, 2, m, n)).astype(np.float32)
        sharded_parity = _sharded_gate(cfg, proc, mesh, nat)
        if lead:
            log(f"sharded parity: {sharded_parity}")
            ok = ok and sharded_parity["pallas"] < thr0 and max(
                sharded_parity["mxu"], sharded_parity["halo"]) < thr1
        worst = torch.tensor([err0, err1, 0.0 if ok else 1.0],
                             dtype=torch.float64, device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        err0, err1, bad = worst.tolist()
        if bad:
            if lead:
                print(json.dumps({"error": "sharded parity check failed",
                                  "sharded_parity_rel_l2": sharded_parity,
                                  "salt0_rel_l2": err0,
                                  "salted_rel_l2": err1}), flush=True)
            sys.exit(1)

    if args.profile:
        if mesh is not None:
            _barrier(dev)
        path = os.path.join(args.profile, *(
            [f"rank{mesh.rank}"] if mesh is not None else []), "trace.json")
        wall_us, busy_us = profile_pass(timed_pass, dev, path, log)
        if mesh is not None:
            _barrier(dev)
            _log_rank_shares(mesh, dev, wall_us, busy_us, log)
    runs, own_runs = [], []
    for _ in range(3):
        if mesh is not None:
            _barrier(dev)
        t0 = time.perf_counter()
        acc = timed_pass()
        span = time.perf_counter() - t0
        own_runs.append(span)
        if mesh is not None:
            # the slowest rank's span; no collective inside it
            _barrier(dev)
            t = torch.tensor([span], dtype=torch.float64, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            span = float(t.item())
        runs.append(span)
    elapsed = min(runs)
    sectors_s = steps * B / elapsed
    if not bool(torch.isfinite(acc[1:]).all()):
        raise RuntimeError("non-finite zdb accumulator")
    sharded = {}
    if mesh is not None:
        # every rank's launches of the offset entry and its own spans
        mine = torch.tensor([fullchain.RADIX_OFFSET_LAUNCHES, *own_runs],
                            dtype=torch.float64, device=dev)
        parts = [torch.empty_like(mine) for _ in range(mesh.world)]
        dist.all_gather(parts, mine)
        table = torch.stack(parts).cpu().numpy()
        best = int(np.argmin(runs))
        sharded = {"sharded_backend": dist.get_backend(),
                   "sharded_rank_span_s": [round(float(r[1 + best]), 6)
                                           for r in table],
                   "sharded_launches": [int(r[0]) for r in table]}
        if not lead:
            return {"rank": mesh.rank, **sharded}

    # --- with the H2D of each batch (secondary; one card's, so not
    # measured under --sharded) ---
    sectors_s_h2d = sectors_s_pipe = None
    if mesh is None:
        if host_wire is not None:
            proc_stream = SectorProcessor(cfg, method="pallas", device=dev,
                                          consts=consts, wire_input=True,
                                          wire_decode=args.wire_decode)
            slabs = [host_stage[k * B:(k + 1) * B] for k in range(D)]
        else:
            proc_stream = proc
            slabs = list(host_iq)

        def fetch(out):
            return out[0].cpu(), out[1].cpu()

        fetch(proc_stream(torch.from_numpy(slabs[0]).to(dev)))
        t0 = time.perf_counter()
        fetch(proc_stream(torch.from_numpy(slabs[0]).to(dev)))
        sectors_s_h2d = B / (time.perf_counter() - t0)
        sectors_s_pipe = _pipelined(proc_stream, slabs, dev, fetch) * B

    result = {
        "metric": f"sectors_per_second_{cfg.num_channels}ch",
        "value": round(sectors_s, 2),
        "unit": "sectors/s",
        "vs_baseline": round(sectors_s / baseline, 2),
        "pulses_per_second": round(sectors_s * cfg.num_pulses, 0),
        "samples_per_second": round(sectors_s * c * m * n, 0),
        "sectors_per_second_with_h2d": (round(sectors_s_h2d, 2)
                                        if mesh is None else None),
        "sectors_per_second_with_h2d_pipelined": (round(sectors_s_pipe, 2)
                                                  if mesh is None else None),
        "ms_per_sector": round(1e3 / sectors_s, 4),
        "h2d_gbps": round(h2d_gbps, 2),
        "calib_tflops": round(calib, 1) if calib is not None else None,
        "calib_record_tflops": (RECORD_CALIB_TFLOPS
                                if calib is not None else None),
        "value_normalized": (round(sectors_s * RECORD_CALIB_TFLOPS / calib, 2)
                             if calib is not None else None),
        "compile_s": round(t_compile, 1),
        "timed_runs_s": [round(r, 3) for r in runs],
        "batch": B,
        "steps": steps,
        "method": proc.method,
        "sharded_devices": args.sharded or None,
        "sharded_parity_rel_l2": sharded_parity,
        "parity_rel_l2": [round(err0, 9), round(err1, 9)],
        "in_dtype": args.in_dtype,
        "wire_decode": args.wire_decode if host_wire is not None else None,
        "matched_filter": args.matched_filter,
        "device": card,
        "geometry": f"{c}x{m}x{n}",
        "baseline": {"3ch": BASELINE_3CH, "2ch_nocin": BASELINE_2CH,
                     "hw": "GeForce 930M (prof/g7.prof, nocin-sep.prof)"},
        **sharded,
    }
    return result


def profile_pass(timed_pass, dev: torch.device, path: str, log):
    """One pass of the harness under torch.profiler (CUDA activity on the
    card, the CPU activity alone on the CPU), its chrome trace written to
    `path`.  Returns (the pass's wall time, its device kernel time) in
    microseconds."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        timed_pass()
        wall_us = 1e6 * (time.perf_counter() - t0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    log(events.table(sort_by="self_device_time_total" if dev.type == "cuda"
                     else "self_cpu_time_total", row_limit=12))
    log(f"profiled pass: {wall_us / 1e3:.3f} ms, device kernels "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% busy)")
    return wall_us, busy_us


def _log_rank_shares(mesh, dev: torch.device, wall_us: float,
                     busy_us: float, log) -> None:
    """Every rank's (wall, device) time of its profiled pass, gathered on
    every rank (one all_gather, outside any timed span); rank 0 logs each
    rank's busy share and the slowest rank's."""
    mine = torch.tensor([wall_us, busy_us], dtype=torch.float64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(parts, mine)
    if mesh.rank != 0:
        return
    table = torch.stack(parts).cpu().tolist()
    shares = [busy / wall for wall, busy in table]
    slow = max(range(mesh.world), key=lambda r: table[r][0])
    log("profiled pass busy share by rank: " + json.dumps(
        [{"rank": r, "wall_ms": round(w / 1e3, 3),
          "device_ms": round(b / 1e3, 3), "busy_share": round(sh, 6)}
         for r, ((w, b), sh) in enumerate(zip(table, shares))]))
    log(f"profiled pass: the slowest rank, {slow}, "
        f"{table[slow][0] / 1e3:.3f} ms, {100 * shares[slow]:.2f}% busy")


def _barrier(dev: torch.device) -> None:
    if dev.type == "cuda":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


def _sharded_gate(cfg, proc, mesh, nat: np.ndarray):
    """The JAX bench's sharded parity (bench.py:587-616) on this rank's
    mesh: the data-parallel pallas step, the mxu step and the halo step on
    the natural-order batch `nat` [B, C, 2, m, n], each gathered to rank 0
    and held against the unsharded processor there.  Returns
    {name: zdb rel-L2} on rank 0, None elsewhere."""
    from .oracle import relative_l2
    from .parallel import (build_halo_processor, build_sharded_processor,
                           gather_batch, shard_batch)

    want = None
    if mesh.rank == 0:
        want = proc(torch.from_numpy(nat).to(mesh.device))[0].cpu().numpy()
    out = {}
    for name, step in (
            ("pallas", build_sharded_processor(cfg, mesh, "pallas")),
            ("mxu", build_sharded_processor(cfg, mesh, "mxu")),
            ("halo", build_halo_processor(cfg, mesh))):
        zdb = gather_batch(step(shard_batch(nat, mesh, step.layout))[0],
                           mesh, step.layout)
        if mesh.rank == 0:
            out[name] = relative_l2(want, zdb.cpu().numpy())
    return out if mesh.rank == 0 else None


def _launch_ranks(argv, args) -> dict:
    """`--sharded N`: run this command as ranks 0..N-1, one process each
    (a free port for the group's store; once more on a fresh port if the
    store could not bind it), and return rank 0's result.  A failed gate
    prints rank 0's error line and exits 1; any other failed rank
    raises."""
    from .parallel.launch import ROOT, module_env, run_ranks

    results = run_ranks(
        lambda rank, port: [sys.executable, "-m", "wrp_tpu_torch.bench",
                            *argv, "--rank", str(rank), "--port", str(port)],
        args.sharded, SHARDED_TIMEOUT_S, env=module_env(), cwd=ROOT)
    if args.verbose:
        for r in results:
            for line in r.err.splitlines():
                print(f"[rank {r.rank}] {line}", file=sys.stderr, flush=True)
    lines = [ln for ln in results[0].out.splitlines() if ln.startswith("{")]
    if results[0].rc == 1 and lines and "error" in json.loads(lines[-1]):
        print(lines[-1], flush=True)
        sys.exit(1)
    failed = [r for r in results if r.rc != 0]
    if failed or not lines:
        raise RuntimeError("--sharded {}: {}".format(args.sharded, "; ".join(
            f"rank {r.rank} exit {r.rc}: {r.err[-3000:]}" for r in failed)
            or "rank 0 printed no result"))
    return json.loads(lines[-1])


def _pipelined(proc_stream, slabs, dev, fetch) -> float:
    """Batches per second with each batch's H2D in the span, the production
    form: batch k+1's copy (from pinned memory, on a copy stream) overlaps
    batch k's compute, batch k-1's products are fetched last; the span holds
    exactly as many copies as computes.  On the CPU the copies are plain."""
    npipe = max(4, 2 * len(slabs))
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for k in range(npipe):
            fetch(proc_stream(torch.from_numpy(slabs[k % len(slabs)])))
        return npipe / (time.perf_counter() - t0)
    pinned = [torch.from_numpy(s).pin_memory() for s in slabs]
    copy = torch.cuda.Stream(dev)
    compute = torch.cuda.current_stream(dev)

    def put(k):
        with torch.cuda.stream(copy):
            d = pinned[k % len(pinned)].to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy)
        return d, ev

    d_cur, ev = put(0)                 # batch 0 staged outside the span
    ev.synchronize()
    prev = None
    t0 = time.perf_counter()
    for k in range(npipe):
        compute.wait_event(ev)
        d_cur.record_stream(compute)
        out_k = proc_stream(d_cur)      # enqueued, not waited for
        d_cur, ev = put(k + 1)
        if prev is not None:
            fetch(prev)                 # D2H of batch k-1
        prev = out_k
    fetch(prev)
    ev.synchronize()                    # the last copy is in the span too
    return npipe / (time.perf_counter() - t0)


def main(argv=None) -> int:
    try:
        print(json.dumps(run(argv)), flush=True)
    except SystemExit as e:
        if not dist.is_initialized():
            raise
        # a rank of --sharded N stopped by its gate ends as every rank does
        if not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
        end_rank(e.code if isinstance(e.code, int) else 1)
    except Exception:
        if not dist.is_initialized():
            raise
        # a rank that failed (its profiler, a launch) ends non-zero, and
        # the launching process with it
        traceback.print_exc()
        end_rank(1)
    if dist.is_initialized():          # a rank of --sharded N
        end_rank(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
