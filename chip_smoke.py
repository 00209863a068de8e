#!/usr/bin/env python3
"""Smoke test of the port on one CUDA GPU: builds the kernels, checks them,
and drives the stream paths end to end.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases (each prints its results; any failure raises and exits non-zero):

1. environment: torch/CUDA versions, the card's name and power limit;
   fails without CUDA;
2. build: compiles wrp_tpu_torch/csrc with nvcc (first use) and times it;
3. the radix kernel vs its plain torch version at 3 x 1024 x 512, batch 16
   (48 channel-sectors), int16 and f32 input, on seeded noise and on an
   adversarial input whose Doppler energy sits in the clipped bins;
   power rel-L2 <= 1e-5 against the plain version and against the fp64
   oracle, zdb/zdr <= 2e-4; CUDA-event timings of both;
4. the wire kernel on the same sectors' wire words, 3- and 2-channel: vs
   its plain version, vs the radix kernel on the host-decoded planar
   sectors, and vs the oracle, with the same bounds;
5. the dense kernel at 3 x 1000 x 512, batch 16 (m does not split into
   radix branches), and at m = 40 and m = 8: vs plain and oracle;
6. the host-decode slice: a `cli produce` process (UdpProducer) ->
   UdpIngest (loopback) -> StreamingExecutor (method="pallas", batch 16)
   -> UdpEgress + VolumeScan, one elevation cut of 143 sectors at
   21.45/s; requires 0 drops, full cut coverage, the radix kernel's launch
   count, and zdb/zdr of sampled sectors within 2e-4 of the oracle;
7. the device-decode slice: the same with device_decode=True (the wire
   kernel; the host only views the wire bytes);
8. capacity: the executor fed from memory, unpaced, host decode and
   device decode;
9. the dense path: the executor at m = 1000 from memory, device decode
   (a decode pass, then the dense kernel) and host decode;
10. the A-stage kernel (the pulse-sharded path's first half) on the noise
   and clip-bin sectors, int16 and f32, on every rank's pulse slab of 1, 2
   and 4 ranks (w = 512, 256, 128): Y vs its plain version (rel-L2 <=
   1e-5); CUDA-event times of the kernel, the plain version and the library
   call torch.matmul(A_half, X) in complex64;
11. the row-epilogue kernel on every row shard of that Y (rows = 512, 256,
   128): power vs its plain version (<= 1e-5), and its time;
12. the pallas-seq composition in one process for N = 1, 2 and 4 ranks:
   A-stage per pulse slab, the all_to_all's row/pulse rearrangement done
   locally (parallel/sharded.py split_rows/join_pulses), row epilogue per
   row shard; power vs the fused radix kernel (<= 1e-5) and the fp64
   oracle, zdb/zdr <= 2e-4;
13. the pulse-shard lock-step stream: an NCCL group of world size 1,
   PulseShardedProcessor(method="pallas") as the processor of a lock-step
   StreamingExecutor (collective timeout 30 s), 143 sectors from `cli
   produce` at 21.45/s, host decode then device decode; 0 drops, 143/143,
   the A-stage and row-epilogue launches equal to the steps (batches plus
   the warmup step), sampled products within 2e-4 of the oracle.

Every launch counter is set to 0 just before each path runs and read just
after.  Prints a JSON line of per-kernel results (launches, errors, ms,
plain ms, bound ms), then as its last line {"ok": true, "device": {...}}.
A bound is the least work of the function (the range DFT as an FFT, or
the bytes moved); the matrix form the kernels run is printed beside it.
Imports torch, numpy and wrp_tpu_torch only.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from wrp_tpu_torch import oracle  # noqa: E402
from wrp_tpu_torch.config import DEFAULT_CONFIG, tiny_config  # noqa: E402
from wrp_tpu_torch.constants import PipelineConstants, hamming_factors  # noqa: E402
from wrp_tpu_torch.io import codec, frames  # noqa: E402
from wrp_tpu_torch.io.udp import UdpEgress, UdpIngest  # noqa: E402
from wrp_tpu_torch.ops import _build, device_codec, fullchain  # noqa: E402
from wrp_tpu_torch.parallel.multihost import (  # noqa: E402
    PulseShardedProcessor, init_distributed)
from wrp_tpu_torch.parallel.sharded import join_pulses, split_rows  # noqa: E402
from wrp_tpu_torch.pipeline import stage09_10_products  # noqa: E402
from wrp_tpu_torch.runtime import StreamingExecutor, VolumeScan  # noqa: E402

BATCH = 16
SECTORS = 143             # one elevation cut of DEFAULT_CONFIG
RATE = 21.45              # sectors/s: a real radar's cut rate
POWER_TOL = 1e-5
PRODUCT_TOL = 2e-4
SEED = 2024
DENSE_M = 1000            # radix_for(1000) == 1: the dense kernel's geometry
SHARDS = (1, 2, 4)        # ranks of the pulse-sharded path

# H100 SXM peaks for the bound (NVIDIA data sheet, 700 W): fp32 on the CUDA
# cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def astage_flops(m: int, w: int) -> float:
    """The least fp32 flops of the windowed half-spectrum range DFT for one
    channel-sector of w pulses, for the bound: the window (2 per complex
    sample) and one length-m FFT per pulse column (5 m log2 m, the
    conventional count; the repo's `fft` method), whatever form the kernel
    runs."""
    return w * (2.0 * m + 5.0 * m * math.log2(m))


def chain_flops(m: int, n: int) -> float:
    """The least fp32 flops of the fused chain for one channel-sector, for
    the bound: `astage_flops` and the Parseval epilogue (26 flops per
    element of Y [m/2, n]: window 2, mean 2, centring 2, energy 4, four
    phasor projections 16)."""
    return astage_flops(m, n) + 26.0 * (m // 2) * n


def algorithm_note(m: int, w: int, bc: int) -> str:
    """The work of the algorithm the kernels run, as the TPU kernels do (the
    range DFT as a matrix contraction), beside the bound, never as it: the
    radix-R DIT form (R = fullchain.radix_for(m); 8 flops per complex
    multiply-add, m * m/R * w of them, and R per output element in the
    combine), or the dense A_half contraction when R is 1."""
    radix = fullchain.radix_for(m)
    if radix > 1:
        flops = 8.0 * (m * (m // radix) * w + (m // 2) * radix * w)
        form = f"radix-{radix} contraction"
    else:
        flops = 8.0 * (m // 2) * m * w
        form = "dense contraction"
    flops *= bc
    return (f"the kernel's {form} does {flops / 1e9:.1f} GFLOP, "
            f"{1e3 * flops / PEAK_FP32:.3f} ms at the fp32 peak")


def reset_counts() -> None:
    fullchain.LAUNCHES = fullchain.WIRE_LAUNCHES = fullchain.DENSE_LAUNCHES = 0
    fullchain.ASTAGE_LAUNCHES = fullchain.PARSEVAL_ROWS_LAUNCHES = 0


def read_counts() -> dict:
    return {"radix": fullchain.LAUNCHES, "wire": fullchain.WIRE_LAUNCHES,
            "dense": fullchain.DENSE_LAUNCHES,
            "astage": fullchain.ASTAGE_LAUNCHES,
            "rows": fullchain.PARSEVAL_ROWS_LAUNCHES}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        raise SmokeFailure(what)


def rel(expected, actual) -> float:
    return oracle.relative_l2(expected, actual)


def rel_dev(expected: torch.Tensor, actual: torch.Tensor):
    """(rel-L2, max abs error) of two tensors on the card, in float64."""
    d = actual.double() - expected.double()
    return (float(torch.linalg.vector_norm(d)
                  / torch.linalg.vector_norm(expected.double())),
            float(d.abs().max()))


def phase_environment() -> str:
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "test needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{_build.library_path().name}", flush=True)
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        print("build steps (wall s, sources in parallel, then the link): "
              + ", ".join(ln[3:] for ln in log.read_text().splitlines()
                          if ln.startswith("== ")), flush=True)
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in log.read_text().splitlines()
                       if "Used" in ln and "registers" in ln})
        print(f"ptxas registers per thread across instantiations: {regs}",
              flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median ms of `fn()` over `reps` warm runs, timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def adversarial_sector(cfg, seed: int = 3) -> np.ndarray:
    """Doppler energy concentrated in a CLIPPED bin, so the Parseval
    subtraction n sum|q|^2 - |q.f_k|^2 cancels hard (the case of
    tests/test_pallas.py::test_clip_modes_vs_oracle_adversarial)."""
    m, n = cfg.m, cfg.n
    _, wd, _ = hamming_factors(cfg)
    rng = np.random.default_rng(seed)
    j = np.arange(n)
    k = n // 2 - 2
    ph0 = rng.uniform(0, 2 * np.pi, (cfg.num_channels, m, 1))
    base = np.cos(2 * np.pi * k * j / n + ph0) / wd[None, None, :]
    adv = (6000 * base / np.abs(base).max()
           + 1j * rng.integers(-50, 50, (cfg.num_channels, m, n)))
    return np.round(adv.real) + 1j * np.round(adv.imag)


def planar_i16(iq: np.ndarray) -> np.ndarray:
    return np.stack([iq.real, iq.imag], axis=-3).astype(np.int16)


def timed(fns: dict, order) -> dict:
    """CUDA-event ms of each named fn, run in `order` (e.g. plain, kernel,
    kernel, plain); the best of each name's turns."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(cuda_ms(fns[name]))
    print("timings (median of 10 per turn, order " + "/".join(order) + "): "
          + json.dumps(times), flush=True)
    return {name: min(v) for name, v in times.items()}


class Oracle:
    """fp64 oracle power of each input sector, computed once."""

    def __init__(self):
        self._pow = {}

    def power(self, key, iq, cfg) -> np.ndarray:
        if key not in self._pow:
            self._pow[key] = oracle.channel_power(iq, cfg)
        return self._pow[key][: cfg.num_channels]


def check_vs_oracle(what: str, pk: np.ndarray, pow64: np.ndarray, cfg,
                    gain: torch.Tensor) -> None:
    """Power [C, m/2] of one sector vs the oracle's; zdb/zdr too."""
    ep = max(rel(pow64[c], pk[c]) for c in range(cfg.num_channels))
    zdb64, zdr64 = oracle.stage09_10_products(pow64[0], pow64[1], cfg)
    pkt = torch.from_numpy(np.ascontiguousarray(pk)).cuda()
    zdb, zdr = (t.cpu().numpy() for t in stage09_10_products(
        pkt[0], pkt[1], gain))
    ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
    check(ep <= POWER_TOL and ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
          and zdb[0] == -np.inf,
          f"{what} vs fp64 oracle: power {ep:.3e}, zdb {ezdb:.3e}, zdr "
          f"{ezdr:.3e}, zdb[0] {zdb[0]}")


def planar_kernel_checks(name, kernel, plan, cfg, inputs, orc, gain):
    """A planar kernel (radix or dense) vs its plain version and the oracle,
    int16 and f32 input; returns (worst rel-L2, max abs error) vs plain."""
    worst_rel = max_abs = 0.0
    for label, (x_np, oracle_sectors) in inputs.items():
        x16 = torch.from_numpy(x_np).cuda().reshape(-1, 2, cfg.m, cfg.n)
        for x in (x16, x16.float()):
            got = kernel(x, plan)
            torch.cuda.synchronize()
            ref = fullchain.fused_chain_power_reference(x, plan)
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            e = rel(r, g)
            worst_rel = max(worst_rel, e)
            max_abs = max(max_abs, float(np.max(np.abs(g - r))))
            check(e <= POWER_TOL, f"{name} {label} {x.dtype}: kernel vs plain "
                                  f"power rel-L2 {e:.3e} <= {POWER_TOL}")
            for s, iq in enumerate(oracle_sectors):
                pk = g.reshape(-1, cfg.num_channels, cfg.m // 2)[s]
                check_vs_oracle(f"{name} {label} {x.dtype} sector {s}", pk,
                                orc.power((cfg.m, cfg.n, label, s), iq, cfg), cfg,
                                gain)
    return worst_rel, max_abs


def phase_kernel(orc: Oracle, noise, adv) -> dict:
    cfg = DEFAULT_CONFIG
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")
    check(plan.radix == 8, f"production geometry takes radix 8 (got "
                           f"{plan.radix}), tile {fullchain.kernel_tile(plan)}")
    gain = torch.from_numpy(consts.gain).cuda()
    inputs = {"noise": (np.stack([planar_i16(s) for s in noise]), noise[:3]),
              "clip-bin": (np.stack([planar_i16(adv)] * BATCH), [adv])}
    worst_rel, max_abs = planar_kernel_checks(
        "radix", fullchain.fused_chain_power_radix, plan, cfg, inputs, orc,
        gain)

    # R = 4 and R = 2 geometries (tiny, correctness only)
    for m, n in ((32, 64), (16, 64)):
        tcfg = tiny_config(m=m, n=n)
        tplan = fullchain.build_plan(PipelineConstants.build(tcfg), "cuda")
        rng = np.random.default_rng(m)
        x = torch.from_numpy(rng.integers(-8192, 8192, (9, 2, m, n))
                             .astype(np.int16)).cuda()
        g = fullchain.fused_chain_power_radix(x, tplan).cpu().numpy()
        r = fullchain.fused_chain_power_reference(x, tplan).cpu().numpy()
        check(rel(r, g) <= POWER_TOL,
              f"m={m} n={n} radix {tplan.radix}: kernel vs plain rel-L2 "
              f"{rel(r, g):.3e}")

    x16 = torch.from_numpy(inputs["noise"][0]).cuda().reshape(-1, 2, cfg.m,
                                                               cfg.n)
    t = timed({"plain": lambda: fullchain.fused_chain_power_reference(x16, plan),
               "kernel": lambda: fullchain.fused_chain_power_radix(x16, plan)},
              ("plain", "kernel", "kernel", "plain"))
    bc = x16.shape[0]
    bound_ms, bound_by = bound(
        bc * chain_flops(cfg.m, cfg.n),
        x16.numel() * 2 + plan.a_kernel.numel() * 4 + bc * cfg.m // 2 * 4)
    print(f"radix kernel, batch {BATCH} x {cfg.num_channels} x {cfg.m} x "
          f"{cfg.n} int16: {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}); "
          f"{algorithm_note(cfg.m, cfg.n, bc)}", flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by}


def wire_batch(sectors, cfg) -> np.ndarray:
    return np.stack([np.frombuffer(codec.encode_iq(iq[: cfg.num_channels],
                                                   cfg), np.uint8)
                     for iq in sectors])


def phase_kernel_wire(orc: Oracle, noise, adv) -> dict:
    """The wire kernel on wire words of the phase-3
    sectors, 3- and 2-channel: vs its plain version, vs the radix kernel on
    the host-decoded planar sectors, and vs the oracle."""
    worst_rel = max_abs = 0.0
    out = {}
    for ch in (3, 2):
        cfg = dataclasses.replace(DEFAULT_CONFIG, num_channels=ch)
        consts = PipelineConstants.build(cfg)
        plan = fullchain.build_plan(consts, "cuda", channels=ch)
        gain = torch.from_numpy(consts.gain).cuda()
        for label, sectors, n_oracle in (("noise", noise, 3),
                                         ("clip-bin", [adv] * BATCH, 1)):
            wires = wire_batch(sectors, cfg)
            w32 = device_codec.wire_words_i32(
                torch.from_numpy(wires).cuda(), cfg).contiguous()
            planar = torch.from_numpy(np.stack([
                codec.decode_iq_i16(w.tobytes(), cfg) for w in wires])).cuda()
            via_radix = fullchain.fused_chain_power_radix(
                planar.reshape(-1, 2, cfg.m, cfg.n), plan).reshape(
                    BATCH, ch, -1).cpu().numpy()
            ref = fullchain.fused_chain_power_wire_reference(
                w32, plan, ch).cpu().numpy()
            got = fullchain.fused_chain_power_wire(w32, plan, ch)
            torch.cuda.synchronize()
            g = got.cpu().numpy()
            e, er = rel(ref, g), rel(via_radix, g)
            check(e <= POWER_TOL and er <= POWER_TOL,
                  f"wire {ch}ch {label}: kernel vs plain {e:.3e}, vs radix "
                  f"kernel on host-decoded sectors {er:.3e} (<= {POWER_TOL})")
            worst_rel = max(worst_rel, e)
            max_abs = max(max_abs, float(np.max(np.abs(g - ref))))
            for s in range(n_oracle):
                check_vs_oracle(
                    f"wire {ch}ch {label} sector {s}", g[s],
                    orc.power((cfg.m, cfg.n, label, s), sectors[s],
                              DEFAULT_CONFIG)[:ch], cfg, gain)
        if ch == 3:
            w32 = device_codec.wire_words_i32(
                torch.from_numpy(wire_batch(noise, cfg)).cuda(),
                cfg).contiguous()
            t = timed({
                "plain": lambda: fullchain.fused_chain_power_wire_reference(
                    w32, plan, ch),
                "kernel": lambda: fullchain.fused_chain_power_wire(
                    w32, plan, ch)},
                ("plain", "kernel", "kernel", "plain"))
            bound_ms, bound_by = bound(
                BATCH * ch * chain_flops(cfg.m, cfg.n),
                w32.numel() * 4 + plan.a_kernel.numel() * 4
                + BATCH * ch * cfg.m // 2 * 4)
            print(f"wire kernel, {BATCH} sectors x {ch} x {cfg.m} x {cfg.n} "
                  f"words: {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
                  f"bound {bound_ms:.3f} ms ({bound_by}); "
                  f"{algorithm_note(cfg.m, cfg.n, BATCH * ch)}", flush=True)
            out = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "bound_ms": bound_ms, "bound_by": bound_by}
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, **out}


def phase_kernel_dense(orc: Oracle) -> dict:
    """The dense kernel at m = 1000 (batch 16 x 3 channels) and at m = 40
    and m = 8: vs its plain version and the oracle."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=DENSE_M)
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")
    check(plan.radix == 1, f"m={DENSE_M} takes the dense form (radix "
                           f"{plan.radix}), tile {fullchain.dense_tile(plan)}")
    gain = torch.from_numpy(consts.gain).cuda()
    noise = [oracle.synthetic_iq(cfg, kind="noise", seed=SEED + b)
             for b in range(BATCH)]
    adv = adversarial_sector(cfg)
    inputs = {"noise": (np.stack([planar_i16(s) for s in noise]), noise[:3]),
              "clip-bin": (np.stack([planar_i16(adv)] * BATCH), [adv])}
    worst_rel, max_abs = planar_kernel_checks(
        "dense", fullchain.fused_chain_power_dense, plan, cfg, inputs, orc,
        gain)
    for m, n in ((40, 32), (8, 16)):
        tcfg = tiny_config(m=m, n=n)
        tconsts = PipelineConstants.build(tcfg)
        tplan = fullchain.build_plan(tconsts, "cuda")
        sectors = [oracle.synthetic_iq(tcfg, kind="noise", seed=m + k)
                   for k in range(3)]
        tin = {"tiny noise": (np.stack([planar_i16(s) for s in sectors]),
                              sectors)}
        e, a = planar_kernel_checks(
            f"dense m={m} n={n} tile {fullchain.dense_tile(tplan)}",
            fullchain.fused_chain_power_dense, tplan, tcfg, tin, orc,
            torch.from_numpy(tconsts.gain).cuda())
        worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)

    x16 = torch.from_numpy(inputs["noise"][0]).cuda().reshape(-1, 2, cfg.m,
                                                               cfg.n)
    t = timed({"plain": lambda: fullchain.fused_chain_power_reference(x16, plan),
               "kernel": lambda: fullchain.fused_chain_power_dense(x16, plan)},
              ("plain", "kernel", "kernel", "plain"))
    bc = x16.shape[0]
    bound_ms, bound_by = bound(
        bc * chain_flops(cfg.m, cfg.n),
        x16.numel() * 2 + plan.a_kernel.numel() * 4 + bc * cfg.m // 2 * 4)
    print(f"dense kernel, batch {BATCH} x {cfg.num_channels} x {cfg.m} x "
          f"{cfg.n} int16: {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}); "
          f"{algorithm_note(cfg.m, cfg.n, bc)}", flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by}


def seq_inputs(noise, adv) -> dict:
    """The phase-3 sectors as [48, 2, m, n] int16 on the card."""
    cfg = DEFAULT_CONFIG
    return {label: torch.from_numpy(np.stack([planar_i16(s) for s in secs]))
            .cuda().reshape(-1, 2, cfg.m, cfg.n)
            for label, secs in (("noise", noise), ("clip-bin", [adv] * BATCH))}


def phase_kernel_astage(noise, adv) -> dict:
    """The A-stage kernel on every rank's pulse slab of 1, 2 and 4 ranks,
    vs its plain version; times of the kernel, plain and library call; the
    fused radix kernel timed in the same call."""
    cfg = DEFAULT_CONFIG
    plan = fullchain.build_plan(PipelineConstants.build(cfg), "cuda")
    inputs = seq_inputs(noise, adv)
    worst_rel = max_abs = 0.0
    for label, x16 in inputs.items():
        for x in (x16, x16.float()):
            for shards in SHARDS:
                w = cfg.n // shards
                errs = []
                for k in range(shards):
                    slab = x[..., k * w:(k + 1) * w].contiguous()
                    got = fullchain.fused_chain_astage(slab, plan)
                    torch.cuda.synchronize()
                    errs.append(rel_dev(
                        fullchain.fused_chain_astage_reference(slab, plan), got))
                e, a = max(v[0] for v in errs), max(v[1] for v in errs)
                worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)
                check(e <= POWER_TOL,
                      f"astage {label} {x.dtype} w={w} ({shards} slabs): "
                      f"kernel vs plain Y rel-L2 {e:.3e} <= {POWER_TOL} "
                      f"(max abs {a:.3e})")

    consts = PipelineConstants.build(cfg)
    a_c = torch.complex(*(torch.from_numpy(np.ascontiguousarray(v)).float()
                          for v in (consts.op_a_half.real,
                                    consts.op_a_half.imag))).cuda()
    x16 = inputs["noise"]
    bc = x16.shape[0]
    out = {}
    for shards in SHARDS:
        w = cfg.n // shards
        slab = x16[..., :w].contiguous()
        xc = torch.complex(slab[:, 0].float(), slab[:, 1].float())
        t = timed({
            "plain": lambda: fullchain.fused_chain_astage_reference(slab, plan),
            "kernel": lambda: fullchain.fused_chain_astage(slab, plan),
            "library": lambda: torch.matmul(a_c, xc)},
            ("plain", "kernel", "library", "library", "kernel", "plain"))
        bound_ms, bound_by = bound(
            bc * astage_flops(cfg.m, w),
            slab.numel() * 2 + plan.a_kernel.numel() * 4
            + bc * 2 * (cfg.m // 2) * w * 4)
        print(f"astage kernel, {bc} channel-sectors x {cfg.m} x w={w} "
              f"int16: {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
              f"library (complex64 matmul) {t['library']:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({bound_by}); "
              f"{algorithm_note(cfg.m, w, bc)}", flush=True)
        if shards == 1:
            out = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t["library"], "bound_ms": bound_ms,
                   "bound_by": bound_by}
    fused = timed({"fused": lambda: fullchain.fused_chain_power_radix(x16, plan)},
                  ("fused", "fused"))["fused"]
    out.update(max_abs_err=max_abs, rel_l2=worst_rel, fused_ms=fused)
    return out


def phase_kernel_rows(noise, adv, astage: dict) -> dict:
    """The row-epilogue kernel on every row shard of the A-stage's Y at
    rows = 512, 256, 128, vs its plain version; its time at full rows."""
    cfg = DEFAULT_CONFIG
    plan = fullchain.build_plan(PipelineConstants.build(cfg), "cuda")
    mh = cfg.m // 2
    worst_rel = max_abs = 0.0
    ys = {label: fullchain.fused_chain_astage(x, plan)
          for label, x in seq_inputs(noise, adv).items()}
    for label, y_full in ys.items():
        for shards in SHARDS:
            rows = mh // shards
            errs = []
            for d in range(shards):
                y = y_full[:, :, d * rows:(d + 1) * rows].contiguous()
                got = fullchain.parseval_rows_power(y, plan)
                torch.cuda.synchronize()
                errs.append(rel_dev(
                    fullchain.parseval_rows_power_reference(y, plan), got))
            e, a = max(v[0] for v in errs), max(v[1] for v in errs)
            worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)
            check(e <= POWER_TOL,
                  f"rows {label} rows={rows} ({shards} shards): kernel vs "
                  f"plain power rel-L2 {e:.3e} <= {POWER_TOL} (max abs "
                  f"{a:.3e})")
    y = ys["noise"]
    t = timed({"plain": lambda: fullchain.parseval_rows_power_reference(y, plan),
               "kernel": lambda: fullchain.parseval_rows_power(y, plan)},
              ("plain", "kernel", "kernel", "plain"))
    bc = y.shape[0]
    bound_ms, bound_by = bound(26.0 * bc * mh * cfg.n,
                               y.numel() * 4 + 5 * cfg.n * 4 + bc * mh * 4)
    print(f"row-epilogue kernel, Y [{bc}, 2, {mh}, {cfg.n}]: "
          f"{t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}); A-stage + rows "
          f"{astage['ms'] + t['kernel']:.3f} ms vs the fused radix kernel "
          f"{astage['fused_ms']:.3f} ms in this call "
          f"({(astage['ms'] + t['kernel']) / astage['fused_ms']:.2f}x)",
          flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_seq_composition(orc: Oracle, noise, adv) -> None:
    """pallas-seq for N = 1, 2, 4 ranks in one process: the A-stage on each
    pulse slab, the all_to_all's rearrangement done locally with the
    functions sharded.py feeds to all_to_all_single, the row epilogue on
    each row shard; vs the fused radix kernel and the fp64 oracle."""
    cfg = DEFAULT_CONFIG
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")
    gain = torch.from_numpy(consts.gain).cuda()
    sectors = {"noise": noise[:3], "clip-bin": [adv]}
    for label, x16 in seq_inputs(noise, adv).items():
        fused = fullchain.fused_chain_power_radix(x16, plan)
        for shards in SHARDS:
            w = cfg.n // shards
            sends = [split_rows(fullchain.fused_chain_astage(
                x16[..., k * w:(k + 1) * w].contiguous(), plan), shards)
                for k in range(shards)]
            got = torch.cat([fullchain.parseval_rows_power(join_pulses(
                torch.stack([sends[k][d] for k in range(shards)])).contiguous(),
                plan) for d in range(shards)], dim=-1)
            torch.cuda.synchronize()
            e, a = rel_dev(fused, got)
            check(e <= POWER_TOL,
                  f"pallas-seq N={shards} {label}: power vs the fused radix "
                  f"kernel rel-L2 {e:.3e} <= {POWER_TOL} (max abs {a:.3e})")
            pk = got.cpu().numpy().reshape(-1, cfg.num_channels, cfg.m // 2)
            for s, iq in enumerate(sectors[label]):
                check_vs_oracle(f"pallas-seq N={shards} {label} sector {s}",
                                pk[s], orc.power((cfg.m, cfg.n, label, s), iq,
                                                 cfg), cfg, gain)


def phase_pulse_shard_stream(device_decode: bool) -> dict:
    """The pulse-shard lock-step stream at world size 1 (NCCL): the
    processor override of a lock-step executor, fed by a `cli produce`
    process at the radar's rate."""
    tag = "device-decode" if device_decode else "host-decode"
    cfg = DEFAULT_CONFIG
    pool_n = 8
    proc = PulseShardedProcessor.build(cfg, batch=BATCH, method="pallas",
                                       device_decode=device_decode,
                                       device="cuda")
    check(proc.mesh.world == 1 and proc.mesh.seq_group is not None
          and proc.wire_input == device_decode,
          f"pulse-shard {tag}: processor on {proc.mesh.device}, mesh "
          f"{proc.mesh.shape}, backend {dist.get_backend()}")
    ingest = UdpIngest(cfg, port=0, timeout_s=2.0)
    sink = _Sink()
    egress = UdpEgress(cfg, zdb_port=sink.ports[0], zdr_port=sink.ports[1],
                       extended=True)
    volume = VolumeScan(cfg)
    producer: list = []
    cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
           "--sectors", str(SECTORS), "--rate", str(RATE),
           "--pool", str(pool_n), "--seed", str(SEED), "--headers",
           "--ingest-port", str(ingest.local_port)]
    ex = StreamingExecutor(
        cfg, transport=ingest, publish=egress, batch=BATCH, volume=volume,
        max_sectors=SECTORS, idle_limit=15, processor=proc.step_local,
        lockstep=True, collective_timeout_s=30.0,
        on_ready=lambda: producer.append(subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)))),
        device_decode=device_decode)
    reset_counts()
    try:
        stats = ex.run()
    finally:
        counts = read_counts()
        for p in producer:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        ingest.close()
        egress.close()
        time.sleep(0.5)
        sink.close()
    check(bool(producer) and producer[0].returncode == 0,
          "producer process exited 0")
    lat = stats["latency_ms"]
    print(f"pulse-shard {tag} stream: {stats['processed_sectors']} sectors "
          f"in {stats['batches']} lock-step batches, delivered "
          f"{ex.throughput.active_rate():.2f} sectors/s over the active span; "
          f"latency p50 {lat['p50_ms']} ms p99 {lat['p99_ms']} ms (lock-step "
          f"waits for full batches); stall warnings {stats['stall_warnings']};"
          f" egress frames {sink.frames}; launches {counts}; mean ms per call "
          + json.dumps({k: v["mean_ms"] for k, v in stats["timers"].items()}),
          flush=True)
    tr = stats["transport"]
    check(stats["processed_sectors"] == SECTORS,
          f"pulse-shard {tag}: {stats['processed_sectors']}/{SECTORS} sectors")
    check(tr["dropped_sectors"] == 0 and tr["dropped_datagrams"] == 0,
          f"pulse-shard {tag}: 0 drops (dropped sectors "
          f"{tr['dropped_sectors']}, datagrams {tr['dropped_datagrams']})")
    check(bool(volume.coverage[:, 0].all()),
          f"pulse-shard {tag}: volume covers the cut "
          f"({int(volume.coverage[:, 0].sum())}/{cfg.num_sectors})")
    check(sink.frames == [SECTORS, SECTORS],
          f"pulse-shard {tag}: egress delivered {sink.frames} frames")
    steps = stats["batches"] + 1       # the batches and the warmup step
    check(stats["batches"] == math.ceil(SECTORS / BATCH)
          and counts["astage"] == counts["rows"] == steps
          and counts["radix"] == counts["wire"] == counts["dense"] == 0,
          f"pulse-shard {tag}: A-stage and row-epilogue launches "
          f"{counts['astage']}, {counts['rows']} == {stats['batches']} full "
          f"lock-step batches + 1 warmup step; no other kernel ({counts})")
    for k in (0, SECTORS // 4, 5 * SECTORS // 7, SECTORS - 1):
        zdb64, zdr64 = oracle.process_sector(
            oracle.produce_sector_iq(cfg, SEED, k % pool_n), cfg)
        zdb, zdr = volume.data[0, :, k, 0], volume.data[1, :, k, 0]
        ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
        check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
              and zdb[0] == -np.inf,
              f"pulse-shard {tag} sector {k} vs fp64 oracle: zdb "
              f"{ezdb:.3e}, zdr {ezdr:.3e}, zdb[0] {zdb[0]}")
    return counts


def phase_pulse_shard() -> dict:
    """Both pulse-shard streams inside one NCCL group of world size 1 (one
    card: NCCL refuses two ranks on one GPU, so the 2-rank path is held on
    the CPU by tests/test_torch_multihost.py)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dev = init_distributed(f"127.0.0.1:{port}", 1, 0, "cuda", timeout_s=120)
    check(dist.get_backend() == "nccl", f"process group on {dev}: "
          f"{dist.get_backend()}, world {dist.get_world_size()}")
    try:
        host = phase_pulse_shard_stream(device_decode=False)
        phase_pulse_shard_stream(device_decode=True)
    finally:
        dist.destroy_process_group()
    return host


class _Sink:
    """Collects egress frames on two loopback sockets (zdb, zdr)."""

    def __init__(self):
        self.socks = []
        for _ in range(2):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
            s.bind(("127.0.0.1", 0))
            s.settimeout(0.2)
            self.socks.append(s)
        self.frames = [0, 0]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def ports(self):
        return [s.getsockname()[1] for s in self.socks]

    def _run(self):
        while not self._stop.is_set():
            for k, s in enumerate(self.socks):
                try:
                    frames.unpack_result_udp(s.recv(65536))
                    self.frames[k] += 1
                except socket.timeout:
                    pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        for s in self.socks:
            s.close()


def phase_stream(device_decode: bool) -> dict:
    """The radar's sender is its own process (`cli produce`, which drives
    UdpProducer), as in deployment.  A producer thread inside this process
    dropped 9 of 143 sectors at the radar's rate on an H100 host: it and
    the Python ingest loop share one interpreter, and a paced 1 MB burst
    overran the 4.2 MB receive buffer while ingest waited for it.  Sector
    k's IQ is produce_sector_iq(cfg, SEED, k % POOL) (`--pool`), so the
    oracle can recompute any sector.  device_decode=True ships the wire
    bytes to the device (the wire kernel decodes them)."""
    tag = "device-decode" if device_decode else "host-decode"
    cfg = DEFAULT_CONFIG
    pool_n = 8
    ingest = UdpIngest(cfg, port=0, timeout_s=2.0)
    sink = _Sink()
    egress = UdpEgress(cfg, zdb_port=sink.ports[0], zdr_port=sink.ports[1],
                       extended=True)
    volume = VolumeScan(cfg)
    producer: list = []
    cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
           "--sectors", str(SECTORS), "--rate", str(RATE),
           "--pool", str(pool_n), "--seed", str(SEED), "--headers",
           "--ingest-port", str(ingest.local_port)]
    ex = StreamingExecutor(
        cfg, transport=ingest, publish=egress, batch=BATCH, method="pallas",
        volume=volume, max_sectors=SECTORS, idle_limit=15,
        on_ready=lambda: producer.append(subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)))),
        device="cuda", device_decode=device_decode)
    reset_counts()
    try:
        stats = ex.run()
    finally:
        counts = read_counts()
        for proc in producer:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        ingest.close()
        egress.close()
        time.sleep(0.5)
        sink.close()
    check(bool(producer) and producer[0].returncode == 0,
          "producer process exited 0")
    print(f"{tag} stream stats: " + json.dumps(
        {k: stats[k] for k in ("processed_sectors", "sectors_per_second",
                               "latency_ms", "transport", "device")}),
        flush=True)
    lat = stats["latency_ms"]
    print(f"{tag} stream: {stats['processed_sectors']} sectors, requested "
          f"{RATE}/s, delivered {ex.throughput.active_rate():.2f} sectors/s "
          f"over the active span; latency p50 {lat['p50_ms']} ms p99 "
          f"{lat['p99_ms']} ms; mean ingest/decode "
          f"{stats['timers']['ingest/decode']['mean_ms']} ms; egress frames "
          f"{sink.frames}; launches {counts}", flush=True)
    samples = ex.latency.samples()
    worst = sorted(range(len(samples)), key=samples.__getitem__)[-3:]
    print(f"{tag} stream: worst latencies (arrival index: ms) " + ", ".join(
        f"{k}: {1e3 * samples[k]:.3f}" for k in reversed(worst)), flush=True)
    tr = stats["transport"]
    check(stats["processed_sectors"] == SECTORS,
          f"{stats['processed_sectors']}/{SECTORS} sectors processed")
    check(tr["dropped_sectors"] == 0 and tr["dropped_datagrams"] == 0,
          f"0 drops (dropped sectors {tr['dropped_sectors']}, datagrams "
          f"{tr['dropped_datagrams']})")
    check(bool(volume.coverage[:, 0].all()),
          f"volume covers the cut: {int(volume.coverage[:, 0].sum())}/"
          f"{cfg.num_sectors} sectors of elevation 0")
    need = math.ceil(SECTORS / BATCH)
    kernel = "wire" if device_decode else "radix"
    check(counts[kernel] >= need, f"{kernel} kernel launched {counts[kernel]} "
                                  f"times during the run (>= {need})")
    check(sink.frames == [SECTORS, SECTORS],
          f"egress delivered {sink.frames} zdb/zdr frames")
    for k in (0, SECTORS // 4, 5 * SECTORS // 7, SECTORS - 1):
        zdb64, zdr64 = oracle.process_sector(
            oracle.produce_sector_iq(cfg, SEED, k % pool_n), cfg)
        zdb, zdr = volume.data[0, :, k, 0], volume.data[1, :, k, 0]
        ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
        check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
              and zdb[0] == -np.inf,
              f"sector {k} vs fp64 oracle: zdb {ezdb:.3e}, zdr {ezdr:.3e}, "
              f"zdb[0] {zdb[0]}")
    return counts


class _MemoryFeed:
    """A transport that hands out pre-encoded wire sectors as fast as the
    executor takes them: the executor's capacity without the UDP wire."""

    def __init__(self, wires, count: int, num_sectors: int):
        self.wires, self.count, self.num_sectors = wires, count, num_sectors
        self.k = 0

    def recv_sector(self):
        if self.k >= self.count:
            return None, None
        k, self.k = self.k, self.k + 1
        return (self.wires[k % len(self.wires)],
                frames.IngestHeader(k % self.num_sectors, 0, 0))


def phase_capacity(device_decode: bool, count: int = 2 * SECTORS) -> None:
    """Unpaced run of the same executor fed from memory; products must be
    finite.  Reports sectors/s over the active span (first to last batch)."""
    cfg = DEFAULT_CONFIG
    tag = "device-decode" if device_decode else "host-decode"
    wires = [codec.encode_iq(oracle.produce_sector_iq(cfg, SEED, j), cfg)
             for j in range(4)]
    volume = VolumeScan(cfg)
    ex = StreamingExecutor(cfg, transport=_MemoryFeed(wires, count,
                                                      cfg.num_sectors),
                           batch=BATCH, method="pallas", volume=volume,
                           max_sectors=count, idle_limit=1, device="cuda",
                           device_decode=device_decode)
    reset_counts()
    stats = ex.run()
    counts = read_counts()
    lat = stats["latency_ms"]
    timers = {k: v["mean_ms"] for k, v in stats["timers"].items()}
    print(f"{tag} capacity: {stats['processed_sectors']} sectors unpaced "
          f"from memory, {ex.throughput.active_rate():.2f} sectors/s over the "
          f"active span; latency p50 {lat['p50_ms']} ms p99 {lat['p99_ms']} "
          f"ms; launches {counts}; mean ms per call {json.dumps(timers)}",
          flush=True)
    check(stats["processed_sectors"] == count,
          f"{tag} capacity run processed {stats['processed_sectors']}/{count}")
    check(bool(np.isfinite(volume.data[:, 1:, :, 0]).all()),
          f"{tag} capacity run products finite beyond bin 0")


def phase_dense_path() -> int:
    """The executor at m = 1000 (no radix split) from memory: device decode
    (decode_wire_i16, then the dense kernel) and host decode.  Sampled
    sectors within 2e-4 of the oracle; returns the dense kernel's launches
    over both runs."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=DENSE_M)
    count = 2 * BATCH
    iqs = [oracle.produce_sector_iq(cfg, SEED, j) for j in range(4)]
    wires = [codec.encode_iq(iq, cfg) for iq in iqs]
    launches = 0
    for device_decode in (True, False):
        tag = "device-decode" if device_decode else "host-decode"
        volume = VolumeScan(cfg)
        ex = StreamingExecutor(cfg, transport=_MemoryFeed(wires, count,
                                                          cfg.num_sectors),
                               batch=BATCH, method="pallas", volume=volume,
                               max_sectors=count, idle_limit=1, device="cuda",
                               device_decode=device_decode)
        reset_counts()
        stats = ex.run()
        counts = read_counts()
        print(f"dense path m={DENSE_M}, {tag}: {stats['processed_sectors']} "
              f"sectors, {ex.throughput.active_rate():.2f} sectors/s; "
              f"launches {counts}", flush=True)
        check(stats["processed_sectors"] == count
              and counts["dense"] >= count // BATCH
              and counts["radix"] == counts["wire"] == 0,
              f"dense path {tag}: {stats['processed_sectors']}/{count} "
              f"sectors through the dense kernel only ({counts})")
        for k in range(4):
            zdb64, zdr64 = oracle.process_sector(iqs[k], cfg)
            zdb, zdr = volume.data[0, :, k, 0], volume.data[1, :, k, 0]
            ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
            check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
                  and zdb[0] == -np.inf,
                  f"dense path {tag} sector {k} vs fp64 oracle: zdb "
                  f"{ezdb:.3e}, zdr {ezdr:.3e}")
        launches += counts["dense"]
    return launches


def kernel_entry(name, source, replaces, launches, res) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "rel_l2": res["rel_l2"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            # None: no single PyTorch call computes the function (the fused
            # chains, the row epilogue)
            "library_ms": res.get("library_ms")}


def main() -> int:
    phase_environment()
    phase_build()
    orc = Oracle()
    cfg = DEFAULT_CONFIG
    noise = [oracle.synthetic_iq(cfg, kind="noise", seed=SEED + b)
             for b in range(BATCH)]
    adv = adversarial_sector(cfg)
    radix = phase_kernel(orc, noise, adv)
    wire = phase_kernel_wire(orc, noise, adv)
    dense = phase_kernel_dense(orc)
    astage = phase_kernel_astage(noise, adv)
    rows = phase_kernel_rows(noise, adv, astage)
    phase_seq_composition(orc, noise, adv)
    host = phase_stream(device_decode=False)
    dev = phase_stream(device_decode=True)
    phase_capacity(device_decode=False)
    phase_capacity(device_decode=True)
    dense_launches = phase_dense_path()
    shard = phase_pulse_shard()
    print(json.dumps({"kernels": [
        kernel_entry("fused_chain_power_radix",
                     "wrp_tpu_torch/csrc/fused_chain_radix.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:809", host["radix"],
                     radix),
        kernel_entry("fused_chain_power_wire",
                     "wrp_tpu_torch/csrc/fused_chain_wire.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:1170", dev["wire"],
                     wire),
        kernel_entry("fused_chain_power_dense",
                     "wrp_tpu_torch/csrc/fused_chain_dense.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:194", dense_launches,
                     dense),
        kernel_entry("fused_chain_astage",
                     "wrp_tpu_torch/csrc/fused_chain_astage.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:955", shard["astage"],
                     astage),
        kernel_entry("parseval_rows_power",
                     "wrp_tpu_torch/csrc/parseval_rows.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:998", shard["rows"],
                     rows),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
