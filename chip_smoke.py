#!/usr/bin/env python3
"""Smoke test of the port on one CUDA GPU: builds the kernels, checks them,
and drives the stream paths end to end.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases (each prints its results; any failure raises and exits non-zero):

1. environment: torch/CUDA versions, the card's name and power limit;
   fails without CUDA;
2. build: compiles the native host library (wrp_tpu_torch/native: the
   codec and the UDP reassembly loop, g++) and wrp_tpu_torch/csrc (nvcc),
   at first use, and times both; then the benchmark's slice:
   a. the offset entries on two staged slabs (noise, clip-bin), at batch
      16 and at the bench's own shapes (batch 128: 384 channel-sectors from
      offset 384 of a 768-unit array, the wire's 128 sectors from offset
      128): radix (int16; f32 at batch 16) and wire with salts 0, 7, 95,
      dense at m = 1000 without: each slab bit-identical to the plain entry
      on a copy of it, salt 0 bit-identical to unsalted, salted vs the
      plain salted version <= 5e-7 rel-L2, the salt-7 zdb within the
      bench's 1e-3 gate of the unsalted zdb (salt 95's is printed), the
      wire words vs the radix entry on their planar samples, an offset past
      the array raises; CUDA-event times of the entry (salted), unsalted
      and plain;
   b. fused_stage2 (split-TF32 wgmma) on Y [48, 512, 512]: vs plain
      <= 1e-6 (and vs the torch emulation of its 3 x TF32 arithmetic,
      printed), identical for row_block 128/256/512, a bad row_block
      raises; on its path, the mxu method's range-stage Y of 16 noise
      sectors vs that method's own power (<= 1e-5) and the oracle, in one
      launch of the GEMM after one of the operator's real form; times
      of the kernel, plain and torch.matmul (complex64 Y @ B); the
      3 x TF32 floor beside the bound;
   c. `wrp_tpu_torch.bench.run` in process at the defaults: pallas int16,
      --in-dtype wire (fused and xla decode), m = 1000 (the dense offset
      entry, 8 repeats), and the mxu, parseval, fft and radix methods at 4
      repeats; each passes its parity gate with value > 0, and its offset
      counter equals its launches;
   d. the probes (the TPU tools' kernels), each through its entry point in
      wrp_tpu_torch/tools/: the breakdown's four modes (dots, splits,
      combine, full: the TPU algorithm on bf16 wgmma) at batch 16 on the
      noise and clip-bin slabs vs their plain versions (<= 1e-5), `full`
      vs the FFT-form salted radix offset entry and the fp64 oracle of the
      salted samples (<= 1e-5), the other geometries of its contract (m =
      512, n = 256, 128, 64) vs plain, then `kernel_breakdown.run` at 8 repeats
      (equal blocks per SM across modes and the A-stage at the breakdown
      body's shared memory; HGMMA in every mode's SASS, as many in each;
      no wgmma serialisation warning); the
      tensor-core probe (bf16 wgmma fed by TMA: its SASS holds HGMMA and
      no HMMA, ptxas serialises no wgmma) on identity operands (16 x 16 x
      8; M = 64 and 192 at widths 8, 136 and 256: exact), its persistent
      grid's units against the wrapper's plan, at widths 512, 1024, 2048
      vs plain (<= 1e-5), then `mxu_occupancy.run` at its defaults; the
      int16 -> bf16 split dot (its blocks: >= 64 at [128, 512]), both
      variants, on the 14-bit range (vs plain and vs fp32 A @ x <= 1e-6,
      split exact) and on every int16 value (vs plain, inexact samples
      printed), then `int_split_repro.run` for both; times of each
      kernel, its plain version and torch.matmul where one computes the
      function (the probe beside two yardsticks: a batched matmul per
      step and one [m, ndots k] GEMM per step; the split dot's and
      torch.matmul's also as device time per call, from a CUDA graph of
      100 calls replayed);
3. the radix kernel (the FFT form, csrc/fft_chain.cuh) vs its plain torch
   version at 3 x 1024 x 512, batch 16 (48 channel-sectors), int16 and f32
   input, on seeded noise and on an adversarial input whose Doppler energy
   sits in the clipped bins (rel-L2 <= 1e-6), and on a strong-DC sector (a
   clutter line near int16 full scale over noise of a few counts; <= 1e-5);
   power <= 1e-5 against the fp64 oracle, zdb/zdr <= 2e-4; the same at
   m = 960 = 64 x 15 (an L = 15 leaf); its blocks per SM, resident
   clusters and ptxas lines; CUDA-event timings of both;
4. the wire kernel on the same sectors' wire words, 3- and 2-channel: vs
   its plain version (<= 1e-6), vs the radix kernel on the host-decoded
   planar sectors, and vs the oracle, with the same bounds;
5. the dense entries (m does not split into radix branches), which pick
   their body from m alone: at 3 x 1000 x 512, batch 16, the FFT-form
   body (P = 8, a 5 x 5 x 5 leaf) vs its plain version (noise, clip-bin:
   rel-L2 <= 1e-6; strong-DC <= 1e-5) and the oracle (the strong-DC
   sector's power error against the oracle printed for the kernel and
   both plain versions), and at m = 40 (P = 8, L = 5) and m = 8; the
   matrix kernel at m = 4100 (> 4096) on noise and clip-bin vs its plain
   version (<= 1e-5) and the oracle, and its offset entry on two slabs;
   the body of every launch from the counters; times of the kernel, the
   FFT-form and the matrix-form plain versions;
6. the host-decode slice: a `cli produce` process (UdpProducer) ->
   UdpIngest (loopback; the native reassembly loop) -> StreamingExecutor
   (method="pallas", batch 16; the native codec decodes)
   -> UdpEgress + VolumeScan, one elevation cut of 143 sectors at
   21.45/s; requires 0 drops, full cut coverage, the radix kernel's launch
   count, and zdb/zdr of sampled sectors within 2e-4 of the oracle;
7. the device-decode slice: the same with device_decode=True (the wire
   kernel; the host only views the wire bytes);
   then the same cut over TCP (`cli produce --transport tcp` ->
   TcpIngest -> the executor, host decode, the radix kernel -> TcpEgress
   -> a TcpResultConsumer here, into a VolumeScan): 143/143, 0 drops,
   143 + 143 v2 frames, the radix kernel's launches, four received
   sectors within 2e-4 of the oracle; the same over ZMQ (the reference's
   2-part v2 wire, no labels) when pyzmq is installed (the run prints
   which); and `cli supervise --transport tcp` with two feeds on one
   host, device decode: sectors 0-71 of each feed from two paced `cli
   produce` processes, SIGTERM (exit 4, reason interrupted, both
   checkpoints on disk), the same command again, sectors 72-142 (exit 0,
   reason target, 143 a feed), two sectors a feed from the checkpoints vs
   the oracle, the wire kernel's launches from the worker's own stats in
   its log; the worker's start-up (launch to ready) printed;
8. capacity: the executor fed from memory, unpaced, host decode and
   device decode; beside it the native and numpy codecs' decode rates;
9. the dense path: the executor at m = 1000 from memory, device decode
   (a decode pass, then the dense entry) and host decode, every launch on
   the FFT-form body;
   then rays longer than 1024 cells (`phase_long_rays`): the ptxas lines of
   the long-ray and cluster kernels (and which of them spill); the executor
   at m = 2048 x 512, 3 channels, batch
   16, 32 sectors from memory with host decode (#3) and device decode
   (#7), every launch on the cluster body and none on the matrix kernel,
   sampled sectors within 2e-4 of the oracle; on the cluster body #3
   (int16, f32), #4 (offset, salt 7), #7, #8 (offset, salt 7) and #5
   (int16 and f32 at w = 512, int16 at 128) vs their plain versions at m
   = 1536, 1840, 2048, 4096, 4112, 4160, 8192 (<= 1e-5), with each
   geometry's cut and occupancy; CUDA-event times of each at those m per 48
   channel-sectors (6 at 4160, and at 4112 #3, #5, #7 only) beside its
   plain version and bound (#5 beside cuFFT); #1 and #2 at the radix-1 m =
   1832, 1836, 2002 (8 x 229: a Bluestein leaf, 4 x 459, 2 x 1001) on the
   cluster body vs plain and the oracle, every launch counted there, #1 at
   1832 timed beside the matrix kernel and its bound, and #1 at m = 4094
   on the long-ray body; `bench --range-cells 2048` at batch 32,
   int16 (#4) and wire (#8), its gate passing; a world-size-1 pallas-seq
   step (#5, #6) and the mxu method (#9) at m = 2048 vs the pallas
   processor and the oracle, and the pallas-seq step at m = 4160 (the
   cluster A-stage) from host planar int16 and from wire bytes; the
   cluster of 16 (8192 < m <= 16384) at m = 8320, 16384 and, at P = 1
   (m = 16 x odd: each block's sub-DFT the odd leaf alone), 8208, 8240
   and 16368: the ptxas lines of its kernels (no spill; the three P = 1
   kernels built) and the clusters of 16 the card holds, at 8320, 16384
   and 8208 the slice's main path (the pallas processor, #3; the fused
   wire processor, #7; at 8320 `bench --range-cells 8320` at batch 2,
   int16, #4, and wire, #8; a world-size-1 pallas-seq step, #5 then #6) on
   two noise sectors, every launch on the cluster body, the products
   within 2e-4 of the oracle; at every one of those m #3 (int16, f32), #4
   (offset, salt 7), #7, #8 (offset 1, salt 7) and #5 (int16 and f32 at w
   = 512, int16 at 128) vs their plain versions (<= 1e-5) and the oracle,
   every launch on the cluster body; at 8320, 16384, 8208 and 16368 each
   timed on 6 channel-sectors in turns with its plain version beside its
   bound (#5 beside cuFFT); m = 8336 (16 x 521, radix 2, which the
   cluster body refuses: a Bluestein length of 2048) through the matrix
   routes of the radix entry and the wire entry (the matrix kernel's wire
   source), each with and without offset and salt, and of #5
   (csrc/fused_chain_astage_matrix.cu, then #6 on its Y), one checking
   call each vs its plain version and the oracle, not timed, every launch
   counted;
10. the A-stage kernel (the pulse-sharded path's first half) on the noise
   and clip-bin sectors, int16 and f32, on every rank's pulse slab of 1, 2
   and 4 ranks (w = 512, 256, 128): Y vs its plain version (rel-L2 <=
   1e-6); CUDA-event times of the kernel, the plain version, the library
   call (cuFFT: torch.fft.fft over range of the windowed complex64 input,
   then the crop) and torch.matmul(A_half, X) in complex64;
11. the row-epilogue kernel on every row shard of that Y (rows = 512, 256,
   128) in its register form, on the noise, clip-bin and strong-DC
   sectors, and in its two-pass form at n = 514 and 2048 and on a Y off
   16 bytes: power vs its plain version (<= 1e-5), each in the form
   `parseval_rows_form` names; its ptxas lines, blocks per SM, the C
   entry's rule against the wrapper's at 14 pulse counts, and its times
   (one call, and queued) beside the bound and the earlier two-pass
   kernel's figure;
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
   the warmup step), sampled products within 2e-4 of the oracle; then, in
   the same group, the halo step (parallel/halo.py) on 4 noise sectors vs
   the fused radix chain (<= 1e-4) and the oracle (<= 2e-4);
14. (after the bench of 2c) `bench --sharded N`, N = min(GPU count, 4)
   (`--sharded 1` on a one-card machine, which it says): N ranks, rank k
   on cuda:k over NCCL, each running the salted offset loop on its B/N
   sectors, with `--profile DIR`; the sharded gate (data-parallel pallas
   < 1e-4, mxu and halo < 1e-3 against the unsharded processor) and each
   rank's salted harness on its own share, every rank's offset launches
   (the profiled pass's included), its value beside N x the unsharded
   value; one trace a rank (DIR/rank{r}/trace.json) holding `steps`
   offset-entry kernel events, all on cuda:r, trace_summary over DIR
   reporting N processes, and each rank's busy share in its profiled pass
   printed; then `python -m wrp_tpu_torch.parallel.dryrun N` on the GPUs
   (its checks and OK line);
15. with N >= 2 cards: the halo and mxu pulse-sharded steps across N
   ranks (tools/pulse_shard_ranks.py --method halo,mxu), each rank's
   products vs the fused chain (<= 1e-4) and the oracle, step ms;
16. the rest of the CLI and the tools that read or check it: `cli process
   --method pallas --timings --output` (six stage lines, one radix
   launch) and `cli compare` of its output against the fp64 oracle's
   products (pass at 1e-4); `cli stream --trace` in its own process, one
   paced cut over UDP loopback, host decode (143/143, 0 drops, sampled
   sectors vs the oracle), then `tools/trace_summary.run --overlap` on its
   trace: one fft_chain_kernel event per radix launch the worker counted,
   the executor's stage spans from the ingest and compute threads, the
   overlap (`of_stage`) of `ingest/decode` and `compute/h2d_enqueue` with
   the in-flight window and the device's busy share, over the traced
   window and over the cut's traffic; `cli volume --render --export-ascii`
   on that stream's checkpoint (a 256 x 256 PPM, 143 files);
   `tools/hw_parity.run` (every method and path vs the oracle, each row's
   kernels launched); `tools/wire_ab.run` and `tools/decode_ab.run` at
   production geometry, batch 32 (parity pinned, us per sector).
17. the last three tools: `tools/ab_sweep.run` in process at the bench's
   shapes (batch 128, 2 slabs, 16 repeats): i16 (#4), f32 (#4 on an f32
   copy made on the card), wire (#8 on words encoded on the card) and
   wire_xla (the torch decode, then #4), each passing the bench's gate
   with its offset launches, the i16 row within 0.8-1.25 x the bench's
   pallas int16 value of this run; `tools/multihost_bench --method
   pallas --m 1024 --n 512 --per-host-batch 16 --hosts min(GPU count, 4)`
   in its own process (exit 0, its line, #3 once a timed step on every
   rank); `tools/consolidation_soak` three times in its own process: 4
   feeds (1 UDP, 3 ZMQ) at 21.45 sectors/s, host decode, 8 s; the same
   with --device-decode, 6 s; --stub-device with 8 feeds, 6 s: every
   sector of every feed processed, 0 drops, 0 contamination failures, the
   path's kernel launched, per-feed p50/p99 and the executor's core share
   printed;
18. the hardware demo, `python -m wrp_tpu_torch.tools.hw_demo 143`, with
   host decode and with --device-decode, each in its own process and both
   at once: `cli stream`, `cli consume --volume`, `cli produce --headers`
   (unpaced) and `cli volume` over UDP loopback; MATCH (the consumer's
   volume equals the processor's) and exit 0, 143/143 sectors, and the
   radix kernel (#3; the wire kernel, #7, with --device-decode) launched,
   from the stream's own stats (OUT/stream_stats.json).

Every launch counter is set to 0 just before each path runs and read just
after (a supervised worker or a bench rank, another process, reports its
own).  Prints a JSON line of per-kernel results (launches, errors, ms,
plain ms, bound ms), then as its last line {"ok": true, "device": {...}}.
A bound is the least work of the function (the range DFT as an FFT, or
the bytes moved); where a kernel runs a matrix form (the dense entries'
matrix kernel, fused_stage2's GEMM, the breakdown) its work is printed
beside the bound.
Imports torch, numpy and wrp_tpu_torch only.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from wrp_tpu_torch import bench, oracle  # noqa: E402
from wrp_tpu_torch.config import DEFAULT_CONFIG, tiny_config  # noqa: E402
from wrp_tpu_torch.constants import PipelineConstants, hamming_factors  # noqa: E402
from wrp_tpu_torch.io import codec, frames  # noqa: E402
from wrp_tpu_torch.io.udp import UdpEgress, UdpIngest  # noqa: E402
from wrp_tpu_torch.native import build as native_build  # noqa: E402
from wrp_tpu_torch.native import codec_native  # noqa: E402
from wrp_tpu_torch.ops import (  # noqa: E402
    _build, device_codec, fullchain, postprocess, probes)
from wrp_tpu_torch.parallel import (  # noqa: E402
    build_halo_processor, build_sharded_processor, make_mesh, shard_batch)
from wrp_tpu_torch.parallel.launch import leave_group  # noqa: E402
from wrp_tpu_torch.parallel.multihost import (  # noqa: E402
    PulseShardedProcessor, init_distributed)
from wrp_tpu_torch.parallel.sharded import join_pulses, split_rows  # noqa: E402
from wrp_tpu_torch.pipeline import (  # noqa: E402
    SectorProcessor, _DeviceConstants, _rmatmul, channel_power_planar,
    stage09_10_products)
from wrp_tpu_torch.runtime import StreamingExecutor, VolumeScan  # noqa: E402
from wrp_tpu_torch.tools import (  # noqa: E402
    int_split_repro, kernel_ab, kernel_breakdown, mxu_occupancy)

BATCH = 16
BENCH_BATCH = 128         # the bench's default batch (sectors per step)
SECTORS = 143             # one elevation cut of DEFAULT_CONFIG
RATE = 21.45              # sectors/s: a real radar's cut rate
POWER_TOL = 1e-5
PRODUCT_TOL = 2e-4
KERNEL_TOL = 1e-6         # an FFT-form kernel vs its plain version (noise, clip-bin)
SALTED_TOL = 1e-6         # a salted FFT-form kernel vs its plain salted version
STAGE2_TOL = 1e-6         # fused_stage2 vs its plain version (fp32 GEMM orders)
BENCH_GATE = (1e-4, 1e-3)  # the bench's parity gate: salt 0, salted
BENCH_SALTS = (7, 95)     # the bench gate's salt; the largest a default run uses
SEED = 2024
DENSE_M = 1000            # radix_for(1000) == 1: the dense entries' geometry (FFT body)
MATRIX_M = 4100           # radix 1 above FFT_MAX_M: the dense entries' matrix kernel
LEAF_M = 960              # 64 x 15: the FFT-form kernels' L = 15 leaf
SHARDS = (1, 2, 4)        # ranks of the pulse-sharded path

PROBE_TOL = 1e-5          # an ablation or the tensor-core probe vs its plain version
SPLIT_TOL = 1e-6          # the split dot vs its plain version and vs fp32 A @ x
PROBE_STEPS = 32          # tensor-core probe steps checked against the plain version
BREAKDOWN_REPEATS = 8     # kernel_breakdown.run's repeats here (its default: 128)
#: (m, n) of the breakdown kernel's contract checked beside 1024 x 512
BREAKDOWN_GEOMETRIES = ((512, 512), (1024, 256), (1024, 64), (512, 128),
                        (1024, 192), (512, 384), (1024, 320), (1024, 448))

# H100 SXM peaks for the bound (NVIDIA data sheet, 700 W): fp32 on the CUDA
# cores, dense bf16 and TF32 on the tensor cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989.4e12
PEAK_TF32 = 494.7e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32):
    """(ms, "operations" | "bytes"): the least time the card could take,
    `flops` at `peak` FLOP/s or `nbytes` at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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
    """The work of the algorithm a kernel runs, beside the bound, never as
    it: m <= 1024 and the dense entries' m = 2 x odd in (2048, 4096] run
    the FFT form (csrc/fft_chain.cuh: radix-2 register DFTs and the leaf's
    radix-5/3/7 passes, the bound's flops up to the butterflies' constant),
    every other m up to 16384 the cluster body takes the cluster body's
    (`cluster_note`); the dense matrix kernel (odd m, the m the cluster
    body refuses) the TPU's A_half contraction (8 flops per complex
    multiply-add)."""
    R = fullchain.radix_for(m)
    tpu = bc * 8.0 * (m * (m // R) * w if R > 1 else (m // 2) * m * w)
    form = f"radix-{R} matrix form" if R > 1 else "dense A_half form"
    if fullchain.fft_takes(m):
        g = fullchain.fft_geometry(m, w)
        passes, rem = [], g.L
        while rem > 1:
            passes.append(fullchain.leaf_radix(rem))
            rem //= passes[-1]
        leaf = (f", leaf passes {' x '.join(map(str, passes))}" if passes
                else "")
        body = "long-ray" if fullchain.fft_long(m) else "register"
        return (f"the kernel runs the FFT form (the {body} body; P = {g.P} = "
                f"{g.P1} x {g.P2}, L = {g.L}{leaf}; {g.cols} columns a round, "
                f"{g.blocks} blocks a unit); the TPU's {form} would do "
                f"{tpu / 1e9:.1f} GFLOP")
    if fullchain.cluster_takes(m):
        return (f"the kernel runs {cluster_note(m, w)}; the TPU's {form} "
                f"would do {tpu / 1e9:.1f} GFLOP")
    return (f"the kernel's dense contraction does {tpu / 1e9:.1f} GFLOP, "
            f"{1e3 * tpu / PEAK_FP32:.3f} ms at the fp32 peak")


def reset_counts() -> None:
    fullchain.LAUNCHES = fullchain.WIRE_LAUNCHES = fullchain.DENSE_LAUNCHES = 0
    fullchain.ASTAGE_LAUNCHES = fullchain.PARSEVAL_ROWS_LAUNCHES = 0
    fullchain.ASTAGE_MATRIX_LAUNCHES = fullchain.ASTAGE_CLUSTER_LAUNCHES = 0
    fullchain.WIRE_CLUSTER_LAUNCHES = fullchain.RADIX_CLUSTER_LAUNCHES = 0
    fullchain.RADIX_OFFSET_LAUNCHES = fullchain.WIRE_OFFSET_LAUNCHES = 0
    fullchain.DENSE_OFFSET_LAUNCHES = postprocess.STAGE2_LAUNCHES = 0
    postprocess.STAGE2_OPERATOR_LAUNCHES = 0
    fullchain.DENSE_FFT_LAUNCHES = fullchain.DENSE_MATRIX_LAUNCHES = 0
    fullchain.DENSE_CLUSTER_LAUNCHES = 0
    probes.BREAKDOWN_LAUNCHES = probes.TC_PROBE_LAUNCHES = 0
    probes.INT_SPLIT_LAUNCHES = fullchain.PARSEVAL_ROWS_TWO_PASS_LAUNCHES = 0


def read_counts() -> dict:
    return {"radix": fullchain.LAUNCHES, "wire": fullchain.WIRE_LAUNCHES,
            "dense": fullchain.DENSE_LAUNCHES,
            "astage": fullchain.ASTAGE_LAUNCHES,
            "astage_matrix": fullchain.ASTAGE_MATRIX_LAUNCHES,
            "astage_cluster": fullchain.ASTAGE_CLUSTER_LAUNCHES,
            "wire_cluster": fullchain.WIRE_CLUSTER_LAUNCHES,
            "radix_cluster": fullchain.RADIX_CLUSTER_LAUNCHES,
            "rows": fullchain.PARSEVAL_ROWS_LAUNCHES,
            "rows_two_pass": fullchain.PARSEVAL_ROWS_TWO_PASS_LAUNCHES,
            "radix_offset": fullchain.RADIX_OFFSET_LAUNCHES,
            "wire_offset": fullchain.WIRE_OFFSET_LAUNCHES,
            "dense_offset": fullchain.DENSE_OFFSET_LAUNCHES,
            "dense_fft": fullchain.DENSE_FFT_LAUNCHES,
            "dense_cluster": fullchain.DENSE_CLUSTER_LAUNCHES,
            "dense_matrix": fullchain.DENSE_MATRIX_LAUNCHES,
            "stage2": postprocess.STAGE2_LAUNCHES,
            "stage2_operator": postprocess.STAGE2_OPERATOR_LAUNCHES,
            "breakdown": probes.BREAKDOWN_LAUNCHES,
            "tc_probe": probes.TC_PROBE_LAUNCHES,
            "int_split": probes.INT_SPLIT_LAUNCHES}


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
    native_build.load_library()
    print(f"native build (g++: codec.cpp, ingest.cpp): "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{native_build.library_path().name}", flush=True)
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


def queued_ms(fn, reps: int = 20) -> float:
    """ms per call of `reps` calls queued back to back between two CUDA
    events: the card's time, the host's work for each call hidden under
    the calls before it (cuda_ms times one call, and so also the host work
    that outlasts an empty queue)."""
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


def host_ms(fn, reps: int = 20) -> float:
    """ms of host work per call of `fn` (its Python and launch), not
    waiting for the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


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


def timed(fns: dict, order, clock=cuda_ms) -> dict:
    """CUDA-event ms of each named fn, run in `order` (e.g. plain, kernel,
    kernel, plain) and timed by `clock` (cuda_ms: one call between two
    events; queued_ms: calls queued back to back); the best of each name's
    turns."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(clock(fns[name]))
    how = ("median of 10 per turn" if clock is cuda_ms
           else "20 calls queued per turn")
    print(f"timings ({how}, order " + "/".join(order) + "): "
          + json.dumps(times), flush=True)
    return {name: min(v) for name, v in times.items()}


class Oracle:
    """fp64 oracle power of each input sector, computed once (or in a
    thread, where `prefetch` queued it)."""

    def __init__(self):
        self._pow = {}

    def prefetch(self, key, future) -> None:
        """Take key's power from `future`, a thread's: numpy's FFTs and
        ufuncs release the GIL, so the oracle runs beside the card's work."""
        self._pow.setdefault(key, future)

    def power(self, key, iq, cfg) -> np.ndarray:
        if key not in self._pow:
            self._pow[key] = oracle.channel_power(iq, cfg)
        if not isinstance(self._pow[key], np.ndarray):
            self._pow[key] = self._pow[key].result()
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


def planar_kernel_checks(name, kernel, plain, plan, cfg, inputs, orc, gain,
                         tols=None):
    """A planar kernel (radix or dense) vs its plain version and the oracle,
    int16 and f32 input; `tols` maps an input's label to its kernel-vs-
    plain bound (default POWER_TOL).  Returns (worst rel-L2, max abs
    error) vs plain."""
    worst_rel = max_abs = 0.0
    for label, (x_np, oracle_sectors) in inputs.items():
        tol = (tols or {}).get(label, POWER_TOL)
        x16 = torch.from_numpy(x_np).cuda().reshape(-1, 2, cfg.m, cfg.n)
        for x in (x16, x16.float()):
            got = kernel(x, plan)
            torch.cuda.synchronize()
            ref = plain(x, plan)
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            e = rel(r, g)
            worst_rel = max(worst_rel, e)
            max_abs = max(max_abs, float(np.max(np.abs(g - r))))
            check(e <= tol, f"{name} {label} {x.dtype}: kernel vs plain "
                            f"power rel-L2 {e:.3e} <= {tol}")
            for s, iq in enumerate(oracle_sectors):
                pk = g.reshape(-1, cfg.num_channels, cfg.m // 2)[s]
                check_vs_oracle(f"{name} {label} {x.dtype} sector {s}", pk,
                                orc.power((cfg.m, cfg.n, label, s), iq, cfg), cfg,
                                gain)
    return worst_rel, max_abs


def strong_dc_sector(cfg, seed: int = 5, amp: float = 3.0e4,
                     noise: int = 8) -> np.ndarray:
    """A zero-Doppler clutter line near int16 full scale (3e4 counts at its
    peak) at range bin m/8, shaped by 1/w_d so that q = Y w_d is nearly
    constant along the pulses, over uniform noise of a few counts: the
    epilogue's mean must come off exactly (tests/test_torch_fft_chain.py
    holds the one-pass form failing on it)."""
    m, n = cfg.m, cfg.n
    _, wd, _ = hamming_factors(cfg)
    rng = np.random.default_rng(seed)
    r = np.arange(m)[:, None]
    ph = rng.uniform(0, 2 * np.pi, (cfg.num_channels, 1, 1))
    line = amp * (wd.min() / wd)[None, :]
    shape = (cfg.num_channels, m, n)
    return (np.round(line * np.cos(2 * np.pi * r / 8 + ph))
            + rng.integers(-noise, noise + 1, shape)
            + 1j * (np.round(line * np.sin(2 * np.pi * r / 8 + ph))
                    + rng.integers(-noise, noise + 1, shape)))


def phase_fft_build() -> dict:
    """The FFT-form kernels' ptxas lines and occupancy at the production
    geometry: blocks per SM (radix, wire, A-stage) and the clusters of 8
    blocks the card holds at once (cudaOccupancyMaxActiveClusters)."""
    print_ptxas(r"fft_chain_kernel")
    plan = fullchain.build_plan(PipelineConstants.build(DEFAULT_CONFIG), "cuda")
    occ = {body: fullchain.fft_occupancy(plan, body)
           for body in ("radix", "wire", "astage")}
    dplan = fullchain.build_plan(PipelineConstants.build(dataclasses.replace(
        DEFAULT_CONFIG, num_range_cells=DENSE_M)), "cuda")
    occ["dense"] = fullchain.fft_occupancy(dplan, "radix")
    print(f"FFT-form kernels at {DEFAULT_CONFIG.m} x {DEFAULT_CONFIG.n}: "
          f"{plan.fft}; at m = {DENSE_M} (the dense entries): {dplan.fft}; "
          f"occupancy {json.dumps(occ)}", flush=True)
    check(all(v["blocks_per_sm"] >= 2 for v in occ.values())
          and occ["radix"]["clusters"] > 0 and occ["wire"]["clusters"] > 0
          and occ["dense"]["clusters"] > 0,
          f"FFT-form kernels resident at >= 2 blocks per SM, clusters of "
          f"{plan.fft.blocks}: {occ['radix']['clusters']} (radix), "
          f"{occ['wire']['clusters']} (wire), {occ['dense']['clusters']} "
          f"(dense, m = {DENSE_M})")
    return occ


def phase_kernel(orc: Oracle, noise, adv) -> dict:
    cfg = DEFAULT_CONFIG
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")
    check(plan.radix == 8 and plan.fft.P == cfg.m,
          f"production geometry takes radix 8 and the FFT form {plan.fft}")
    gain = torch.from_numpy(consts.gain).cuda()
    dc = strong_dc_sector(cfg)
    inputs = {"noise": (np.stack([planar_i16(s) for s in noise]), noise[:3]),
              "clip-bin": (np.stack([planar_i16(adv)] * BATCH), [adv]),
              "strong-dc": (np.stack([planar_i16(dc)] * BATCH), [dc])}
    worst_rel, max_abs = planar_kernel_checks(
        "radix", fullchain.fused_chain_power_radix,
        fullchain.fft_chain_power_reference, plan, cfg, inputs, orc, gain,
        {"noise": KERNEL_TOL, "clip-bin": KERNEL_TOL})

    # an L > 1 geometry (m = 960 = 64 x 15), then R = 4 and R = 2 (tiny)
    lcfg = dataclasses.replace(cfg, num_range_cells=LEAF_M)
    lconsts = PipelineConstants.build(lcfg)
    lplan = fullchain.build_plan(lconsts, "cuda")
    lsec = [oracle.synthetic_iq(lcfg, kind="noise", seed=SEED + b)
            for b in range(4)]
    ladv = adversarial_sector(lcfg)
    check(lplan.fft.L == 15, f"m={LEAF_M}: {lplan.fft}")
    e, a = planar_kernel_checks(
        f"radix m={LEAF_M}", fullchain.fused_chain_power_radix,
        fullchain.fft_chain_power_reference, lplan, lcfg,
        {"noise": (np.stack([planar_i16(s) for s in lsec]), lsec[:2]),
         "clip-bin": (np.stack([planar_i16(ladv)] * 4), [ladv])},
        orc, torch.from_numpy(lconsts.gain).cuda(),
        {"noise": KERNEL_TOL, "clip-bin": KERNEL_TOL})
    worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)
    for m, n in ((32, 64), (16, 64)):
        tcfg = tiny_config(m=m, n=n)
        tplan = fullchain.build_plan(PipelineConstants.build(tcfg), "cuda")
        rng = np.random.default_rng(m)
        x = torch.from_numpy(rng.integers(-8192, 8192, (9, 2, m, n))
                             .astype(np.int16)).cuda()
        g = fullchain.fused_chain_power_radix(x, tplan).cpu().numpy()
        r = fullchain.fft_chain_power_reference(x, tplan).cpu().numpy()
        check(rel(r, g) <= KERNEL_TOL,
              f"m={m} n={n} ({tplan.fft}): kernel vs plain rel-L2 "
              f"{rel(r, g):.3e} <= {KERNEL_TOL}")

    x16 = torch.from_numpy(inputs["noise"][0]).cuda().reshape(-1, 2, cfg.m,
                                                               cfg.n)
    t = timed({"plain": lambda: fullchain.fft_chain_power_reference(x16, plan),
               "kernel": lambda: fullchain.fused_chain_power_radix(x16, plan)},
              ("plain", "kernel", "kernel", "plain"))
    bc = x16.shape[0]
    bound_ms, bound_by = bound(
        bc * chain_flops(cfg.m, cfg.n),
        x16.numel() * 2 + plan.fft_t.numel() * 4 + bc * cfg.m // 2 * 4)
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
        plan = fullchain.build_plan(consts, "cuda")
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
            check(e <= KERNEL_TOL and er <= KERNEL_TOL,
                  f"wire {ch}ch {label}: kernel vs plain {e:.3e}, vs radix "
                  f"kernel on host-decoded sectors {er:.3e} (<= {KERNEL_TOL})")
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
                w32.numel() * 4 + plan.fft_t.numel() * 4
                + BATCH * ch * cfg.m // 2 * 4)
            print(f"wire kernel, {BATCH} sectors x {ch} x {cfg.m} x {cfg.n} "
                  f"words: {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
                  f"bound {bound_ms:.3f} ms ({bound_by}); "
                  f"{algorithm_note(cfg.m, cfg.n, BATCH * ch)}", flush=True)
            out = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "bound_ms": bound_ms, "bound_by": bound_by}
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, **out}


def dense_plain(x: torch.Tensor, plan) -> torch.Tensor:
    """The plain version of the route the dense entries take at plan.m."""
    return {"register": fullchain.fft_chain_power_reference,
            "long": fullchain.fft_chain_power_reference,
            "cluster": fullchain.cluster_chain_power_reference,
            "matrix": fullchain.fused_chain_power_reference}[
                fullchain.chain_route(plan.m)](x, plan)


def phase_kernel_dense(orc: Oracle) -> dict:
    """The dense entries, whose body m alone picks: the FFT-form body at
    m = 1000 (batch 16 x 3 channels) vs its plain version (noise, clip-bin
    <= KERNEL_TOL; strong-DC <= POWER_TOL, as the radix kernel's) and the
    oracle, and at m = 40 (P = 8, L = 5) and m = 8; the matrix kernel at
    m = 4100 vs its plain version (<= POWER_TOL) and the oracle.  The
    counters show each launch's body."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=DENSE_M)
    consts = PipelineConstants.build(cfg)
    plan = fullchain.build_plan(consts, "cuda")
    g = plan.fft
    check(plan.radix == 1 and fullchain.chain_route(DENSE_M) == "register"
          and (g.P, g.L, g.cols) == (8, 125, 4),
          f"m={DENSE_M} takes the dense entries' FFT-form body (radix "
          f"{plan.radix}): {g}")
    gain = torch.from_numpy(consts.gain).cuda()
    noise = [oracle.synthetic_iq(cfg, kind="noise", seed=SEED + b)
             for b in range(BATCH)]
    adv = adversarial_sector(cfg)
    dc = strong_dc_sector(cfg)
    inputs = {"noise": (np.stack([planar_i16(s) for s in noise]), noise[:3]),
              "clip-bin": (np.stack([planar_i16(adv)] * BATCH), [adv]),
              "strong-dc": (np.stack([planar_i16(dc)] * BATCH), [dc])}
    reset_counts()
    # strong-DC: POWER_TOL, as the radix kernel's (q = Y w_d rounds in
    # float32 near 3e4 counts, in another order in the plain version)
    worst_rel, max_abs = planar_kernel_checks(
        f"dense m={DENSE_M} (FFT body)", fullchain.fused_chain_power_dense,
        dense_plain, plan, cfg, inputs, orc, gain,
        {"noise": KERNEL_TOL, "clip-bin": KERNEL_TOL})
    counts = read_counts()
    check(counts["dense"] == counts["dense_fft"] == 2 * len(inputs)
          and counts["dense_matrix"] == 0,
          f"dense m={DENSE_M}: every launch on the FFT-form body (dense "
          f"{counts['dense']}, FFT body {counts['dense_fft']}, matrix "
          f"{counts['dense_matrix']})")
    # which of kernel and plain lies further from fp64 on the strong-DC
    # sector, where the kernel is held to its plain version at POWER_TOL
    xdc = torch.from_numpy(inputs["strong-dc"][0]).cuda().reshape(
        -1, 2, cfg.m, cfg.n)
    pow64 = orc.power((cfg.m, cfg.n, "strong-dc", 0), dc, cfg)
    errs = {}
    for what, fn in (("kernel", fullchain.fused_chain_power_dense),
                     ("FFT-form plain", fullchain.fft_chain_power_reference),
                     ("matrix-form plain",
                      fullchain.fused_chain_power_reference)):
        pk = fn(xdc, plan).cpu().numpy().reshape(-1, cfg.num_channels,
                                                 cfg.m // 2)[0]
        errs[what] = max(rel(pow64[c], pk[c])
                         for c in range(cfg.num_channels))
    print(f"dense m={DENSE_M} strong-DC sector, int16, power vs the fp64 "
          "oracle: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; further from fp64 than the kernel: "
          f"{[k for k, v in errs.items() if v > errs['kernel']]}", flush=True)
    for m, n in ((40, 32), (8, 16)):
        tcfg = tiny_config(m=m, n=n)
        tconsts = PipelineConstants.build(tcfg)
        tplan = fullchain.build_plan(tconsts, "cuda")
        sectors = [oracle.synthetic_iq(tcfg, kind="noise", seed=m + k)
                   for k in range(3)]
        tin = {"tiny noise": (np.stack([planar_i16(s) for s in sectors]),
                              sectors)}
        reset_counts()
        e, a = planar_kernel_checks(
            f"dense m={m} n={n} ({fullchain.chain_route(m)} body, {tplan.fft})",
            fullchain.fused_chain_power_dense, dense_plain, tplan, tcfg, tin,
            orc, torch.from_numpy(tconsts.gain).cuda(),
            {"tiny noise": KERNEL_TOL})
        counts = read_counts()
        check(counts["dense_fft"] == 2 and counts["dense_matrix"] == 0,
              f"dense m={m}: launches on the FFT-form body {counts['dense_fft']}"
              f", matrix {counts['dense_matrix']}")
        worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)

    # m > 4096: the matrix kernel, the TPU kernel's own algorithm
    mcfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=MATRIX_M)
    mconsts = PipelineConstants.build(mcfg)
    mplan = fullchain.build_plan(mconsts, "cuda")
    check(mplan.radix == 1 and fullchain.chain_route(MATRIX_M) == "matrix"
          and mplan.fft_t is None,
          f"m={MATRIX_M} takes the matrix kernel (tile "
          f"{fullchain.dense_tile(mplan)})")
    msec = [oracle.synthetic_iq(mcfg, kind="noise", seed=SEED + b)
            for b in range(2)]
    madv = adversarial_sector(mcfg)
    mgain = torch.from_numpy(mconsts.gain).cuda()
    minputs = {"noise": (np.stack([planar_i16(s) for s in msec]), msec),
               "clip-bin": (np.stack([planar_i16(madv)] * 2), [madv])}
    reset_counts()
    e, a = planar_kernel_checks(
        f"dense m={MATRIX_M} (matrix kernel)", fullchain.fused_chain_power_dense,
        dense_plain, mplan, mcfg, minputs, orc, mgain)
    counts = read_counts()
    check(counts["dense_matrix"] == 2 * len(minputs)
          and counts["dense_fft"] == 0,
          f"dense m={MATRIX_M}: launches on the matrix kernel "
          f"{counts['dense_matrix']}, FFT body {counts['dense_fft']}")
    worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)
    # the offset entry on the matrix kernel: two slabs (noise, clip-bin)
    mall = torch.from_numpy(np.concatenate(
        [v[0] for v in minputs.values()])).cuda().reshape(-1, 2, MATRIX_M,
                                                          mcfg.n)
    mbc = 2 * mcfg.num_channels

    def mzdb(pw):
        pw = pw.reshape(2, mcfg.num_channels, -1)
        return stage09_10_products(pw[:, 0], pw[:, 1], mgain)[0].cpu().numpy()

    reset_counts()
    offset_entry_checks(
        f"dense offset entry m={MATRIX_M} (matrix kernel)", mall.shape[0], mbc,
        lambda off, salt: fullchain.fused_chain_power_at(mall, off, mbc, mplan),
        lambda off: fullchain.fused_chain_power_dense(
            mall[off:off + mbc].contiguous(), mplan),
        lambda off, salt: dense_plain(mall[off:off + mbc], mplan),
        mzdb, (), POWER_TOL)
    counts = read_counts()
    check(counts["dense_offset"] > 0 and counts["dense_fft"] == 0
          and counts["dense_matrix"] == counts["dense"]
          + counts["dense_offset"],
          f"dense offset entry m={MATRIX_M}: {counts['dense_offset']} "
          f"launches, all on the matrix kernel ({counts['dense_matrix']} "
          f"matrix, {counts['dense_fft']} FFT body)")

    x16 = torch.from_numpy(inputs["noise"][0]).cuda().reshape(-1, 2, cfg.m,
                                                               cfg.n)
    t = timed({"plain": lambda: fullchain.fft_chain_power_reference(x16, plan),
               "kernel": lambda: fullchain.fused_chain_power_dense(x16, plan),
               "matrix_plain": lambda: fullchain.fused_chain_power_reference(
                   x16, plan)},
              ("plain", "matrix_plain", "kernel", "kernel", "matrix_plain",
               "plain"))
    bc = x16.shape[0]
    bound_ms, bound_by = bound(
        bc * chain_flops(cfg.m, cfg.n),
        x16.numel() * 2 + plan.fft_t.numel() * 4 + bc * cfg.m // 2 * 4)
    print(f"dense entry (FFT body), batch {BATCH} x {cfg.num_channels} x "
          f"{cfg.m} x {cfg.n} int16: {t['kernel']:.3f} ms, plain (FFT form) "
          f"{t['plain']:.3f} ms, plain (matrix form: cuBLAS and the epilogue) "
          f"{t['matrix_plain']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
          f"{algorithm_note(cfg.m, cfg.n, bc)}", flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, "ms": t["kernel"],
            "plain_ms": t["plain"], "matrix_plain_ms": t["matrix_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def seq_inputs(noise, adv) -> dict:
    """The phase-3 sectors as [48, 2, m, n] int16 on the card."""
    cfg = DEFAULT_CONFIG
    return {label: torch.from_numpy(np.stack([planar_i16(s) for s in secs]))
            .cuda().reshape(-1, 2, cfg.m, cfg.n)
            for label, secs in (("noise", noise), ("clip-bin", [adv] * BATCH))}


def phase_kernel_astage(noise, adv) -> dict:
    """The A-stage kernel on every rank's pulse slab of 1, 2 and 4 ranks,
    vs its plain version; times of the kernel, plain, the library call
    (cuFFT: torch.fft.fft over range of the windowed complex64 input, then
    the crop) and torch.matmul(A_half, X); the fused radix kernel timed in
    the same call."""
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
                check(e <= KERNEL_TOL,
                      f"astage {label} {x.dtype} w={w} ({shards} slabs): "
                      f"kernel vs plain Y rel-L2 {e:.3e} <= {KERNEL_TOL} "
                      f"(max abs {a:.3e})")

    consts = PipelineConstants.build(cfg)
    a_c = torch.complex(*(torch.from_numpy(np.ascontiguousarray(v)).float()
                          for v in (consts.op_a_half.real,
                                    consts.op_a_half.imag))).cuda()
    win = plan.fft_t[:cfg.m]
    x16 = inputs["noise"]
    bc = x16.shape[0]
    out = {}
    for shards in SHARDS:
        w = cfg.n // shards
        slab = x16[..., :w].contiguous()
        xc = torch.complex(slab[:, 0].float(), slab[:, 1].float())
        xw = (xc * win[:, None]).contiguous()     # pre-windowed, as cuFFT's input
        y_fft = torch.fft.fft(xw, dim=1)[:, :cfg.m // 2]
        e_fft, _ = rel_dev(torch.view_as_complex(
            fullchain.fused_chain_astage(slab, plan).permute(0, 2, 3, 1)
            .contiguous()), y_fft)
        t = timed({
            "plain": lambda: fullchain.fused_chain_astage_reference(slab, plan),
            "kernel": lambda: fullchain.fused_chain_astage(slab, plan),
            "library": lambda: torch.fft.fft(xw, dim=1)[:, :cfg.m // 2],
            "matmul": lambda: torch.matmul(a_c, xc)},
            ("plain", "kernel", "library", "matmul", "matmul", "library",
             "kernel", "plain"))
        bound_ms, bound_by = bound(
            bc * astage_flops(cfg.m, w),
            slab.numel() * 2 + plan.fft_t.numel() * 4
            + bc * 2 * (cfg.m // 2) * w * 4)
        print(f"astage kernel, {bc} channel-sectors x {cfg.m} x w={w} "
              f"int16: {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
              f"library (cuFFT over range of the windowed complex64 input, "
              f"then the crop) {t['library']:.3f} ms (kernel vs it rel-L2 "
              f"{e_fft:.3e}), torch.matmul complex64 A_half @ X "
              f"{t['matmul']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
              f"{algorithm_note(cfg.m, w, bc)}", flush=True)
        if shards == 1:
            out = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t["library"], "matmul_ms": t["matmul"],
                   "bound_ms": bound_ms, "bound_by": bound_by}
    fused = timed({"fused": lambda: fullchain.fused_chain_power_radix(x16, plan)},
                  ("fused", "fused"))["fused"]
    out.update(max_abs_err=max_abs, rel_l2=worst_rel, fused_ms=fused)
    return out


#: the row epilogue's time per 48 channel-sectors in its earlier two-pass
#: form (one warp a row, the row read twice; tools/kernel_ab.py on an
#: NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
ROWS_PARENT_MS = "0.0625-0.0634"
#: pulse counts held against the C entry's rule (csrc/parseval_rows.cu)
ROWS_CONTRACT_N = (0, 4, 6, 8, 32, 100, 128, 130, 512, 514, 516, 1024, 1028,
                   2048)
#: row lengths outside the register form, run by the two-pass form
ROWS_TWO_PASS_N = (514, 2048)


def phase_kernel_rows(noise, adv, astage: dict) -> dict:
    """The row-epilogue kernel on every row shard of the A-stage's Y at
    rows = 512, 256, 128 (the register form: one read of Y, rows held in
    registers, a persistent grid) vs its plain version on the noise,
    clip-bin and strong-DC sectors; its two-pass form at n = 514 and 2048
    and on a Y at an address off 16 bytes; its ptxas lines, blocks per SM,
    the C entry's rule against parseval_rows_form's, and its times (one
    call, and queued) with its share of the bound."""
    cfg = DEFAULT_CONFIG
    plan = fullchain.build_plan(PipelineConstants.build(cfg), "cuda")
    mh = cfg.m // 2
    print_ptxas(r"parseval_rows")
    for n in ROWS_CONTRACT_N:
        try:
            fullchain.parseval_rows_occupancy(n)
            takes = True
        except RuntimeError:
            takes = False
        check(takes == (fullchain.parseval_rows_form(n) == "registers"),
              f"rows rule n={n}: the C entry's register form "
              f"{'takes' if takes else 'refuses'} it, as parseval_rows_form "
              f"says")
    occ = fullchain.parseval_rows_occupancy(cfg.n)
    print(f"row-epilogue register form: {occ} blocks per SM at n = {cfg.n}",
          flush=True)
    worst_rel = max_abs = 0.0
    inputs = seq_inputs(noise, adv)
    dc = strong_dc_sector(cfg)
    inputs["strong-dc"] = torch.from_numpy(np.stack(
        [planar_i16(dc)] * BATCH)).cuda().reshape(-1, 2, cfg.m, cfg.n)
    ys = {label: fullchain.fused_chain_astage(x, plan)
          for label, x in inputs.items()}

    def hold(label, y, plan, form):
        two = fullchain.PARSEVAL_ROWS_TWO_PASS_LAUNCHES
        got = fullchain.parseval_rows_power(y, plan)
        torch.cuda.synchronize()
        ran = ("two-pass" if fullchain.PARSEVAL_ROWS_TWO_PASS_LAUNCHES > two
               else "registers")
        e, a = rel_dev(fullchain.parseval_rows_power_reference(y, plan), got)
        check(ran == form and e <= POWER_TOL,
              f"rows {label} ({ran} form, expected {form}): kernel vs plain "
              f"power rel-L2 {e:.3e} <= {POWER_TOL} (max abs {a:.3e})")
        return e, a

    for label, y_full in ys.items():
        for shards in SHARDS:
            rows = mh // shards
            for d in range(shards):
                e, a = hold(f"{label} rows={rows} shard {d}/{shards}",
                            y_full[:, :, d * rows:(d + 1) * rows].contiguous(),
                            plan, "registers")
                worst_rel, max_abs = max(worst_rel, e), max(max_abs, a)
    # the two-pass form's errors apart: at n = 2048 the powers are ~1e10
    two_rel = two_abs = 0.0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for n in ROWS_TWO_PASS_N:
        tplan = fullchain.build_plan(PipelineConstants.build(
            tiny_config(m=256, n=n)), "cuda")
        y = 40.0 * torch.randn(48, 2, 128, n, device="cuda", generator=gen)
        checks = [hold(f"noise n={n}", y, tplan, "two-pass")]
        y[:, :, 5] += 3.0e4 * tplan.wd.min() / tplan.wd   # a strong DC row
        checks.append(hold(f"strong-dc n={n}", y, tplan, "two-pass"))
        two_rel = max([two_rel] + [e for e, _ in checks])
        two_abs = max([two_abs] + [a for _, a in checks])
    y = ys["noise"]
    # the same Y at an address 4 bytes past a 16-byte boundary
    buf = torch.empty(y.numel() + 1, device="cuda")
    y_off = buf[1:].view(y.shape)
    y_off.copy_(y)
    e, a = hold("noise, Y off 16 bytes", y_off, plan, "two-pass")
    two_rel, two_abs = max(two_rel, e), max(two_abs, a)
    t = timed({"plain": lambda: fullchain.parseval_rows_power_reference(y, plan),
               "kernel": lambda: fullchain.parseval_rows_power(y, plan)},
              ("plain", "kernel", "kernel", "plain"))
    # queued: the kernel is short enough that one call between two events
    # times mostly the wrapper's host work (printed beside it)
    q = timed({"kernel": lambda: fullchain.parseval_rows_power(y, plan),
               "two_pass": lambda: fullchain.parseval_rows_power(y_off, plan)},
              ("kernel", "two_pass", "two_pass", "kernel"), clock=queued_ms)
    host = host_ms(lambda: fullchain.parseval_rows_power(y, plan))
    bc = y.shape[0]
    bound_ms, bound_by = bound(26.0 * bc * mh * cfg.n,
                               y.numel() * 4 + 5 * cfg.n * 4 + bc * mh * 4)
    print(f"row-epilogue kernel, Y [{bc}, 2, {mh}, {cfg.n}]: one call "
          f"{t['kernel']:.4f} ms, the wrapper's host work {host:.4f} ms a "
          f"call; queued {q['kernel']:.4f} ms ({bound_ms / q['kernel']:.0%} of "
          f"the bound), the two-pass form on the Y off 16 bytes "
          f"{q['two_pass']:.4f} ms queued; the two-pass kernel's "
          f"{ROWS_PARENT_MS} ms (tools/kernel_ab.py); plain {t['plain']:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); A-stage + rows "
          f"{astage['ms'] + q['kernel']:.3f} ms vs the fused radix kernel "
          f"{astage['fused_ms']:.3f} ms in this call "
          f"({(astage['ms'] + q['kernel']) / astage['fused_ms']:.2f}x)",
          flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst_rel, "ms": t["kernel"],
            "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "queued_ms": q["kernel"],
            "two_pass_queued_ms": q["two_pass"], "two_pass_rel_l2": two_rel,
            "two_pass_max_abs_err": two_abs, "host_ms": host,
            "blocks_per_sm": occ}


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
          and counts["rows_two_pass"] == 0
          and counts["radix"] == counts["wire"] == counts["dense"] == 0,
          f"pulse-shard {tag}: A-stage and row-epilogue launches "
          f"{counts['astage']}, {counts['rows']} == {stats['batches']} full "
          f"lock-step batches + 1 warmup step, every row epilogue in its "
          f"register form; no other kernel ({counts})")
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


def phase_pulse_shard(orc: Oracle, noise) -> dict:
    """Both pulse-shard streams, then the halo step, inside one NCCL group
    of world size 1 (one card: NCCL refuses two ranks on one GPU; N ranks
    run in phase_halo_ranks where the machine has N cards, and on the CPU
    in tests/test_torch_multihost.py and tests/test_torch_halo.py)."""
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
        halo_world_one(orc, noise, dev)
    finally:
        # bounded: a teardown that blocks ends the script with exit 1
        leave_group(timeout_s=60.0)
    return host


def halo_world_one(orc: Oracle, noise, dev) -> None:
    """parallel/halo.py's step on the group's [1, 1] mesh (the circular
    filter, torch matmuls) on 4 noise sectors: vs the fused radix chain
    (SectorProcessor pallas, <= 1e-4) and each sector vs the fp64 oracle
    (zdb/zdr <= 2e-4); its step time beside the chain's."""
    from wrp_tpu_torch.pipeline import SectorProcessor

    cfg = DEFAULT_CONFIG
    mesh = make_mesh(seq=1, device=dev)
    step = build_halo_processor(cfg, mesh)
    x = shard_batch(np.stack([planar_i16(iq) for iq in noise[:4]]), mesh,
                    step.layout)
    single = SectorProcessor(cfg, method="pallas", device=dev)
    zdb, zdr = (t.cpu().numpy() for t in step(x))
    want_db, want_dr = (t.cpu().numpy() for t in single(x))
    e_db, e_dr = rel(want_db, zdb), rel(want_dr, zdr)
    check(mesh.shape == {"data": 1, "seq": 1} and e_db <= 1e-4
          and e_dr <= 1e-4,
          f"halo step, world size 1 (mesh {mesh.shape}): vs the fused radix "
          f"chain zdb {e_db:.3e}, zdr {e_dr:.3e} <= 1e-4")
    for k in range(4):
        pow64 = orc.power((cfg.m, cfg.n, "noise", k), noise[k], cfg)
        zdb64, zdr64 = oracle.stage09_10_products(pow64[0], pow64[1], cfg)
        ezdb, ezdr = rel(zdb64, zdb[k]), rel(zdr64, zdr[k])
        check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL,
              f"halo step sector {k} vs fp64 oracle: zdb {ezdb:.3e}, zdr "
              f"{ezdr:.3e} <= {PRODUCT_TOL}")
    ms = cuda_ms(lambda: step(x))
    print(f"halo step, world size 1, 4 sectors: {ms:.3f} ms (the fused "
          f"radix chain {cuda_ms(lambda: single(x)):.3f} ms)", flush=True)


#: the offset entries' kernel in a trace (the radix and salted entries are
#: instantiations of one FFT-form body, csrc/fft_chain.cuh)
FFT_CHAIN_KERNEL = "fft_chain_kernel"


def phase_bench_sharded(unsharded_value: float) -> dict:
    """`bench --sharded N --profile DIR --verbose` in this process (it
    starts the N ranks, rank k on cuda:k over NCCL), N = min(the GPU
    count, 4): its sharded gate (pallas < 1e-4, mxu and halo < 1e-3
    against the unsharded processor) and every rank's salted harness on its
    own share (the salted gate's bounds), value > 0 and every rank's
    launches of the salted offset entry equal to (the profiled pass, the
    warm pass and 3 timed passes) x steps + its gate's 2 calls; prints
    value, the parity, each rank's span and value over N x the unsharded
    value.  Then its traces (`sharded_traces`) and the dry run of every
    sharded step (`python -m wrp_tpu_torch.parallel.dryrun N`, on the GPUs
    by default) at the same N."""
    import contextlib
    import io
    import shutil
    import tempfile

    count = torch.cuda.device_count()
    n = min(count, 4)
    print(f"bench --sharded: {count} GPU(s) on this machine, N = {n}"
          + (" (one GPU: the sharded harness at one rank)" if n == 1 else ""),
          flush=True)
    torch.cuda.empty_cache()
    prof = Path(tempfile.mkdtemp(prefix="wrp_smoke_sharded_profile_"))
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            r = bench.run(["--sharded", str(n), "--profile", str(prof),
                           "--verbose"])
        lines = [ln for ln in err.getvalue().splitlines()
                 if "profiled pass" in ln]
        print("\n".join(lines), flush=True)
        found = [ln.split("busy share by rank: ", 1)[1] for ln in lines
                 if "busy share by rank: " in ln]
        shares = json.loads(found[-1]) if found else []
        check(len(shares) == n and all(0 < x["busy_share"] <= 1
                                       for x in shares),
              f"bench --sharded {n} --profile: rank 0 logged every rank's "
              f"busy share in its profiled pass "
              f"{[x['busy_share'] for x in shares]}")
        traced = sharded_traces(prof, n, r["steps"])
        for row, x in zip(traced, shares):
            row["pass_busy_share"] = x["busy_share"]
    finally:
        shutil.rmtree(prof, ignore_errors=True)
    print(f"bench --sharded {n}: " + json.dumps(r), flush=True)
    par = r["sharded_parity_rel_l2"]
    e0, e1 = r["parity_rel_l2"]
    want = (2 + len(r["timed_runs_s"])) * r["steps"] + 2
    check(r["sharded_devices"] == n and r["value"] > 0
          and par["pallas"] < BENCH_GATE[0] and par["mxu"] < BENCH_GATE[1]
          and par["halo"] < BENCH_GATE[1]
          and e0 < BENCH_GATE[0] and e1 < BENCH_GATE[1]
          and r["sharded_launches"] == [want] * n,
          f"bench --sharded {n}: {r['value']} sectors/s, parity {par} under "
          f"pallas {BENCH_GATE[0]}, mxu/halo {BENCH_GATE[1]}; the worst "
          f"rank's salted harness {e0:.3e}, {e1:.3e} under {BENCH_GATE}; "
          f"rank spans {r['sharded_rank_span_s']} s; offset launches a rank "
          f"{r['sharded_launches']} (want {want})")
    print(f"bench --sharded {n}: value / (N x unsharded {unsharded_value}) = "
          f"{r['value'] / (n * unsharded_value):.4f}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.parallel.dryrun", str(n)],
        cwd=here, capture_output=True, text=True, timeout=660)
    line = (done.stdout.strip().splitlines() or [""])[-1]
    check(done.returncode == 0 and line.startswith("dryrun_multichip OK: ")
          and f"bit-exact over {n} devices" in line,
          f"dryrun {n} (NCCL, one GPU a rank): {line} "
          f"({time.perf_counter() - t0:.1f} s) "
          f"{done.stderr[-2000:] if done.returncode else ''}")
    return {"devices": n, "launches": r["sharded_launches"],
            "value": r["value"], "traced": traced}


def sharded_traces(prof: Path, n: int, steps: int) -> list:
    """The traces of `bench --sharded n --profile prof`: one a rank,
    prof/rank{r}/trace.json, none at prof/trace.json; each holds `steps`
    events of the offset entry's kernel (the profiled pass's), all on
    cuda:r; trace_summary over prof reports n processes, one a rank folder,
    each with its device time.  Returns each rank's {"events": the offset
    kernel's events, "trace_busy_share": the device's busy share over the
    whole trace}."""
    from wrp_tpu_torch.tools import trace_summary

    paths = [prof / f"rank{r}" / "trace.json" for r in range(n)]
    check(all(p.exists() for p in paths) and not (prof / "trace.json").exists()
          and trace_summary.find_traces(str(prof)) == [str(p) for p in paths],
          f"bench --sharded {n} --profile: one trace a rank "
          f"({[str(p.relative_to(prof)) for p in paths]})")
    out = []
    for r, path in enumerate(paths):
        events = trace_summary.load_events(str(path))
        mine = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "kernel"
                and FFT_CHAIN_KERNEL in e.get("name", "")]
        devices = sorted({e.get("args", {}).get("device", e.get("pid"))
                          for e in mine})
        check(len(mine) == steps and devices == [r],
              f"rank {r}'s trace: {len(mine)} {FFT_CHAIN_KERNEL} events "
              f"(== steps {steps}) on device(s) {devices} (== [{r}])")
        out.append({"events": len(mine)})
    summary = trace_summary.run(str(prof), top=5)
    procs = summary["processes"]
    print("bench --sharded trace_summary: " + json.dumps(
        {p: info["device"] for p, info in procs.items()}), flush=True)
    check(len(procs) == n and sorted(p.split(":")[0] for p in procs)
          == [f"rank{r}" for r in range(n)]
          and all(info["device"]["kernel_ms"] > 0 for info in procs.values()),
          f"trace_summary over the profile: {len(procs)} processes "
          f"({sorted(procs)}), one a rank, each with device time")
    for r in range(n):
        out[r]["trace_busy_share"] = summary["device"][f"rank{r}"]["busy_share"]
    return out


def phase_halo_ranks() -> None:
    """Where the machine has N >= 2 cards (N <= 4): the halo and mxu
    pulse-sharded steps across N ranks, one card each
    (tools/pulse_shard_ranks.py --method halo,mxu): each rank's products vs
    the fused radix chain on its card (<= 1e-4) and the oracle, and each
    method's step ms."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print("halo ranks: one GPU on this machine, the N-rank halo runs "
              "only with N >= 2 cards (world size 1 runs in the pulse-shard "
              "phase)", flush=True)
        return
    here = os.path.dirname(os.path.abspath(__file__))
    done = subprocess.run(
        [sys.executable, "wrp_tpu_torch/tools/pulse_shard_ranks.py",
         "--ranks", str(n), "--method", "halo,mxu", "--reps", "10",
         "--timeout", "500"], cwd=here, capture_output=True, text=True,
        timeout=600)
    rows = [json.loads(ln) for ln in done.stdout.splitlines()
            if ln.startswith("{")]
    for method in ("halo", "mxu"):
        mine = [r for r in rows if r["method"] == method]
        check(done.returncode == 0 and len(mine) == n
              and all(r["ok"] for r in mine),
              f"{method} across {n} ranks: zdb/zdr vs the fused chain "
              f"{[(r['zdb_rel_vs_single'], r['zdr_rel_vs_single']) for r in mine]}"
              f", step ms {[r['step_ms'] for r in mine]} (one card's fused "
              f"chain {[r['single_device_ms'] for r in mine]}) "
              f"{done.stderr[-2000:] if done.returncode else ''}")


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
    check(ingest._native, f"{tag} stream: UDP reassembly in the native loop "
                          "(native/ingest.cpp)")
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
          f"{stats['timers']['ingest/decode']['mean_ms']} ms ("
          f"{'a view of the wire' if device_decode else 'native codec'}), "
          f"ingest/recv {stats['timers']['ingest/recv']['mean_ms']} ms "
          f"(native UDP loop); egress frames {sink.frames}; launches "
          f"{counts}", flush=True)
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
    check_cut_vs_oracle(f"{tag} stream", volume, SEED, pool_n, cfg)
    return counts


def free_tcp_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ResultCollector:
    """Runs a v2 result consumer (TcpResultConsumer / ZmqResultConsumer) on
    a thread and accumulates its frames into a VolumeScan; counts zdb (B)
    and zdr (C) frames."""

    def __init__(self, consumer, cfg):
        self.consumer = consumer
        self.volume = VolumeScan(cfg)
        self.frames = [0, 0]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            item = self.consumer.recv()
            if item is None:
                continue
            topic, sector, elevation, values = item
            k = 0 if topic == b"B" else 1
            self.frames[k] += 1
            self.volume.data[k, :, sector, elevation] = values

    def wait_for(self, count: int, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while self.frames != [count, count] and time.monotonic() < deadline:
            time.sleep(0.05)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self.consumer.close()


def check_cut_vs_oracle(tag, volume, seed, pool_n, cfg, sectors=None) -> None:
    """Sampled sectors of elevation 0 of a volume (sector k is pool entry
    k % pool_n of `cli produce --seed seed`; by default 0, 35, 102 and 142
    as in phase_stream) within PRODUCT_TOL of the fp64 oracle, and zdb bin 0
    exactly -inf."""
    if sectors is None:
        sectors = (0, SECTORS // 4, 5 * SECTORS // 7, SECTORS - 1)
    for k in sectors:
        zdb64, zdr64 = oracle.process_sector(
            oracle.produce_sector_iq(cfg, seed, k % pool_n), cfg)
        zdb, zdr = volume.data[0, :, k, 0], volume.data[1, :, k, 0]
        ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
        check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
              and zdb[0] == -np.inf,
              f"{tag}: sector {k} vs fp64 oracle: zdb {ezdb:.3e}, zdr "
              f"{ezdr:.3e}, zdb[0] {zdb[0]}")


def phase_stream_v2(transport: str) -> dict:
    """One cut of 143 sectors from a `cli produce --transport tcp|zmq`
    process at the radar's rate into TcpIngest / ZmqIngest, the executor
    with host decode (method="pallas": the radix kernel), and the v2 result
    frames through TcpEgress / ZmqEgress to a result consumer run here,
    which accumulates them into a VolumeScan.  zmq runs the reference's
    2-part v2 wire without labels (rpv2.cu:356-358): sectors are placed
    positionally."""
    tag = f"{transport} stream"
    t_phase = time.perf_counter()
    cfg = DEFAULT_CONFIG
    pool_n = 8
    ingest_port, result_port = free_tcp_port(), free_tcp_port()
    cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
           "--transport", transport, "--sectors", str(SECTORS),
           "--rate", str(RATE), "--pool", str(pool_n), "--seed", str(SEED)]
    if transport == "tcp":
        from wrp_tpu_torch.io.tcp import (TcpEgress, TcpIngest,
                                          TcpResultConsumer)

        ingest = TcpIngest(cfg, port=ingest_port, host="127.0.0.1",
                           timeout_s=2.0)
        collector = _ResultCollector(
            TcpResultConsumer(cfg, port=result_port, host="127.0.0.1",
                              timeout_s=0.5), cfg)
        egress = TcpEgress(cfg, port=result_port)
        cmd += ["--ingest-port", str(ingest_port)]
    else:
        from wrp_tpu_torch.io.zmq_io import (ZmqEgress, ZmqIngest,
                                             ZmqResultConsumer)

        ingest_ep = f"tcp://127.0.0.1:{ingest_port}"
        result_ep = f"tcp://127.0.0.1:{result_port}"
        ingest = ZmqIngest(cfg, endpoint=ingest_ep, timeout_ms=2000)
        egress = ZmqEgress(cfg, endpoint=result_ep)
        collector = _ResultCollector(
            ZmqResultConsumer(cfg, endpoint=result_ep, timeout_ms=500), cfg)
        cmd += ["--zmq-bind", ingest_ep, "--connect-delay", "1"]
    producer: list = []
    ex = StreamingExecutor(
        cfg, transport=ingest, publish=egress, batch=BATCH, method="pallas",
        max_sectors=SECTORS, idle_limit=15,
        on_ready=lambda: producer.append(subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)))),
        device="cuda")
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
        collector.wait_for(SECTORS, 10.0)
        collector.close()
    check(bool(producer) and producer[0].returncode == 0,
          f"{tag}: producer process exited 0")
    lat, timers = stats["latency_ms"], stats["timers"]
    print(f"{tag}: {stats['processed_sectors']} sectors, requested {RATE}/s, "
          f"delivered {ex.throughput.active_rate():.2f} sectors/s over the "
          f"active span; latency p50 {lat['p50_ms']} ms p99 {lat['p99_ms']} "
          f"ms; mean ingest/recv {timers['ingest/recv']['mean_ms']} ms, "
          f"ingest/decode {timers['ingest/decode']['mean_ms']} ms (native "
          f"codec); transport {json.dumps(stats['transport'])}; v2 frames "
          f"{collector.frames}; launches {counts}", flush=True)
    tr = stats["transport"]
    check(stats["processed_sectors"] == SECTORS,
          f"{tag}: {stats['processed_sectors']}/{SECTORS} sectors processed")
    check(tr["dropped_sectors"] == 0 and tr["sectors"] == SECTORS,
          f"{tag}: 0 drops (dropped sectors {tr['dropped_sectors']}, "
          f"received {tr['sectors']})")
    check(collector.frames == [SECTORS, SECTORS],
          f"{tag}: {collector.frames} zdb/zdr v2 frames received")
    need = math.ceil(SECTORS / BATCH)
    check(counts["radix"] >= need,
          f"{tag}: radix kernel launched {counts['radix']} times during the "
          f"run (>= {need})")
    check_cut_vs_oracle(f"{tag} (received v2 frames)", collector.volume,
                        SEED, pool_n, cfg)
    print(f"{tag}: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def _events(path: Path) -> list:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass              # a line being written
    return out


def _await_event(path: Path, proc, kind: str, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        evs = [e for e in _events(path) if e["event"] == kind]
        if evs:
            return evs[-1]
        if proc.poll() is not None:
            raise SmokeFailure(f"supervisor exited {proc.returncode} before "
                               f"{kind!r}: {proc.communicate()[1][-3000:]}")
        time.sleep(0.1)
    raise SmokeFailure(f"no {kind!r} event in {timeout_s} s; events "
                       f"{[e['event'] for e in _events(path)]}")


def _coverage(path: Path) -> int:
    try:
        return int(VolumeScan.load(path).coverage.sum())
    except (OSError, ValueError, KeyError):
        return 0              # not written yet


def _last_stats(log: Path) -> dict:
    """The last stats object a worker printed (`cli stream` prints its
    stats as indented JSON on exit; the log holds every generation of the
    host slot, appended)."""
    text = log.read_text()
    start = text.rfind("\n{\n")
    if start < 0:
        raise SmokeFailure(f"no stats in {log}: {text[-2000:]}")
    return json.JSONDecoder().raw_decode(text[start + 1:])[0]


def phase_supervise() -> dict:
    """`cli supervise --transport tcp` as a user runs it: two feeds on one
    host, device decode (the wire kernel), checkpoints under a temp dir.
    Sectors 0-71 of each feed from two paced `cli produce` processes, then
    SIGTERM (exit 4, reason interrupted, both checkpoints on disk); the
    same command again resumes from the checkpoints and takes sectors
    72-142 to the target (exit 0, reason target, 143 a feed).  The
    one-card form of a regroup: the checkpoint follows the feed across
    generations.  The worker is another process, so its launches come from
    the stats it prints into its log."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    cfg = DEFAULT_CONFIG
    pool_n, half = 8, (SECTORS + 1) // 2
    ports = [free_tcp_port(), free_tcp_port()]
    seeds = [SEED, SEED + 1]
    tmp = Path(tempfile.mkdtemp(prefix="wrp_smoke_supervise_"))
    ckdir = tmp / "ck"
    ck = [ckdir / f"feed{p}.npz" for p in ports]
    here = os.path.dirname(os.path.abspath(__file__))

    def supervise(state: Path):
        cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "supervise",
               "--transport", "tcp", "--hosts", "1", "--method", "pallas",
               "--device-decode", "--batch", str(BATCH), "--timeout", "2",
               "--target-sectors", str(SECTORS), "--checkpoint-dir",
               str(ckdir), "--state-file", str(state),
               "--result-port", str(free_tcp_port()), "--ready-timeout",
               "240"]
        for p in ports:
            cmd += ["--feed-port", str(p)]
        return subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def produce(start: int, count: int) -> None:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
             "--transport", "tcp", "--ingest-port", str(p), "--sectors",
             str(count), "--start-sector", str(start), "--rate", str(RATE),
             "--pool", str(pool_n), "--seed", str(sd)], cwd=here)
            for p, sd in zip(ports, seeds)]
        for proc in procs:
            proc.wait(timeout=120)
        check(all(proc.returncode == 0 for proc in procs),
              f"supervised run: producers of sectors {start}-"
              f"{start + count - 1} exited 0")

    def finish(proc, timeout_s: float):
        out, err = proc.communicate(timeout=timeout_s)
        try:
            return proc.returncode, json.loads(out)
        except json.JSONDecodeError:
            raise SmokeFailure(f"supervisor rc {proc.returncode}, no "
                               f"summary: {out[-1000:]} {err[-3000:]}")

    runs = []
    procs = []
    try:
        # run 1: sectors 0-71 of each feed, then SIGTERM
        state = tmp / "state1.jsonl"
        sup = supervise(state)
        procs.append(sup)
        launch = _await_event(state, sup, "launch", 60)
        ready = _await_event(state, sup, "ready", 240)
        runs.append({"launch_to_ready_s": round(ready["t"] - launch["t"], 3)})
        produce(0, half)
        deadline = time.monotonic() + 60
        while any(_coverage(p) < half for p in ck):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"checkpoints never held {half} sectors: "
                                   f"{[_coverage(p) for p in ck]}")
            time.sleep(0.1)
        t_term = time.monotonic()
        sup.send_signal(signal.SIGTERM)
        rc, summary = finish(sup, 120)
        runs[0]["sigterm_to_exit_s"] = round(time.monotonic() - t_term, 3)
        stats1 = _last_stats(ckdir / "logs" / "g0-h0.log")
        print(f"supervised run 1 (interrupted): rc {rc}, summary "
              f"{json.dumps(summary)}; worker launches "
              f"{stats1['kernel_launches']}, processed "
              f"{stats1['processed_sectors']}, latency p50 "
              f"{stats1['latency_ms']['p50_ms']} ms", flush=True)
        check(rc == 4 and summary["reason"] == "interrupted",
              f"supervised run 1: SIGTERM ends it with exit {rc} (4), "
              f"reason {summary['reason']!r} (interrupted)")
        check(all(p.exists() for p in ck)
              and list(summary["coverage"].values()) == [half, half],
              f"supervised run 1: both checkpoints on disk, coverage "
              f"{summary['coverage']}")
        # run 2: the same command resumes from the checkpoints
        state = tmp / "state2.jsonl"
        t_relaunch = time.monotonic()
        sup = supervise(state)
        procs.append(sup)
        launch = _await_event(state, sup, "launch", 60)
        ready = _await_event(state, sup, "ready", 240)
        runs.append({"launch_to_ready_s": round(ready["t"] - launch["t"], 3),
                     "relaunch_to_ready_s": round(
                         time.monotonic() - t_relaunch, 3)})
        produce(half, SECTORS - half)
        rc, summary = finish(sup, 120)
        stats2 = _last_stats(ckdir / "logs" / "g0-h0.log")
    finally:
        killed = [proc for proc in procs if proc.poll() is None]
        for proc in killed:
            proc.kill()
            proc.wait(timeout=30)
        # a supervisor that exits by itself has stopped its worker; one
        # killed here leaves it running: end it by the pid it launched
        for path in (tmp / "state1.jsonl", tmp / "state2.jsonl"):
            for ev in _events(path) if killed else ():
                for w in ev.get("workers", []):
                    try:
                        os.kill(w["pid"], signal.SIGKILL)
                    except OSError:
                        pass
    print(f"supervised run 2 (resumed): rc {rc}, summary "
          f"{json.dumps(summary)}; worker launches "
          f"{stats2['kernel_launches']}, processed "
          f"{stats2['processed_sectors']}, latency p50 "
          f"{stats2['latency_ms']['p50_ms']} ms p99 "
          f"{stats2['latency_ms']['p99_ms']} ms; worker start-up "
          f"{json.dumps(runs)}", flush=True)
    check(rc == 0 and summary["ok"] and summary["reason"] == "target",
          f"supervised run 2: exit {rc}, reason {summary['reason']!r} "
          "(target)")
    check(list(summary["coverage"].values()) == [SECTORS, SECTORS],
          f"supervised run 2: coverage {summary['coverage']} ({SECTORS} a "
          "feed)")
    for f, (path, sd) in enumerate(zip(ck, seeds)):
        check_cut_vs_oracle(f"supervised feed {f} checkpoint",
                            VolumeScan.load(path), sd, pool_n, cfg,
                            sectors=(5, SECTORS - 1))
    need = math.ceil(2 * (SECTORS - half) / BATCH)
    wire = stats2["kernel_launches"]["wire"]
    check(wire >= need and stats2["kernel_launches"]["radix"] == 0,
          f"supervised run 2: the worker launched the wire kernel {wire} "
          f"times (>= {need}; radix {stats2['kernel_launches']['radix']})")
    shutil.rmtree(tmp, ignore_errors=True)   # kept when a check fails
    print(f"supervised run: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"wire_run1": stats1["kernel_launches"]["wire"], "wire_run2": wire,
            "startup": runs}


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


#: native decode threads timed beside the codec's default
CODEC_THREADS = (1, 2, 4, 6)


def codec_rates(wires, cfg, reps: int = 20) -> dict:
    """Sectors/s of one decode_iq_i16 call after another on this host, a
    fresh output each, as the executor calls it: the native codec at its
    default threads (io/codec) and at CODEC_THREADS, and the numpy codec,
    in turns (forward, then back; the better of each's two): a
    comparison, not a check."""
    m, n, ch = cfg.m, cfg.n, cfg.num_channels
    fns = {"native": lambda w: codec.decode_iq_i16(w, cfg),
           "numpy": lambda w: codec.decode_iq_i16(w, cfg, native=False)}
    for th in CODEC_THREADS:
        fns[f"native_{th}_threads"] = functools.partial(
            lambda w, th: codec_native.decode_iq_i16(w, m, n, ch,
                                                     num_threads=th), th=th)
    rates = dict.fromkeys(fns, 0.0)
    for name in list(fns) + list(reversed(fns)):
        fns[name](wires[0])
        t0 = time.perf_counter()
        for k in range(reps):
            fns[name](wires[k % len(wires)])
        rates[name] = max(rates[name], reps / (time.perf_counter() - t0))
    return rates


def phase_capacity(device_decode: bool, count: int = 2 * SECTORS) -> None:
    """Unpaced run of the same executor fed from memory; products must be
    finite.  Reports sectors/s over the active span (first to last batch);
    with host decode (the native codec) also the native and numpy codecs'
    own rates on this host."""
    cfg = DEFAULT_CONFIG
    tag = "device-decode" if device_decode else "host-decode"
    wires = [codec.encode_iq(oracle.produce_sector_iq(cfg, SEED, j), cfg)
             for j in range(4)]
    if not device_decode:
        rates = codec_rates(wires, cfg)
        print(f"decode_iq_i16 alone at {cfg.m} x {cfg.n} x "
              f"{cfg.num_channels}, sectors/s: native codec "
              f"{rates.pop('native'):.2f} at its default "
              f"{codec_native.DEFAULT_THREADS} threads, numpy codec "
              f"{rates.pop('numpy'):.2f}; native by threads "
              + json.dumps({k: round(v, 2) for k, v in rates.items()}),
              flush=True)
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


def phase_dense_path() -> dict:
    """The executor at m = 1000 (no radix split) from memory: device decode
    (decode_wire_i16, then the dense entry) and host decode, every launch
    on the FFT-form body.  Sampled sectors within 2e-4 of the oracle;
    returns the dense entry's launches and the FFT body's over both
    runs."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=DENSE_M)
    count = 2 * BATCH
    iqs = [oracle.produce_sector_iq(cfg, SEED, j) for j in range(4)]
    wires = [codec.encode_iq(iq, cfg) for iq in iqs]
    launches = {"dense": 0, "dense_fft": 0}
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
              and counts["dense_fft"] == counts["dense"]
              and counts["dense_matrix"] == 0
              and counts["radix"] == counts["wire"] == 0,
              f"dense path {tag}: {stats['processed_sectors']}/{count} "
              f"sectors through the dense entry only, every launch on the "
              f"FFT-form body ({counts})")
        for k in range(4):
            zdb64, zdr64 = oracle.process_sector(iqs[k], cfg)
            zdb, zdr = volume.data[0, :, k, 0], volume.data[1, :, k, 0]
            ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
            check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
                  and zdb[0] == -np.inf,
                  f"dense path {tag} sector {k} vs fp64 oracle: zdb "
                  f"{ezdb:.3e}, zdr {ezdr:.3e}")
        for k in launches:
            launches[k] += counts[k]
    return launches


#: the long-ray slice: the planar chain (#3/#4), the wire chain (#7/#8),
#: the A-stage (#5) and the dense entries (#1/#2) on the cluster body for
#: 1024 < m <= CLUSTER_MAX_M, their matrix routes above it; the dense
#: entries' m = 2 x odd in (2048, FFT_MAX_M] on the FFT-form long-ray body
LONG_M = 2048             # the executor's, the bench's and the times' geometry
#: the cluster body's kernels (#3, #4, #5, #7, #8) vs plain, and their times
CLUSTER_CHECK_MS = (1536, 1840, 2048, 4096, 4112, 4160, 8192)
#: radix 1 on the cluster body: m = S x odd, S = 8, 4, 2 (8 x 229: a
#: Bluestein leaf; 4 x 459 = 4 x 27 x 17; 2 x 1001 = 2 x 7 x 11 x 13)
CLUSTER_DENSE_MS = (1832, 1836, 2002)
LONG_DENSE_M = 1832       # the dense entries' times, per 48 channel-sectors
LONG_BODY_M = 4094        # 2 x 23 x 89: the one m the long-ray body keeps
ODD_LEAF_M = 4160         # radix 8, 8 x 520 (a 5 x 13 leaf): timed on 6 channel-sectors
BLUESTEIN_M = 4112        # radix 8, 8 x 514 (a 257-point Bluestein leaf): #3, #5, #7 on 6
#: the cluster of 16 (8192 < m <= 16384): #3/#4, #7/#8 and #5 checked on 6
#: channel-sectors at 16 x 8 x 65 (a 5 x 13 leaf), 16 x 1024 (L = 1) and,
#: at P = 1 (m = 16 x odd: the odd leaf alone), 16 x 513 (3^3 x 19), 16 x
#: 515 (5 x 103, Bluestein N = 256) and 16 x 1023 (3 x 11 x 31, span 64)
CLUSTER16_MS = (8320, 16384, 8208, 8240, 16368)
#: of those, the m the slice's main path runs at, and the m timed
CLUSTER16_PATH_MS = (8320, 16384, 8208)
CLUSTER16_TIMED_MS = (8320, 16384, 8208, 16368)
#: one m for each kernel of the cluster of 16, P = 2, 4, 8, 16, 32, 64, 128,
#: 256 (an odd leaf L: m = 16 P L), 1024 (L = 1) and P = 1 (8208, 8240,
#: 16368: one kernel at three cuts): their resident clusters
CLUSTER16_KERNEL_MS = (8224, 8640, 8320, 8448, 8704, 9216, 10240, 12288, 16384,
                       8208, 8240, 16368)
CLUSTER16_BENCH = ("--range-cells", "8320", "--batch", "2", "--repeats", "2")
#: the kernel part files of the cluster of 16, by entry
CLUSTER16_SOURCES = {
    chain: [f"wrp_tpu_torch/csrc/fused_chain_{chain}_cluster16{part}.cu"
            for part in ("_p8", "", "_p1", "_p2")]
    for chain in ("radix", "wire", "astage")}
#: 16 x 521, radix 2, refused by the cluster body (a Bluestein length of
#: 2048): #3/#4, #7/#8, #5 on their matrix routes
MATRIX_REFUSED_M = 8336
LONG_TOL = 1e-5           # a long-ray kernel vs its plain version (power rel-L2)
LONG_BENCH = ("--range-cells", str(LONG_M), "--batch", "32", "--repeats", "4")


def long_ray_executor(cfg, iqs, wires) -> dict:
    """The executor at m = LONG_M from memory, host decode (#3) and device
    decode (#7), each on the cluster body: every sector processed, every
    launch on the cluster body (no matrix kernel, no other), sampled
    sectors within PRODUCT_TOL of the oracle.  Returns {"radix": host-decode
    launches, "wire": device's}."""
    count = 2 * BATCH
    out = {}
    for device_decode, key in ((False, "radix"), (True, "wire")):
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
        print(f"long rays m={cfg.m}, {tag}: {stats['processed_sectors']} "
              f"sectors, {ex.throughput.active_rate():.2f} sectors/s; "
              f"launches {counts}", flush=True)
        body = f"{key}_cluster"
        others = {k: v for k, v in counts.items() if k not in (key, body)}
        check(stats["processed_sectors"] == count
              and counts[key] >= count // BATCH and not any(others.values())
              and counts[body] == counts[key],
              f"long rays m={cfg.m} {tag}: {stats['processed_sectors']}/"
              f"{count} sectors, every launch on the {key} kernel's cluster "
              f"body ({counts[body]} of {counts[key]}), none on the matrix "
              f"kernel ({counts['dense_matrix']}) or another")
        for k in range(len(iqs)):
            zdb64, zdr64 = oracle.process_sector(iqs[k], cfg)
            zdb, zdr = volume.data[0, :, k, 0], volume.data[1, :, k, 0]
            ezdb, ezdr = rel(zdb64, zdb), rel(zdr64, zdr)
            check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL
                  and zdb[0] == -np.inf,
                  f"long rays {tag} sector {k} vs fp64 oracle: zdb "
                  f"{ezdb:.3e}, zdr {ezdr:.3e}")
        out[key] = counts[key]
    return out


def cluster_note(m: int, w: int) -> str:
    """The cluster body's cut of m rows and w pulses (csrc/cluster_chain.cuh),
    printed beside the bound, never as it."""
    g = fullchain.cluster_geometry(m, w)
    passes = fullchain.leaf_plan(g.L).radices
    leaf = (f", in-place leaf passes {' x '.join(map(str, passes))}"
            + (f" (Bluestein N = {g.bluestein})" if g.bluestein else "")
            if passes else "")
    cuts = []
    bodies = (("#3/#4 and #7/#8", True, 0), ("A-stage int16", False, 2),
              ("A-stage f32", False, 4))
    for what, fused, elem in bodies if fullchain.radix_for(m) > 1 else (
            ("#1/#2", True, 0),):
        c = fullchain.cluster_geometry(m, w, fused, elem)
        cuts.append(f"{what} {c.cols} columns a round, "
                    f"{fullchain.cluster_smem_bytes(m, c.cols, fused, elem)} B"
                    + (f", {c.batch} convolutions at a time" if c.batch else ""))
    return (f"the cluster body: {g.S} blocks a unit, each the {g.ms}-point DFT "
            f"of rows {g.S} t + b (P = {g.P} = {g.P1} x {g.P2}, L = "
            f"{g.L}{leaf}), the {g.S // 2}-of-{g.S} combine over DSMEM on "
            f"{g.span} k1 a block; " + "; ".join(cuts))


def long_ray_kernels(gen) -> dict:
    """Each cluster-body kernel vs its plain version on seeded int16 noise
    at CLUSTER_CHECK_MS: #3 (int16, f32) and #4 (offset, salt 7, the second
    of two slabs) vs cluster_chain_power_reference, #7, #8 (offset, salt 7)
    and #5 (int16 and f32 at w = n, int16 at n/4); power (Y for #5) rel-L2
    <= LONG_TOL.  Each geometry's cut, route and occupancy printed; no FFT
    tables and no A_half on the host at those m.  Returns {kernel:
    {rel_l2, max_abs_err}}."""
    res = {k: {"rel_l2": 0.0, "max_abs_err": 0.0}
           for k in ("radix", "radix_offset", "wire", "wire_offset", "astage")}

    def hold(key, what, ref, got):
        torch.cuda.synchronize()
        e, a = rel_dev(ref, got)
        check(e <= LONG_TOL, f"long rays {what}: kernel vs plain rel-L2 "
                             f"{e:.3e} <= {LONG_TOL}")
        res[key]["rel_l2"] = max(res[key]["rel_l2"], e)
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], a)

    for m in CLUSTER_CHECK_MS:
        cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=m)
        n, ch = cfg.n, cfg.num_channels
        plan = fullchain.build_plan(PipelineConstants.build(cfg), "cuda")
        b = BATCH if m == LONG_M else 4
        bc = b * ch
        occ = {body: fullchain.fft_occupancy(plan, body)
               for body in ("radix", "wire", "astage")}
        print(f"long rays m={m}: radix {plan.radix}, #3, #4, #5, #7, #8 on "
              f"{cluster_note(m, n)}; occupancy {json.dumps(occ)}",
              flush=True)
        check(plan.radix > 1 and fullchain.chain_route(m) == "cluster"
              and not fullchain.fft_takes(m) and plan.fft_t is None
              and plan.host_a_half is None
              and all(v["blocks_per_sm"] >= 1 and v["clusters"] > 0
                      for v in occ.values()),
              f"m={m} takes the cluster body, resident: {json.dumps(occ)}")
        x = torch.randint(-8192, 8192, (2 * bc, 2, m, n), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.int16)
        for xx in (x[:bc], x[:bc].float()):
            hold("radix", f"#3 m={m} {xx.dtype} (cluster body)",
                 fullchain.cluster_chain_power_reference(xx, plan),
                 fullchain.fused_chain_power_radix(xx, plan))
        hold("radix_offset", f"#4 m={m} offset {bc} salt 7 (cluster body)",
             fullchain.cluster_chain_power_reference(x[bc:], plan, 7),
             fullchain.fused_chain_power_radix(x, plan, offset=bc, bc=bc,
                                               salt=7))
        w32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2 * b, m, ch * n),
                            generator=gen, device="cuda", dtype=torch.int32)
        hold("wire", f"#7 m={m} (cluster body)",
             fullchain.fused_chain_power_wire_reference(w32[:b], plan, ch),
             fullchain.fused_chain_power_wire(w32[:b].contiguous(), plan, ch))
        hold("wire_offset", f"#8 m={m} offset {b} salt 7 (cluster body)",
             fullchain.fused_chain_power_wire_reference(w32[b:], plan, ch, 7),
             fullchain.fused_chain_power_wire(w32, plan, ch, offset=b, bs=b,
                                              salt=7))
        for xs in (x[:bc], x[:bc].float(), x[:bc, ..., :n // 4].contiguous()):
            hold("astage", f"#5 m={m} {xs.dtype} w={xs.shape[-1]} (cluster "
                           f"body)",
                 fullchain.fused_chain_astage_reference(xs, plan),
                 fullchain.fused_chain_astage(xs, plan))
        del x, w32
        torch.cuda.empty_cache()
    return res


def long_ray_times(gen, m: int = LONG_M, keys=None,
                   sectors: int = BATCH, with_plain: bool = True,
                   plan=None) -> dict:
    """CUDA-event ms per `sectors` sectors x 3 channels x m x 512 (48
    channel-sectors by default) of #3 (int16; "radix_f32": f32, queued
    only), #4 (offset of the second slab, salt 7), #7, #8 and #5 (w = 512),
    or of those named in `keys`, each through its route at m, in turns with
    its plain version where `with_plain` (#5 also with cuFFT: torch.fft.fft
    over range of the windowed complex64 input, then the crop; else the
    kernel and cuFFT queued alone), beside the bound (the bytes: 201 MB of
    int16 at m = 2048, 48 channel-sectors).  `plan`: m's plan on the card,
    if built already."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=m)
    n, ch = cfg.n, cfg.num_channels
    if plan is None:
        plan = fullchain.build_plan(PipelineConstants.build(cfg), "cuda")
    bc = sectors * ch
    x = torch.randint(-8192, 8192, (2 * bc, 2, m, n), generator=gen,
                      device="cuda", dtype=torch.int32).to(torch.int16)
    x16 = x[:bc]
    x32 = x16.float() if keys is None or "radix_f32" in keys else None
    w32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (2 * sectors, m, ch * n),
                        generator=gen, device="cuda", dtype=torch.int32)
    w16 = w32[:sectors].contiguous()
    out_b = bc * m // 2 * 4
    route = fullchain.chain_route(m)
    planar_plain = {"register": fullchain.fft_chain_power_reference,
                    "cluster": fullchain.cluster_chain_power_reference,
                    "matrix": fullchain.fused_chain_power_reference}[route]
    runs = {
        "radix": (lambda: fullchain.fused_chain_power_radix(x16, plan),
                  lambda: planar_plain(x16, plan), x16.numel() * 2),
        "radix_f32": (lambda: fullchain.fused_chain_power_radix(x32, plan),
                      None, x16.numel() * 4),
        "radix_offset": (
            lambda: fullchain.fused_chain_power_radix(x, plan, offset=bc,
                                                      bc=bc, salt=7),
            lambda: planar_plain(x[bc:], plan, 7), x16.numel() * 2),
        "wire": (lambda: fullchain.fused_chain_power_wire(w16, plan, ch),
                 lambda: fullchain.fused_chain_power_wire_reference(
                     w16, plan, ch), w16.numel() * 4),
        "wire_offset": (
            lambda: fullchain.fused_chain_power_wire(
                w32, plan, ch, offset=sectors, bs=sectors, salt=7),
            lambda: fullchain.fused_chain_power_wire_reference(
                w32[sectors:], plan, ch, 7), w16.numel() * 4),
        "astage": (lambda: fullchain.fused_chain_astage(x16, plan),
                   lambda: fullchain.fused_chain_astage_reference(x16, plan),
                   x16.numel() * 2),
    }
    out = {}
    for key, (kernel, plain, in_bytes) in runs.items():
        if keys is not None and key not in keys:
            continue
        if not with_plain:
            plain = None
        fns = {"plain": plain, "kernel": kernel} if plain else {}
        order = ("plain", "kernel", "kernel", "plain") if plain else ()
        if key == "astage":
            win = plan.fft_t[:m] if route != "cluster" else plan.cluster_t[:m]
            xw = (torch.complex(x16[:, 0].float(), x16[:, 1].float())
                  * win[:, None]).contiguous()     # pre-windowed, as cuFFT's input
            fns["library"] = lambda: torch.fft.fft(xw, dim=1)[:, :m // 2]
            if plain:
                order = ("plain", "kernel", "library", "library", "kernel",
                         "plain")
        t = timed(fns, order) if order else {}
        queued = queued_ms(kernel)
        lib_queued = queued_ms(fns["library"]) if "library" in fns else None
        fused = key != "astage"
        tab = plan.cluster_t if route == "cluster" else plan.fft_t
        bound_ms, bound_by = bound(
            bc * (chain_flops(m, n) if fused else astage_flops(m, n)),
            in_bytes + (tab.numel() * 4 if tab is not None else m * 4)
            + (out_b if fused else x16.numel() // 2 * 4))
        print(f"long rays {key} at m={m} ({route} body), {bc} "
              f"channel-sectors x {n} pulses: "
              + (f"{t['kernel']:.3f} ms ({queued:.3f} queued), plain "
                 f"{t['plain']:.3f} ms" if t else f"{queued:.3f} ms queued")
              + (f", cuFFT {t['library']:.3f} ms ({lib_queued:.3f} queued)"
                 if "library" in t else f", cuFFT {lib_queued:.3f} ms queued"
                 if lib_queued is not None else "")
              + f", bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        out[key] = {"ms": t.get("kernel", queued), "queued_ms": queued,
                    "plain_ms": t.get("plain"), "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": t.get("library"),
                    "library_queued_ms": lib_queued, "body": route,
                    "channel_sectors": bc}
        if "library" in fns:
            del fns["library"], xw
    del x, x32, w32
    torch.cuda.empty_cache()
    return out


def long_ray_dense(orc: Oracle) -> dict:
    """The dense entries at the radix-1 m of CLUSTER_DENSE_MS, each on the
    cluster body (m = S x odd: S = 8, 4, 2): #1 on noise sectors (batch 16
    at LONG_DENSE_M, 2 otherwise), int16 and f32, vs its plain version (<=
    LONG_TOL) and the oracle; #2 on the second half of them; every launch
    on the cluster body, none on the FFT-form or matrix kernel.  #1's time
    at LONG_DENSE_M per 48 channel-sectors in turns with its plain version
    and the matrix kernel (the dense entries' route before the FFT forms), beside
    the bound; then at LONG_BODY_M the one m left on the long-ray body (#1
    vs plain, its launch counted there, timed on 6 channel-sectors)."""
    out = {"rel_l2": 0.0, "max_abs_err": 0.0, "by_m": {}}
    reset_counts()
    for m in CLUSTER_DENSE_MS:
        cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=m)
        consts = PipelineConstants.build(cfg)
        plan = fullchain.build_plan(consts, "cuda")
        g = plan.cluster
        check(plan.radix == 1 and fullchain.chain_route(m) == "cluster"
              and g.S == m & -m and plan.fft_t is None,
              f"m={m} takes the dense entries' cluster body: "
              f"{cluster_note(m, cfg.n)}")
        b = BATCH if m == LONG_DENSE_M else 2
        sectors = [oracle.synthetic_iq(cfg, kind="noise", seed=SEED + k)
                   for k in range(b)]
        x_np = np.stack([planar_i16(iq) for iq in sectors])
        worst_rel, max_abs = planar_kernel_checks(
            f"#1 m={m} (cluster body, S = {g.S})",
            fullchain.fused_chain_power_dense, dense_plain, plan, cfg,
            {"noise": (x_np, sectors[:2 if m == LONG_DENSE_M else 1])}, orc,
            torch.from_numpy(consts.gain).cuda(), {"noise": LONG_TOL})
        x16 = torch.from_numpy(x_np).cuda().reshape(-1, 2, m, cfg.n)
        half = x16.shape[0] // 2
        got = fullchain.fused_chain_power_at(x16, half, half, plan)
        torch.cuda.synchronize()
        e, a = rel_dev(dense_plain(x16[half:], plan), got)
        check(e <= LONG_TOL, f"#2 m={m} offset {half}: kernel vs plain rel-L2 "
                             f"{e:.3e} <= {LONG_TOL}")
        out["rel_l2"] = max(out["rel_l2"], worst_rel, e)
        out["max_abs_err"] = max(out["max_abs_err"], max_abs, a)
        out["by_m"][str(m)] = {"S": g.S, "cols": g.cols, "rel_l2": max(
            worst_rel, e), "bluestein": g.bluestein}
        if m == LONG_DENSE_M:
            timing = (plan, x16, cfg)
        del x16, plan
    counts = read_counts()
    check(counts["dense_cluster"] == counts["dense"] + counts["dense_offset"]
          and counts["dense_offset"] == len(CLUSTER_DENSE_MS)
          and counts["dense_fft"] == 0 and counts["dense_matrix"] == 0,
          f"dense m={CLUSTER_DENSE_MS}: every launch on the cluster body "
          f"({counts['dense']} + {counts['dense_offset']} offset == "
          f"{counts['dense_cluster']}; FFT-form {counts['dense_fft']}, "
          f"matrix {counts['dense_matrix']})")
    out.update(dense=counts["dense"], dense_offset=counts["dense_offset"],
               dense_cluster=counts["dense_cluster"])
    out.update(dense_times(*timing))
    del timing
    out["long_body"] = dense_long_body()
    return out


def dense_times(plan, x16: torch.Tensor, cfg) -> dict:
    """#1 at plan.m on x16 (48 channel-sectors) in turns with its plain
    version and the matrix kernel (launched past the route: a yardstick,
    not counted), and queued, beside the bound."""
    m, bc = plan.m, x16.shape[0]
    out = torch.empty(bc, m // 2, device="cuda")
    matrix = functools.partial(fullchain._launch_matrix, x16, plan, out, 0, bc,
                               None)
    matrix()
    torch.cuda.synchronize()
    e_m = rel_dev(dense_plain(x16, plan), out)[0]
    check(e_m <= POWER_TOL, f"the matrix kernel at m={m} vs the cluster "
                            f"plain version {e_m:.3e} <= {POWER_TOL}")

    def kernel():
        return fullchain.fused_chain_power_dense(x16, plan)

    t = timed({"plain": lambda: dense_plain(x16, plan), "kernel": kernel,
               "matrix": matrix},
              ("plain", "matrix", "kernel", "kernel", "matrix", "plain"))
    queued = queued_ms(kernel)
    bound_ms, bound_by = bound(bc * chain_flops(m, cfg.n),
                               x16.numel() * 2 + plan.cluster_t.numel() * 4
                               + bc * m // 2 * 4)
    print(f"long rays dense m={m}, {bc} channel-sectors: {t['kernel']:.3f} ms "
          f"({queued:.3f} queued), plain {t['plain']:.3f} ms, the matrix "
          f"kernel {t['matrix']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
          f"{algorithm_note(m, cfg.n, bc)}", flush=True)
    return {"ms": t["kernel"], "queued_ms": queued, "plain_ms": t["plain"],
            "matrix_ms": t["matrix"], "bound_ms": bound_ms,
            "bound_by": bound_by, "m": m}


def dense_long_body() -> dict:
    """#1 at LONG_BODY_M (2 x 23 x 89, the long-ray body's one m) on 2
    sectors of seeded int16 noise: vs its plain version (<= LONG_TOL), one
    launch on the FFT-form body, timed queued beside the bound."""
    m = LONG_BODY_M
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=m)
    plan = fullchain.build_plan(PipelineConstants.build(cfg), "cuda")
    check(plan.radix == 1 and fullchain.chain_route(m) == "long"
          and plan.fft.P == 2 and plan.cluster_t is None,
          f"m={m} takes the dense entries' long-ray body: {plan.fft}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(-8192, 8192, (2 * cfg.num_channels, 2, m, cfg.n),
                      generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int16)
    reset_counts()
    got = fullchain.fused_chain_power_dense(x, plan)
    torch.cuda.synchronize()
    counts = read_counts()
    e, a = rel_dev(dense_plain(x, plan), got)
    check(e <= LONG_TOL and counts["dense_fft"] == counts["dense"] == 1,
          f"#1 m={m} (long-ray body): kernel vs plain rel-L2 {e:.3e} <= "
          f"{LONG_TOL}; {counts['dense_fft']} launch on the FFT-form body")
    queued = queued_ms(lambda: fullchain.fused_chain_power_dense(x, plan), 5)
    bc = x.shape[0]
    bound_ms, bound_by = bound(bc * chain_flops(m, cfg.n),
                               x.numel() * 2 + plan.fft_t.numel() * 4
                               + bc * m // 2 * 4)
    print(f"long rays dense m={m} (long-ray body), {bc} channel-sectors: "
          f"{queued:.3f} ms queued, bound {bound_ms:.3f} ms ({bound_by}); "
          f"{algorithm_note(m, cfg.n, bc)}", flush=True)
    return {"m": m, "rel_l2": e, "max_abs_err": a, "queued_ms": queued,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "channel_sectors": bc}


def cluster_bench(argv, label: str, counter: str) -> int:
    """`bench.run(argv)` on a cluster-body m: the parity gate passes, the
    offset counter equals (warm + timed passes) x steps + 2, and every
    launch of the entry runs on the cluster body, none on the matrix
    kernel.  Returns the offset counter."""
    reset_counts()
    r = bench.run(list(argv))
    counts = read_counts()
    torch.cuda.empty_cache()
    m = argv[list(argv).index("--range-cells") + 1]
    print(f"bench m={m} {label}: " + json.dumps(r), flush=True)
    e0, e1 = r["parity_rel_l2"]
    want = (1 + len(r["timed_runs_s"])) * r["steps"] + 2
    # the gate's unsalted processor launches #3 besides
    others = {k: counts[k] for k in OFFSET_COUNTERS + ("dense_matrix",)
              if k != counter}
    entry = counter.split("_")[0]
    cluster = counts[f"{entry}_cluster"]
    check(e0 < BENCH_GATE[0] and e1 < BENCH_GATE[1] and r["value"] > 0
          and counts[counter] == want and not any(others.values())
          and cluster == counts[entry] + counts[counter],
          f"bench m={m} {label}: parity {e0:.3e}, {e1:.3e} under "
          f"{BENCH_GATE}; {r['value']} sectors/s; {counter} launches "
          f"{counts[counter]} == {want}, no other offset entry, no "
          f"matrix kernel; {cluster} on the cluster body == "
          f"{counts[entry]} + {counts[counter]}")
    return counts[counter]


def long_ray_bench() -> dict:
    """`bench.run` at --range-cells LONG_M (batch 32, 4 repeats), int16
    (#4) and --in-dtype wire (#8), each through `cluster_bench`."""
    return {counter: cluster_bench(list(LONG_BENCH) + extra, label, counter)
            for label, extra, counter in (
                ("i16", [], "radix_offset"),
                ("wire", ["--in-dtype", "wire"], "wire_offset"))}


def long_ray_seq_matrix() -> dict:
    """A world-size-1 pallas-seq step at m = ODD_LEAF_M (the A-stage on
    the cluster body, then #6 on all 2080 rows) from host memory, planar
    int16 and wire bytes (decoded on the card), on two produced sectors: vs
    the pallas processor (the radix entry on the cluster body, <= 1e-5) and
    the oracle (<= PRODUCT_TOL); each step one A-stage launch, on the
    cluster body, and one row-epilogue launch.  Returns the A-stage's and
    the rows' launches."""
    m = ODD_LEAF_M
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=m)
    iqs = [oracle.produce_sector_iq(cfg, SEED, j) for j in range(2)]
    planar = np.stack([planar_i16(iq) for iq in iqs])
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs]).reshape(len(iqs), m, -1)
    zdb_p, zdr_p = (t.cpu().numpy() for t in SectorProcessor(
        cfg, method="pallas", device="cuda")(planar))
    launches = {"astage": 0, "rows": 0}
    for tag, x, wire_input in (("host planar", planar, False),
                               ("wire", wires, True)):
        step = build_sharded_processor(cfg, make_mesh(device="cuda"),
                                       method="pallas-seq",
                                       wire_input=wire_input, device="cuda")
        reset_counts()
        zdb, zdr = (t.cpu().numpy() for t in step(x))
        c = read_counts()
        e = max(rel(zdb_p, zdb), rel(zdr_p, zdr))
        others = {k: v for k, v in c.items()
                  if k not in ("astage", "astage_cluster", "rows")}
        check(e <= 1e-5 and c["astage"] == c["astage_cluster"] == 1
              and c["rows"] == 1 and not any(others.values()),
              f"pallas-seq world 1 at m={m} ({tag}): vs the pallas processor "
              f"{e:.3e} <= 1e-5; A-stage {c['astage']} (cluster body "
              f"{c['astage_cluster']}), row epilogue {c['rows']}, no other")
        for k, iq in enumerate(iqs):
            zdb64, zdr64 = oracle.process_sector(iq, cfg)
            ezdb, ezdr = rel(zdb64, zdb[k]), rel(zdr64, zdr[k])
            check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL,
                  f"pallas-seq m={m} ({tag}) sector {k} vs fp64 oracle: zdb "
                  f"{ezdb:.3e}, zdr {ezdr:.3e}")
        launches["astage"] += c["astage"]
        launches["rows"] += c["rows"]
    return launches


def long_ray_seq_and_mxu(cfg, iqs) -> dict:
    """At m = LONG_M on the oracle's sectors: a world-size-1 pallas-seq step
    (#5 on the cluster body, then #6 on all m/2 rows) vs the pallas
    processor (<= 1e-5) and the oracle; #9 on the mxu method's range-stage
    Y [.., 1024, 512] vs that method's own power (<= POWER_TOL), its
    products vs the oracle.  Then the pallas-seq step at ODD_LEAF_M
    (`long_ray_seq_matrix`)."""
    planar = torch.from_numpy(np.stack([planar_i16(iq) for iq in iqs])).cuda()
    zdb_p, zdr_p = (t.cpu().numpy() for t in SectorProcessor(
        cfg, method="pallas", device="cuda")(planar))
    step = build_sharded_processor(cfg, make_mesh(device="cuda"),
                                   method="pallas-seq", device="cuda")
    reset_counts()
    zdb, zdr = (t.cpu().numpy() for t in step(planar))
    seq = read_counts()
    e = max(rel(zdb_p, zdb), rel(zdr_p, zdr))
    check(e <= 1e-5 and seq["astage"] == seq["astage_cluster"] == 1
          and seq["rows"] == 1 and seq["rows_two_pass"] == 0,
          f"pallas-seq world 1 at m={cfg.m}: vs the pallas processor {e:.3e} "
          f"<= 1e-5; A-stage {seq['astage']} (cluster body "
          f"{seq['astage_cluster']}), row epilogue {seq['rows']} (register "
          f"form)")
    consts = PipelineConstants.build(cfg)
    dc = _DeviceConstants(consts, torch.device("cuda"))
    mh, n = cfg.m // 2, cfg.n
    xr, xi = planar.float()[:, :, 0], planar.float()[:, :, 1]
    ys = _rmatmul(dc.ar, dc.ai, xr, xi)         # the mxu method's range stage
    want = channel_power_planar(xr, xi, dc, "mxu", "direct").reshape(-1, mh)
    reset_counts()
    pw = postprocess.fused_stage2(*(y.reshape(-1, mh, n).contiguous()
                                    for y in ys), dc.br, dc.bi, consts.ma_taps)
    torch.cuda.synchronize()
    mxu = read_counts()
    e = rel_dev(want, pw)[0]
    check(e <= POWER_TOL and mxu["stage2"] == 1,
          f"#9 on the mxu method's Y at m={cfg.m}: vs the mxu power rel-L2 "
          f"{e:.3e} <= {POWER_TOL}; {mxu['stage2']} launch")
    pw = pw.reshape(len(iqs), cfg.num_channels, mh)
    zdb_m, zdr_m = (t.cpu().numpy() for t in stage09_10_products(
        pw[:, 0], pw[:, 1], torch.from_numpy(consts.gain).cuda()))
    for k, iq in enumerate(iqs):
        zdb64, zdr64 = oracle.process_sector(iq, cfg)
        for what, a, b in (("pallas-seq", zdb, zdr), ("mxu", zdb_m, zdr_m)):
            ezdb, ezdr = rel(zdb64, a[k]), rel(zdr64, b[k])
            check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL,
                  f"{what} m={cfg.m} sector {k} vs fp64 oracle: zdb "
                  f"{ezdb:.3e}, zdr {ezdr:.3e}")
    above = long_ray_seq_matrix()
    return {"astage": seq["astage"] + above["astage"],
            "rows": seq["rows"] + above["rows"], "stage2": mxu["stage2"]}


def oracle_products(orc: Oracle, key, iq, cfg):
    """The fp64 oracle's (zdb, zdr) of one sector, from its cached power."""
    pow64 = orc.power(key, iq, cfg)
    return oracle.stage09_10_products(pow64[0], pow64[1], cfg)


def long_ray_inputs(orc: Oracle, pool) -> dict:
    """{m: (cfg, constants, two noise sectors)} at each m of CLUSTER16_MS
    and MATRIX_REFUSED_M (seeds SEED, SEED + 1), all made in the threads of
    `pool`, with the sectors' fp64 oracle powers (at CLUSTER16_MS also
    those of the sectors salted by 7 (1 + i), #4's) queued there behind
    them (`Oracle.prefetch`): the host's set-up and oracle run beside the
    card's work.  Returns futures where the work is not done."""
    out = {}
    for m in CLUSTER16_MS + (MATRIX_REFUSED_M,):
        cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=m)
        out[m] = (cfg, pool.submit(PipelineConstants.build, cfg),
                  [pool.submit(oracle.synthetic_iq, cfg, kind="noise",
                               seed=SEED + b) for b in range(2)])
    for m, (cfg, _, iqs) in out.items():
        for k, iq in enumerate(iqs):
            for label, salt in (("noise", 0), ("salted", 7)):
                if salt and m not in CLUSTER16_MS:
                    continue
                orc.prefetch((m, cfg.n, label, k), pool.submit(
                    lambda iq=iq, salt=salt, cfg=cfg: oracle.channel_power(
                        iq.result() + salt * (1 + 1j), cfg)))
    return out


def cluster16_path(cfg, consts, iqs, orc: Oracle) -> dict:
    """The slice's main path at m = cfg.m on the cluster of 16, from host
    memory on the noise sectors `iqs`, each run between a reset and a read
    of the counts: the pallas processor (#3), the fused wire processor on
    the sectors' wire bytes viewed as int32 words (#7), a world-size-1
    pallas-seq step (#5 then #6) and, at CLUSTER16_BENCH's m, the bench
    int16 and wire (#4 and #8, offsets and salts, its parity gate;
    `cluster_bench`).  Every launch on the cluster body, none on a matrix
    route; the products within PRODUCT_TOL of the oracle, the fused wire
    and pallas-seq within 1e-5 of pallas.  Returns {"radix",
    "radix_offset", "wire", "wire_offset", "astage", "rows": launches}."""
    m, n = cfg.m, cfg.n
    planar = np.stack([planar_i16(iq) for iq in iqs])
    words = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), "<i4")
                      for iq in iqs])
    reset_counts()
    zdb_p, zdr_p = (t.cpu().numpy() for t in SectorProcessor(
        cfg, method="pallas", device="cuda", consts=consts)(planar))
    c = read_counts()
    others = {k: v for k, v in c.items() if k not in ("radix", "radix_cluster")}
    check(c["radix"] == c["radix_cluster"] == 1 and not any(others.values()),
          f"pallas processor at m={m} (cluster of 16): #3 {c['radix']}, on "
          f"the cluster body {c['radix_cluster']}, no other: "
          f"{json.dumps(others)}")
    out = {"radix": c["radix"], "radix_offset": 0, "wire_offset": 0}
    fused = SectorProcessor(cfg, method="pallas", device="cuda",
                            consts=consts, wire_input=True,
                            wire_decode="fused")
    reset_counts()
    zdb_w, zdr_w = (t.cpu().numpy() for t in fused(words))
    c = read_counts()
    e = max(rel(zdb_p, zdb_w), rel(zdr_p, zdr_w))
    others = {k: v for k, v in c.items() if k not in ("wire", "wire_cluster")}
    check(e <= 1e-5 and c["wire"] == c["wire_cluster"] == 1
          and not any(others.values()),
          f"fused wire processor at m={m} (cluster of 16): vs the pallas "
          f"processor {e:.3e} <= 1e-5; #7 {c['wire']}, on the cluster body "
          f"{c['wire_cluster']}, no other: {json.dumps(others)}")
    out["wire"] = c["wire"]
    del fused
    step = build_sharded_processor(cfg, make_mesh(device="cuda"),
                                   method="pallas-seq", device="cuda",
                                   consts=consts)
    reset_counts()
    zdb, zdr = (t.cpu().numpy() for t in step(planar))
    c = read_counts()
    e = max(rel(zdb_p, zdb), rel(zdr_p, zdr))
    others = {k: v for k, v in c.items()
              if k not in ("astage", "astage_cluster", "rows")}
    check(e <= 1e-5 and c["astage"] == c["astage_cluster"] == 1
          and c["rows"] == 1 and not any(others.values()),
          f"pallas-seq world 1 at m={m} (cluster of 16): vs the pallas "
          f"processor {e:.3e} <= 1e-5; A-stage {c['astage']} (cluster body "
          f"{c['astage_cluster']}), row epilogue {c['rows']}, no other")
    out["astage"], out["rows"] = c["astage"], c["rows"]
    for k, iq in enumerate(iqs):
        zdb64, zdr64 = oracle_products(orc, (m, n, "noise", k), iq, cfg)
        for what, a, b in (("pallas", zdb_p, zdr_p),
                           ("fused wire", zdb_w, zdr_w),
                           ("pallas-seq", zdb, zdr)):
            ezdb, ezdr = rel(zdb64, a[k]), rel(zdr64, b[k])
            check(ezdb <= PRODUCT_TOL and ezdr <= PRODUCT_TOL,
                  f"{what} m={m} sector {k} vs fp64 oracle: zdb {ezdb:.3e}, "
                  f"zdr {ezdr:.3e}")
    if str(m) == CLUSTER16_BENCH[1]:
        out["radix_offset"] = cluster_bench(CLUSTER16_BENCH, "i16",
                                            "radix_offset")
        out["wire_offset"] = cluster_bench(
            CLUSTER16_BENCH + ("--in-dtype", "wire"), "wire", "wire_offset")
    return out


def cluster16_checks(cfg, consts, plan, iqs, orc: Oracle) -> dict:
    """#3 (int16, f32), #4 (offset 6 of a two-slab staging, salt 7), #7
    (the sectors' int16 wire words), #8 (offset 1 of that two-sector
    staging, salt 7) and #5 (int16 and f32 at w = n, then #6 on its Y;
    int16 at n/4) at m = cfg.m on the cluster of 16, on the noise sectors
    `iqs` (6 channel-sectors): each vs its plain version (<= LONG_TOL) and
    the oracle (#4 and #8 the salted sectors'; the w = n/4 slab's Y the
    float64 FFT of its windowed columns), every launch on the cluster
    body.  Returns {kernel: {rel_l2, max_abs_err}}."""
    m, n, ch = cfg.m, cfg.n, cfg.num_channels
    gain = torch.from_numpy(consts.gain).cuda()
    x = torch.from_numpy(np.stack([planar_i16(iq) for iq in iqs])).cuda()
    x = x.reshape(-1, 2, m, n)
    bc = x.shape[0]
    res = {k: {"rel_l2": 0.0, "max_abs_err": 0.0}
           for k in ("radix", "radix_offset", "wire", "wire_offset", "astage")}

    def hold(key, what, ref, got):
        torch.cuda.synchronize()
        e, a = rel_dev(ref, got)
        check(e <= LONG_TOL, f"{what}: kernel vs plain rel-L2 {e:.3e} <= "
                             f"{LONG_TOL}")
        res[key]["rel_l2"] = max(res[key]["rel_l2"], e)
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], a)

    def vs_oracle(what, pw, label, salt=0, first=0):
        p = pw.reshape(-1, ch, m // 2).cpu().numpy()
        for k, iq in enumerate(iqs[first:first + len(p)], first):
            check_vs_oracle(f"{what} sector {k}", p[k - first], orc.power(
                (m, n, label, k), iq + salt * (1 + 1j), cfg), cfg, gain)

    reset_counts()
    for xx in (x, x.float()):
        got = fullchain.fused_chain_power_radix(xx, plan)
        hold("radix", f"#3 m={m} {xx.dtype} (cluster of 16)",
             fullchain.cluster_chain_power_reference(xx, plan), got)
        vs_oracle(f"#3 m={m} {xx.dtype}", got, "noise")
    x_all = torch.cat([x, x])
    got = fullchain.fused_chain_power_radix(x_all, plan, offset=bc, bc=bc,
                                            salt=7)
    hold("radix_offset", f"#4 m={m} offset {bc} salt 7 (cluster of 16)",
         fullchain.cluster_chain_power_reference(x, plan, 7), got)
    vs_oracle(f"#4 m={m} salt 7", got, "salted", 7)
    w32 = wire_words_on_card(x, cfg)
    got = fullchain.fused_chain_power_wire(w32, plan, ch)
    hold("wire", f"#7 m={m} (cluster of 16)",
         fullchain.fused_chain_power_wire_reference(w32, plan, ch), got)
    vs_oracle(f"#7 m={m}", got, "noise")
    got = fullchain.fused_chain_power_wire(w32, plan, ch, offset=1, bs=1,
                                           salt=7)
    hold("wire_offset", f"#8 m={m} offset 1 salt 7 (cluster of 16)",
         fullchain.fused_chain_power_wire_reference(w32[1:], plan, ch, 7),
         got)
    vs_oracle(f"#8 m={m} salt 7", got, "salted", 7, first=1)
    for xx in (x, x.float()):
        y = fullchain.fused_chain_astage(xx, plan)
        hold("astage", f"#5 m={m} {xx.dtype} w={n} (cluster of 16)",
             fullchain.fused_chain_astage_reference(xx, plan), y)
        vs_oracle(f"#5 + #6 m={m} {xx.dtype}",
                  fullchain.parseval_rows_power(y, plan), "noise")
    xs = x[..., :n // 4].contiguous()
    y = fullchain.fused_chain_astage(xs, plan)
    hold("astage", f"#5 m={m} int16 w={n // 4} (cluster of 16)",
         fullchain.fused_chain_astage_reference(xs, plan), y)
    wr, _, c = hamming_factors(cfg)
    z = (torch.complex(xs[:, 0].double(), xs[:, 1].double())
         * torch.from_numpy(wr * c).cuda()[:, None])
    z = torch.fft.fft(z, dim=1)[:, :m // 2]
    e = rel_dev(torch.stack([z.real, z.imag], 1), y)[0]
    check(e <= LONG_TOL, f"#5 m={m} w={n // 4}: Y vs the float64 FFT of the "
                         f"windowed slab {e:.3e} <= {LONG_TOL}")
    cnt = read_counts()
    others = {k: v for k, v in cnt.items() if k not in (
        "radix", "radix_offset", "radix_cluster", "wire", "wire_offset",
        "wire_cluster", "astage", "astage_cluster", "rows")}
    check(cnt["radix"] == 2 and cnt["radix_offset"] == 1
          and cnt["radix_cluster"] == 3
          and cnt["wire"] == cnt["wire_offset"] == 1
          and cnt["wire_cluster"] == 2
          and cnt["astage"] == cnt["astage_cluster"] == 3
          and cnt["rows"] == 2 and not any(others.values()),
          f"m={m} checks: #3 {cnt['radix']} + #4 {cnt['radix_offset']} on "
          f"the cluster body {cnt['radix_cluster']}, #7 {cnt['wire']} + #8 "
          f"{cnt['wire_offset']} on the cluster body {cnt['wire_cluster']}, "
          f"#5 {cnt['astage']} (cluster body {cnt['astage_cluster']}), #6 "
          f"{cnt['rows']}, none on a matrix route: {json.dumps(others)}")
    del x, x_all, xs, z, y, w32
    return res


def long_ray_cluster16(orc: Oracle, gen, spills, inputs) -> dict:
    """The cluster of 16 at each m of CLUSTER16_MS: its kernels' ptxas
    (`spills`: the cluster kernels with a spill; none of S = 16 may; the
    three P = 1 kernels, #3/#4's, #7/#8's and #5's, built), the clusters
    of 16 the card holds for each S = 16 kernel of #3/#4, #7/#8 and #5 (at
    CLUSTER16_KERNEL_MS), the cut and the occupancy at each m; the main
    path (`cluster16_path`, at CLUSTER16_PATH_MS), the checks
    (`cluster16_checks`), each on the two noise sectors of `inputs`, as
    `long_ray_inputs` makes them, and at CLUSTER16_TIMED_MS the times of
    #3 (int16, f32 queued), #4, #7, #8 and #5 (beside cuFFT) on 6
    channel-sectors in turns with their plain versions
    (`long_ray_times`).  Returns {"launches", "res", "times", "occ",
    "resident"}."""
    s16 = [k for k in spills if re.search(
        r"cluster_chain16_kernel|cluster_leaf_kernel<[^,]+, 16,", k)]
    check(not s16, f"ptxas: no kernel of the cluster of 16 spills: "
                   f"{json.dumps(s16)}")
    rep = kernel_ab.ptxas_report(_build.library_path().with_suffix(".log")
                                 .read_text(), Path(_build._nvcc()).parent)
    p1 = {k: v for k, v in rep.items()
          if re.search(r"cluster_leaf_kernel<[^,]+, 16, 1, 1,", k)}
    check(len(p1) == 3, f"ptxas: the cluster of 16's P = 1 kernels, #3/#4's, "
                        f"#7/#8's and #5's: {json.dumps(p1)}")
    wire16 = {k: v for k, v in rep.items() if re.search(
        r"cluster_(chain16_kernel<wrp::fft::WireIq|leaf_kernel<wrp::fft::"
        r"WireIq, 16,)", k)}
    print(f"ptxas: the wire chain's kernels at S = 16: "
          f"{json.dumps(wire16)}", flush=True)
    check(len(wire16) == 10, f"ptxas: the wire chain's ten kernels at S = "
                             f"16 (kWide16 5, kP2S16 2, kP8S16 2, kP1S16 "
                             f"1): {len(wire16)}")
    resident = {m: {body: fullchain.cluster_occupancy(m, DEFAULT_CONFIG.n, body)
                    ["clusters"] for body in ("radix", "wire", "astage")}
                for m in CLUSTER16_KERNEL_MS}
    check(all(v > 0 for r in resident.values() for v in r.values()),
          f"clusters of 16 the card holds at once, by the m of each S = 16 "
          f"kernel (#3/#4's and #7/#8's at no staging, #5's with f32 "
          f"staged): {json.dumps(resident)}")
    keys = ("radix", "radix_offset", "wire", "wire_offset", "astage")
    out = {"launches": dict.fromkeys(keys + ("rows",), 0),
           "res": {k: {"rel_l2": 0.0, "max_abs_err": 0.0} for k in keys},
           "times": {}, "occ": {}, "resident": resident}
    for m in CLUSTER16_MS:
        t0 = time.perf_counter()
        cfg, consts, iqs = inputs[m]
        consts, iqs = consts.result(), [iq.result() for iq in iqs]
        plan = fullchain.build_plan(consts, "cuda")
        setup_s = time.perf_counter() - t0
        occ = {body: fullchain.fft_occupancy(plan, body)
               for body in ("radix", "wire", "astage")}
        g = plan.cluster
        print(f"cluster of 16 at m={m} (constants and plan {setup_s:.1f} s):"
              f" {cluster_note(m, cfg.n)}; resident clusters of 16 "
              f"{json.dumps(occ)}", flush=True)
        check(plan.radix > 1 and g.S == 16
              and fullchain.chain_route(m) == "cluster"
              and plan.fft_t is None and plan.host_a_half is None
              and all(v["blocks_per_sm"] >= 1 and v["clusters"] > 0
                      for v in occ.values()),
              f"m={m} takes the cluster of 16 for #3/#4, #7/#8 and #5 (no "
              f"host A_half), resident: {json.dumps(occ)}")
        out["occ"][m] = occ
        if m in CLUSTER16_PATH_MS:
            for key, v in cluster16_path(cfg, consts, iqs, orc).items():
                out["launches"][key] += v
        for key, r in cluster16_checks(cfg, consts, plan, iqs, orc).items():
            for k in ("rel_l2", "max_abs_err"):
                out["res"][key][k] = max(out["res"][key][k], r[k])
        if m in CLUSTER16_TIMED_MS:
            out["times"][m] = long_ray_times(
                gen, m, ("radix", "radix_f32", "radix_offset", "wire",
                         "wire_offset", "astage"), 2, True, plan)
        del plan
        torch.cuda.empty_cache()
    return out


def long_ray_matrix(orc: Oracle, inputs) -> dict:
    """The matrix routes left above 8192, at m = MATRIX_REFUSED_M (16 x
    521, radix 2, which the cluster body refuses: the leaf prime 521 needs
    a Bluestein length of 2048) on two noise sectors (6 channel-sectors)
    of `long_ray_inputs`: one checking call each of the radix entry on the
    matrix kernel (the dense A_half, built at first use) int16, and with
    offset and salt 7, vs fused_chain_power_reference (<= POWER_TOL) and
    the oracle, each check's launch counts equal to its calls, of #5's
    matrix route (`matrix_astage`) and of the wire chain's
    (`matrix_wire`), none timed.  Returns {"radix", "radix_offset",
    "astage", "wire", "wire_offset": each matrix route's launches and
    errors, "counts": the radix checks' launches}."""
    m = MATRIX_REFUSED_M
    cfg, consts, sectors = inputs[m]
    consts, sectors = consts.result(), [iq.result() for iq in sectors]
    plan = fullchain.build_plan(consts, "cuda")
    check(plan.radix == 2 and fullchain.chain_route(m) == "matrix"
          and plan.fft_t is None and plan.cluster_t is None
          and plan.host_a_half is not None,
          f"m={m}: radix {plan.radix}, {fullchain.cluster_refusal(m)}: the "
          f"radix entry on the matrix kernel (tile "
          f"{fullchain.dense_tile(plan)})")
    gain = torch.from_numpy(consts.gain).cuda()
    ch, n = cfg.num_channels, cfg.n
    x = torch.from_numpy(np.stack([planar_i16(s) for s in sectors])).cuda()
    x = x.reshape(-1, 2, m, n)
    res = {k: {"m": m, "rel_l2": 0.0, "max_abs_err": 0.0}
           for k in ("radix", "radix_offset")}
    reset_counts()
    got = fullchain.fused_chain_power_radix(x, plan)
    torch.cuda.synchronize()
    e, a = rel_dev(fullchain.fused_chain_power_reference(x, plan), got)
    check(e <= POWER_TOL, f"radix m={m} int16 (matrix route): kernel vs "
                          f"plain rel-L2 {e:.3e} <= {POWER_TOL}")
    res["radix"].update(rel_l2=e, max_abs_err=a)
    p = got.reshape(len(sectors), ch, m // 2).cpu().numpy()
    for k, iq in enumerate(sectors):
        check_vs_oracle(f"radix m={m} int16 (matrix route) sector {k}", p[k],
                        orc.power((m, n, "noise", k), iq, cfg), cfg, gain)
    got = fullchain.fused_chain_power_radix(x, plan, offset=ch, bc=ch, salt=7)
    torch.cuda.synchronize()
    e, a = rel_dev(fullchain.fused_chain_power_reference(x[ch:], plan, 7), got)
    counts = read_counts()
    check(e <= POWER_TOL and counts["dense_matrix"] == counts["radix"]
          + counts["radix_offset"] == 2 and counts["dense_fft"] == 0
          and counts["radix_cluster"] == 0,
          f"radix m={m} offset {ch} salt 7 on the matrix kernel vs plain "
          f"{e:.3e} <= {POWER_TOL}; matrix launches {counts['dense_matrix']}"
          f" == radix {counts['radix']} + offset {counts['radix_offset']}, "
          f"none on the cluster body")
    res["radix_offset"].update(rel_l2=e, max_abs_err=a)
    res["radix"]["launches"] = counts["radix"]
    res["radix_offset"]["launches"] = counts["radix_offset"]
    print(f"radix m={m} on the matrix kernel, {x.shape[0]} channel-sectors: "
          f"checked, not timed; "
          f"{algorithm_note(m, n, x.shape[0])}", flush=True)
    res.update(matrix_astage(orc, cfg, consts, plan, sectors, x))
    res.update(matrix_wire(orc, cfg, consts, plan, sectors, x))
    res["counts"] = counts
    return res


def matrix_astage(orc: Oracle, cfg, consts, plan, sectors, x) -> dict:
    """The A-stage's matrix route (#5, csrc/fused_chain_astage_matrix.cu)
    at m = cfg.m on the two noise sectors of `long_ray_matrix` (planar
    int16 x, 6 channel-sectors): one checking call, vs its plain version
    (Y <= LONG_TOL), then #6 on its Y vs the matrix form's power (<=
    POWER_TOL) and the oracle; one launch of each, the A-stage's on the
    matrix route; not timed (a call takes ~280 ms).  Returns {"astage":
    launches and errors}."""
    m = cfg.m
    tile = fullchain.astage_tile(plan)
    check(tile == 4, f"m={m}: the matrix A-stage's tile {tile} (T = 8 "
                     f"needs {2 * 8 * (m // plan.radix) * 4} bytes)")
    gain = torch.from_numpy(consts.gain).cuda()
    ch, n = cfg.num_channels, cfg.n
    res = {"astage": {"m": m}}
    reset_counts()
    y = fullchain.fused_chain_astage(x, plan)
    torch.cuda.synchronize()
    e, a = rel_dev(fullchain.fused_chain_astage_reference(x, plan), y)
    check(e <= LONG_TOL, f"#5 m={m} {x.dtype} (matrix route): kernel vs "
                         f"plain rel-L2 {e:.3e} <= {LONG_TOL}")
    res["astage"].update(rel_l2=e, max_abs_err=a)
    pw = fullchain.parseval_rows_power(y, plan)
    torch.cuda.synchronize()
    e = rel_dev(fullchain.fused_chain_power_reference(x, plan), pw)[0]
    check(e <= POWER_TOL, f"#6 on the matrix A-stage's Y at m={m} "
                          f"{x.dtype}: vs the matrix form's power "
                          f"{e:.3e} <= {POWER_TOL}")
    p = pw.reshape(len(sectors), ch, m // 2).cpu().numpy()
    for k, iq in enumerate(sectors):
        check_vs_oracle(f"#5 + #6 m={m} {x.dtype} sector {k}", p[k],
                        orc.power((m, n, "noise", k), iq, cfg), cfg, gain)
    mc = read_counts()
    others = {k: v for k, v in mc.items()
              if k not in ("astage", "astage_matrix", "rows")}
    check(mc["astage"] == mc["astage_matrix"] == 1 and mc["rows"] == 1
          and not any(others.values()),
          f"m={m} matrix A-stage: {mc['astage']} (matrix "
          f"{mc['astage_matrix']}) == 1, rows {mc['rows']} == 1, no other: "
          f"{json.dumps(others)}")
    res["astage"]["launches"] = mc["astage_matrix"]
    del y, pw
    torch.cuda.empty_cache()
    return res


def matrix_wire(orc: Oracle, cfg, consts, plan, sectors, x) -> dict:
    """The wire chain's matrix route (the matrix kernel's wire source,
    csrc/fused_chain_dense.cu) at m = cfg.m, which the cluster body
    refuses, on the noise sectors `sectors` of `long_ray_matrix` (planar
    int16 x, 6 channel-sectors): one checking call each of #7 and of #8 at
    offset 1 of that two-sector staging, salt 7, vs their plain versions
    (fused_chain_power_reference on the decoded words: the route's,
    fused_chain_power_wire_reference; <= POWER_TOL), #7
    also vs the oracle; one launch each, both on the matrix kernel; not
    timed.  Returns {"wire", "wire_offset": launches and errors}."""
    m = cfg.m
    gain = torch.from_numpy(consts.gain).cuda()
    ch, n = cfg.num_channels, cfg.n
    res = {k: {"m": m, "rel_l2": 0.0, "max_abs_err": 0.0}
           for k in ("wire", "wire_offset")}

    def hold(key, what, ref, out):
        torch.cuda.synchronize()
        e, a = rel_dev(ref, out)
        check(e <= POWER_TOL, f"{what}: kernel vs plain rel-L2 {e:.3e} <= "
                              f"{POWER_TOL}")
        res[key].update(rel_l2=e, max_abs_err=a)

    reset_counts()
    w32 = wire_words_on_card(x, cfg)
    got = fullchain.fused_chain_power_wire(w32, plan, ch)
    hold("wire", f"#7 m={m} (matrix route)",
         fullchain.fused_chain_power_wire_reference(w32, plan, ch), got)
    p = got.reshape(len(sectors), ch, m // 2).cpu().numpy()
    for k, iq in enumerate(sectors):
        check_vs_oracle(f"#7 m={m} sector {k}", p[k],
                        orc.power((m, n, "noise", k), iq, cfg), cfg, gain)
    got = fullchain.fused_chain_power_wire(w32, plan, ch, offset=1, bs=1,
                                           salt=7)
    hold("wire_offset", f"#8 m={m} offset 1 salt 7 (matrix route)",
         fullchain.fused_chain_power_wire_reference(w32[1:], plan, ch, 7),
         got)
    mc = read_counts()
    others = {k: v for k, v in mc.items()
              if k not in ("wire", "wire_offset", "dense_matrix")}
    check(mc["wire"] == 1 and mc["wire_offset"] == 1
          and mc["dense_matrix"] == 2 and not any(others.values()),
          f"m={m} the wire's matrix route: wire {mc['wire']} + offset "
          f"{mc['wire_offset']} == matrix kernel {mc['dense_matrix']} == 2, "
          f"none on the cluster body: {json.dumps(others)}")
    res["wire"]["launches"] = mc["wire"]
    res["wire_offset"]["launches"] = mc["wire_offset"]
    print(f"wire m={m} on the matrix kernel's wire source, {x.shape[0]} "
          f"channel-sectors: #7 and #8 checked, not timed", flush=True)
    del w32
    torch.cuda.empty_cache()
    return res


def phase_long_rays(orc: Oracle) -> dict:
    """Rays longer than 1024 cells: the executor at m = LONG_M with host
    and device decode, each cluster-body kernel (#3, #4, #5, #7, #8) vs its
    plain version and its times at every m of CLUSTER_CHECK_MS (48
    channel-sectors; 6 at ODD_LEAF_M and BLUESTEIN_M, there #3, #5, #7
    only; #5 beside cuFFT), the dense entries at CLUSTER_DENSE_MS (the
    cluster body) and LONG_BODY_M (the long-ray body), the bench at LONG_M
    (i16, wire), a world-size-1 pallas-seq step and the mxu method at
    LONG_M and a pallas-seq step at ODD_LEAF_M, the cluster of 16 at
    CLUSTER16_MS (`long_ray_cluster16`), and the matrix routes left above
    8192 (`long_ray_matrix`).  Returns each kernel's launches on the
    slice's paths (`long_ray_launches`), its results, its times by m, the
    cluster of 16's and the matrix routes' results."""
    t0 = time.perf_counter()
    print_ptxas(r"fft_chain_long_kernel")
    spills = print_ptxas(r"cluster_(chain|chain16|leaf)_kernel")
    print(f"ptxas: cluster kernels with a spill: {json.dumps(spills)}",
          flush=True)
    cfg = dataclasses.replace(DEFAULT_CONFIG, num_range_cells=LONG_M)
    iqs = [oracle.produce_sector_iq(cfg, SEED, j) for j in range(4)]
    wires = [codec.encode_iq(iq, cfg) for iq in iqs]
    launches = dict.fromkeys(("radix", "wire", "dense", "dense_offset",
                              "radix_offset", "wire_offset", "astage", "rows",
                              "stage2"), 0)
    launches.update(long_ray_executor(cfg, iqs, wires))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t_checks = time.perf_counter()
    res = long_ray_kernels(gen)
    t_checks = time.perf_counter() - t_checks
    t_times = time.perf_counter()
    # every kernel in turns with its plain version at m = LONG_M and 4096
    # (the kernels line's); elsewhere #3 (int16, f32), #7 and #5 beside
    # cuFFT, queued (tools/kernel_ab.py --long times #4 at every m)
    by_m = {m: long_ray_times(gen, m, None if m in (LONG_M, 4096) else (
        "radix", "wire", "astage") + (("radix_f32",) if m != BLUESTEIN_M else ()),
        2 if m in (ODD_LEAF_M, BLUESTEIN_M) else BATCH, m in (LONG_M, 4096))
            for m in CLUSTER_CHECK_MS}
    for key, t in by_m[LONG_M].items():
        if key in res:
            res[key].update(t)
    t_times = time.perf_counter() - t_times
    dense = long_ray_dense(orc)
    launches["dense"], launches["dense_offset"] = (dense["dense"],
                                                   dense["dense_offset"])
    launches.update(long_ray_bench())
    t_seq = time.perf_counter()
    launches.update(long_ray_seq_and_mxu(cfg, iqs))
    t_seq = time.perf_counter() - t_seq
    with ThreadPoolExecutor(4) as pool:
        inputs = long_ray_inputs(orc, pool)
        t_c16 = time.perf_counter()
        c16 = long_ray_cluster16(orc, gen, spills, inputs)
        t_c16 = time.perf_counter() - t_c16
        t_matrix = time.perf_counter()
        matrix = long_ray_matrix(orc, inputs)
        t_matrix = time.perf_counter() - t_matrix
    print(f"long rays: launches {json.dumps(launches)}; cluster of 16 "
          f"{json.dumps(c16['launches'])}; radix matrix route "
          f"{matrix['counts']['dense_matrix']}; phase "
          f"{time.perf_counter() - t0:.1f} s (checks {t_checks:.1f} s, times "
          f"{t_times:.1f} s, pallas-seq and mxu {t_seq:.1f} s, the cluster "
          f"of 16 {t_c16:.1f} s, matrix routes at m={MATRIX_REFUSED_M} "
          f"{t_matrix:.1f} s)", flush=True)
    keys = ("radix", "radix_f32", "radix_offset", "wire", "wire_offset",
            "astage")
    times = {key: {str(m): t[key] for m, t in by_m.items() if key in t}
             for key in keys}
    return {"launches": launches, "res": res, "dense": dense,
            "at_4096": by_m[4096], "times": times, "matrix": matrix,
            "cluster16": c16}


def offset_entry_checks(name, units, count, call, on_slab, plain, zdb_of,
                        salts, tol) -> dict:
    """One offset entry on a staged array of `units` holding two slabs of
    `count`: call(offset, salt) is the entry, on_slab(offset) the plain
    entry's kernel on a contiguous copy of the slab, plain(offset, salt) the
    plain torch version, zdb_of(pow) the products' zdb.  Each slab:
    bit-identical to on_slab; with salts, salt 0 bit-identical to unsalted,
    each salt vs plain <= tol and its zdb within the bench's salted gate of
    the unsalted zdb.  An offset outside the array raises.  Times the entry
    (salted where it salts), unsalted, and plain on slab 1."""
    worst = max_abs = 0.0
    for off in (0, count):
        got = call(off, None)
        torch.cuda.synchronize()
        check(torch.equal(got, on_slab(off)),
              f"{name} offset {off}: bit-identical to the plain entry's kernel "
              "on a copy of the slab")
        for salt in salts:
            g = call(off, salt)
            torch.cuda.synchronize()
            if salt == 0:
                check(torch.equal(g, got),
                      f"{name} offset {off} salt 0: bit-identical to unsalted")
                continue
            e, a = rel_dev(plain(off, salt), g)
            ez = rel(zdb_of(got), zdb_of(g))
            worst, max_abs = max(worst, e), max(max_abs, a)
            # the gate holds the salt's cancellation residual at its own
            # salt; a larger salt leaves a larger one (the pulse window makes
            # the cancellation inexact), printed
            gated = salt == BENCH_SALTS[0]
            check(e <= tol and (ez < BENCH_GATE[1] or not gated),
                  f"{name} offset {off} salt {salt}: vs plain salted rel-L2 "
                  f"{e:.3e} <= {tol} (max abs {a:.3e}); zdb vs unsalted "
                  f"{ez:.3e}" + (f" < {BENCH_GATE[1]}" if gated else ""))
        if not salts:
            e, a = rel_dev(plain(off, None), got)
            worst, max_abs = max(worst, e), max(max_abs, a)
            check(e <= tol, f"{name} offset {off}: vs plain rel-L2 {e:.3e} <= "
                            f"{tol} (max abs {a:.3e})")
    for bad in (count + 1, -1):
        try:
            call(bad, None)
            raised = False
        except ValueError:
            raised = True
        check(raised, f"{name}: offset {bad} (slab past the {units} staged "
                      "units) raises")
    salt = salts[-1] if salts else None
    t = timed({"plain": lambda: plain(count, salt),
               "kernel": lambda: call(count, salt),
               "unsalted": lambda: call(count, None)},
              ("plain", "kernel", "unsalted", "unsalted", "kernel", "plain"))
    print(f"{name}: offset entry {t['kernel']:.3f} ms (salt {salt}), "
          f"unsalted {t['unsalted']:.3f} ms, plain {t['plain']:.3f} ms",
          flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst, "ms": t["kernel"],
            "plain_ms": t["plain"], "unsalted_ms": t["unsalted"]}


def wire_words_on_card(x: torch.Tensor, cfg) -> torch.Tensor:
    """Planar int16 [S*C, 2, m, n] on the card -> the wire's int32 words
    [S, m, C*n]: the bench's `_wire_bytes` (interleaved big-endian int16,
    io/codec.encode_iq's layout) made on the card, then
    `device_codec.wire_words_i32`."""
    c, m, n = cfg.sector_shape
    s = x.shape[0] // c
    le = x.reshape(s, c, 2, m, n).permute(0, 3, 4, 1, 2).contiguous()
    be = le.view(torch.uint8).reshape(*le.shape, 2).flip(-1).contiguous()
    return device_codec.wire_words_i32(be.reshape(s, -1), cfg).contiguous()


def bench_slabs(cfg, seed: int) -> torch.Tensor:
    """Two slabs at the bench's batch, staged as the bench stages them,
    [2 * BENCH_BATCH * C, 2, m, n] int16 on the card: seeded uniform noise
    in the bench's range (made on the card), then the clip-bin sector
    tiled."""
    c, m, n = cfg.sector_shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randint(-8192, 8192, (BENCH_BATCH * c, 2, m, n),
                          generator=g, dtype=torch.int16, device="cuda")
    clip = torch.from_numpy(planar_i16(adversarial_sector(cfg))).cuda()
    return torch.cat([noise, clip.repeat(BENCH_BATCH, 1, 1, 1)])


def offset_checks(batch, x_all, d_all, plan, dplan, gain, dgain) -> dict:
    """The offset entries on two staged slabs of `batch` sectors: radix
    (int16, and f32 at batch 16) and wire with salts, the wire words being
    x_all's own, and dense (d_all, m = 1000: the FFT-form body, held
    against its plain version at KERNEL_TOL) without."""
    cfg = DEFAULT_CONFIG
    ch, n = cfg.num_channels, cfg.n
    bc = batch * ch

    def zdb_of(g):
        def zdb(pw):
            pw = pw.reshape(batch, ch, -1)
            return stage09_10_products(pw[:, 0], pw[:, 1], g)[0].cpu().numpy()
        return zdb

    out = {}
    for x in ((x_all, x_all.float()) if batch == BATCH else (x_all,)):
        label = f"radix offset entry {x.dtype}, batch {batch}"
        res = offset_entry_checks(
            label, x.shape[0], bc,
            lambda off, salt: fullchain.fused_chain_power_radix(
                x, plan, offset=off, bc=bc, salt=salt),
            lambda off: fullchain.fused_chain_power_radix(
                x[off:off + bc].contiguous(), plan),
            lambda off, salt: fullchain.fft_chain_power_reference(
                x[off:off + bc], plan, salt),
            zdb_of(gain), (0,) + BENCH_SALTS, SALTED_TOL)
        if x.dtype == torch.int16:
            out["radix"] = res
            bound_ms, bound_by = bound(
                bc * chain_flops(cfg.m, n),
                bc * 2 * cfg.m * n * 2 + plan.fft_t.numel() * 4
                + bc * cfg.m // 2 * 4)
            res.update(bound_ms=bound_ms, bound_by=bound_by)

    w32_all = wire_words_on_card(x_all, cfg)
    label = f"wire offset entry, batch {batch}"
    res = offset_entry_checks(
        label, w32_all.shape[0], batch,
        lambda off, salt: fullchain.fused_chain_power_wire(
            w32_all, plan, ch, offset=off, bs=batch, salt=salt),
        lambda off: fullchain.fused_chain_power_wire(
            w32_all[off:off + batch].contiguous(), plan, ch),
        lambda off, salt: fullchain.fused_chain_power_wire_reference(
            w32_all[off:off + batch], plan, ch, salt),
        zdb_of(gain), (0,) + BENCH_SALTS, SALTED_TOL)
    e, a = rel_dev(fullchain.fused_chain_power_radix(x_all, plan, offset=bc,
                                                     bc=bc, salt=BENCH_SALTS[-1]),
                   fullchain.fused_chain_power_wire(
                       w32_all, plan, ch, offset=batch, bs=batch,
                       salt=BENCH_SALTS[-1]).reshape(bc, -1))
    check(e <= POWER_TOL, f"{label}: slab 1's words, salt {BENCH_SALTS[-1]}, "
                          f"vs the radix offset entry on its planar samples "
                          f"rel-L2 {e:.3e} <= {POWER_TOL} (max abs {a:.3e})")
    bound_ms, bound_by = bound(
        bc * chain_flops(cfg.m, n),
        batch * cfg.m * ch * n * 4 + plan.fft_t.numel() * 4
        + bc * cfg.m // 2 * 4)
    out["wire"] = dict(res, bound_ms=bound_ms, bound_by=bound_by)
    del w32_all

    res = offset_entry_checks(
        f"dense offset entry m={DENSE_M}, batch {batch}", d_all.shape[0], bc,
        lambda off, salt: fullchain.fused_chain_power_at(d_all, off, bc, dplan),
        lambda off: fullchain.fused_chain_power_dense(
            d_all[off:off + bc].contiguous(), dplan),
        lambda off, salt: dense_plain(d_all[off:off + bc], dplan),
        zdb_of(dgain), (), KERNEL_TOL)
    bound_ms, bound_by = bound(
        bc * chain_flops(DENSE_M, n),
        bc * 2 * DENSE_M * n * 2 + dplan.fft_t.numel() * 4
        + bc * DENSE_M // 2 * 4)
    out["dense"] = dict(res, bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_offsets(noise, adv) -> dict:
    """The benchmark's offset entries on two staged slabs (noise, clip-bin),
    at batch 16 and at the bench's own shapes (batch 128: 384 channel-sectors
    from offset 384 of 768, the wire's 128 sectors from offset 128): radix
    and wire with salts, dense at m = 1000 without.  Returns the bench
    shapes' results."""
    cfg = DEFAULT_CONFIG
    dcfg = dataclasses.replace(cfg, num_range_cells=DENSE_M)
    consts, dconsts = PipelineConstants.build(cfg), PipelineConstants.build(dcfg)
    plan = fullchain.build_plan(consts, "cuda")
    dplan = fullchain.build_plan(dconsts, "cuda")
    gain = torch.from_numpy(consts.gain).cuda()
    dgain = torch.from_numpy(dconsts.gain).cuda()
    dnoise = [oracle.synthetic_iq(dcfg, kind="noise", seed=SEED + b)
              for b in range(BATCH)]
    d_small = torch.from_numpy(np.concatenate([
        np.stack([planar_i16(s) for s in dnoise]),
        np.stack([planar_i16(adversarial_sector(dcfg))] * BATCH)])).cuda()
    offset_checks(BATCH, torch.cat(list(seq_inputs(noise, adv).values())),
                  d_small.reshape(-1, 2, DENSE_M, cfg.n), plan, dplan, gain,
                  dgain)
    out = offset_checks(BENCH_BATCH, bench_slabs(cfg, SEED),
                        bench_slabs(dcfg, SEED + 1), plan, dplan, gain, dgain)
    torch.cuda.empty_cache()
    return out


def phase_stage2(orc: Oracle, noise) -> dict:
    """fused_stage2 on Y [48, 512, 512] of seeded noise vs its plain version
    and across row blocks; then on its path: the mxu method's range-stage Y
    of the noise sectors against that method's own matched-filter power and
    the oracle.  Times of the kernel, plain and torch.matmul (complex64
    Y @ B, the library yardstick of its product)."""
    cfg = DEFAULT_CONFIG
    ch, mh, n = cfg.num_channels, cfg.m // 2, cfg.n
    consts = PipelineConstants.build(cfg)
    dc = _DeviceConstants(consts, torch.device("cuda"))
    gain = torch.from_numpy(consts.gain).cuda()
    taps = consts.ma_taps
    rng = np.random.default_rng(SEED)
    shape = (BATCH * ch, mh, n)
    yr, yi = (torch.from_numpy((rng.standard_normal(shape) * 1e-3)
                               .astype(np.float32)).cuda() for _ in range(2))
    got = postprocess.fused_stage2(yr, yi, dc.br, dc.bi, taps)
    torch.cuda.synchronize()
    e, a = rel_dev(postprocess.fused_stage2_reference(yr, yi, dc.br, dc.bi,
                                                      taps), got)
    check(e <= STAGE2_TOL, f"fused_stage2 Y {list(shape)}: kernel vs plain "
                           f"rel-L2 {e:.3e} <= {STAGE2_TOL} (max abs {a:.3e})")
    e3, _ = rel_dev(postprocess.tf32x3_power_reference(yr, yi, dc.br, dc.bi,
                                                        taps), got)
    print(f"fused_stage2: kernel vs the torch emulation of its 3 x TF32 "
          f"arithmetic rel-L2 {e3:.3e}", flush=True)
    for rb in (256, 512):
        check(torch.equal(postprocess.fused_stage2(yr, yi, dc.br, dc.bi, taps,
                                                   row_block=rb), got),
              f"fused_stage2 row_block {rb}: identical to row_block 128")
    try:
        postprocess.fused_stage2(yr, yi, dc.br, dc.bi, taps, row_block=100)
        raised = False
    except ValueError:
        raised = True
    check(raised, "fused_stage2 row_block 100 (rows 512 do not divide): raises")

    x = torch.from_numpy(np.stack([planar_i16(s) for s in noise])).cuda().float()
    xr, xi = x[:, :, 0], x[:, :, 1]
    ys = _rmatmul(dc.ar, dc.ai, xr, xi)         # the mxu method's range stage
    want = channel_power_planar(xr, xi, dc, "mxu", "direct").reshape(-1, mh)
    reset_counts()
    pw = postprocess.fused_stage2(*(y.reshape(-1, mh, n).contiguous()
                                    for y in ys), dc.br, dc.bi, taps)
    torch.cuda.synchronize()
    counts = read_counts()
    launches, op_launches = counts["stage2"], counts["stage2_operator"]
    e2, a2 = rel_dev(want, pw)
    check(e2 <= POWER_TOL and launches == op_launches == 1,
          f"fused_stage2 on the mxu method's Y of {BATCH} noise sectors: vs "
          f"the mxu matched-filter power rel-L2 {e2:.3e} <= {POWER_TOL} (max "
          f"abs {a2:.3e}); {launches} GEMM launch after {op_launches} of the "
          "operator's real form")
    pk = pw.cpu().numpy().reshape(BATCH, ch, mh)
    for s in range(3):
        check_vs_oracle(f"fused_stage2 on mxu Y, noise sector {s}", pk[s],
                        orc.power((cfg.m, cfg.n, "noise", s), noise[s], cfg),
                        cfg, gain)

    yc, bcx = torch.complex(yr, yi), torch.complex(dc.br, dc.bi)
    t = timed({"plain": lambda: postprocess.fused_stage2_reference(
                   yr, yi, dc.br, dc.bi, taps),
               "kernel": lambda: postprocess.fused_stage2(yr, yi, dc.br, dc.bi,
                                                          taps),
               "library": lambda: torch.matmul(yc, bcx)},
              ("plain", "kernel", "library", "library", "kernel", "plain"))
    rows = shape[0] * mh
    # least work: the Doppler transform as an FFT per row, |Z|^2 and the sum
    bound_ms, bound_by = bound(rows * (5.0 * n * math.log2(n) + 4.0 * n),
                               2 * yr.numel() * 4 + 2 * n * n * 4 + rows * 4)
    gemm = 8.0 * rows * n * n
    print(f"fused_stage2 kernel, Y [{shape[0]}, {mh}, {n}]: {t['kernel']:.3f} "
          f"ms, plain {t['plain']:.3f} ms, library (complex64 Y @ B) "
          f"{t['library']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); the "
          f"kernel's GEMM (the real form of Y @ B, {gemm / 1e9:.1f} GFLOP) "
          f"runs three TF32 products: {3 * gemm / 1e9:.1f} GFLOP, "
          f"{1e3 * 3 * gemm / PEAK_TF32:.3f} ms at the TF32 peak "
          f"({1e3 * gemm / PEAK_FP32:.3f} ms for one on the fp32 cores)",
          flush=True)
    return {"max_abs_err": a, "rel_l2": e, "ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": bound_ms, "bound_by": bound_by, "launches": launches,
            "operator_launches": op_launches}


#: (label, argv, offset counter) of the bench runs; the non-fused methods
#: at 4 repeats (8 steps) so the whole script stays well inside its limit
BENCH_RUNS = (
    ("pallas i16", [], "radix_offset"),
    ("wire fused", ["--in-dtype", "wire"], "wire_offset"),
    ("wire xla", ["--in-dtype", "wire", "--wire-decode", "xla"], "radix_offset"),
    (f"pallas m={DENSE_M}", ["--range-cells", str(DENSE_M), "--repeats", "8"],
     "dense_offset"),
) + tuple((m, ["--method", m, "--repeats", "4"], None)
          for m in ("mxu", "parseval", "fft", "radix"))
OFFSET_COUNTERS = ("radix_offset", "wire_offset", "dense_offset")


def phase_bench() -> dict:
    """`bench.run` in this process for each of BENCH_RUNS: its parity gate
    passed, value > 0, and the run's offset counter equal to its launches:
    (the warm pass and 3 timed passes) x steps + the gate's 2 calls, with
    the other offset entries unused.  Returns {counter: launches} of the
    first run of each counter, and the first run's value (pallas int16)."""
    launches, values = {}, {}
    for label, argv, counter in BENCH_RUNS:
        reset_counts()
        r = bench.run(argv)
        counts = read_counts()
        torch.cuda.empty_cache()
        print(f"bench {label}: " + json.dumps(r), flush=True)
        e0, e1 = r["parity_rel_l2"]
        check(e0 < BENCH_GATE[0] and e1 < BENCH_GATE[1] and r["value"] > 0,
              f"bench {label}: parity {e0:.3e}, {e1:.3e} under {BENCH_GATE}; "
              f"{r['value']} sectors/s, with H2D pipelined "
              f"{r['sectors_per_second_with_h2d_pipelined']}, calibration "
              f"{r['calib_tflops']} TFLOP/s")
        want = (1 + len(r["timed_runs_s"])) * r["steps"] + 2 if counter else 0
        others = {k: counts[k] for k in OFFSET_COUNTERS if k != counter}
        # the dense entry's launches all take the FFT-form body at m = 1000
        body = counts["dense_fft"] == counts["dense_offset"] + counts["dense"]
        check((counter is None or counts[counter] == want)
              and not any(others.values()) and body
              and counts["dense_matrix"] == 0,
              f"bench {label}: offset launches {counts} ({counter} == {want}"
              f"; dense launches on the FFT-form body "
              f"{counts['dense_fft']})")
        if counter:
            launches.setdefault(counter, counts[counter])
        values.setdefault(label, r["value"])
    return launches, values[BENCH_RUNS[0][0]]


def print_ptxas(pattern: str) -> list:
    """The -Xptxas=-v report of the kernels whose names match `pattern`;
    returns those of them with spill stores or loads."""
    rep = kernel_ab.ptxas_report(_build.library_path().with_suffix(".log")
                                 .read_text(), Path(_build._nvcc()).parent)
    spills = []
    for name, line in sorted(rep.items()):
        if re.search(pattern, name):
            print(f"ptxas: {name}: {line}", flush=True)
            if " 0/0 spill" not in line:
                spills.append(name)
    return spills


def probe_breakdown(orc: Oracle, noise, adv) -> dict:
    """The breakdown's four modes (csrc/kernel_breakdown.cu: the TPU
    algorithm's salted radix chain on bf16 wgmma, one body) at batch 16 (48
    channel-sectors) on the noise and clip-bin slabs, salted: each vs its
    plain version, `full` also vs the production FFT-form salted entry and
    the fp64 oracle of the salted samples; then `kernel_breakdown.run` (its
    launches counted) with its attribution, its blocks per SM (equal across
    modes) and its SASS (HGMMA in every mode, as many in each; no wgmma
    serialisation warning from ptxas)."""
    cfg = DEFAULT_CONFIG
    bp = probes.breakdown_plan(PipelineConstants.build(cfg), "cuda")
    plan = bp.plan
    x_all = torch.cat(list(seq_inputs(noise, adv).values()))
    bc, salt = BATCH * cfg.num_channels, BENCH_SALTS[0]
    worst = max_abs = 0.0
    for off, label, secs in ((0, "noise", noise), (bc, "clip-bin", [adv] * BATCH)):
        for mode in probes.ABLATION_MODES:
            got = probes.radix_chain_ablation(x_all, bp, mode, off, bc, salt)
            torch.cuda.synchronize()
            e, a = rel_dev(probes.radix_chain_ablation_reference(
                x_all, bp, mode, off, bc, salt), got)
            worst, max_abs = max(worst, e), max(max_abs, a)
            check(e <= PROBE_TOL, f"breakdown {mode} {label} salt {salt}: kernel "
                                  f"vs plain rel-L2 {e:.3e} <= {PROBE_TOL} "
                                  f"(max abs {a:.3e})")
            if mode != "full":
                continue
            e2, _ = rel_dev(fullchain.fused_chain_power_radix(
                x_all, plan, offset=off, bc=bc, salt=salt), got)
            check(e2 <= POWER_TOL,
                  f"breakdown full {label}: vs the FFT-form salted radix offset "
                  f"entry rel-L2 {e2:.3e} <= {POWER_TOL}")
            pk = got.cpu().numpy().reshape(BATCH, cfg.num_channels, -1)
            eo = max(rel(orc.power((cfg.m, cfg.n, label, s, salt),
                                   secs[s] + salt * (1 + 1j), cfg)[c], pk[s, c])
                     for s in range(BATCH) for c in range(cfg.num_channels))
            check(eo <= POWER_TOL,
                  f"breakdown full {label}: vs the fp64 oracle of the salted "
                  f"samples, worst channel-sector rel-L2 {eo:.3e} <= {POWER_TOL}")
    # the rest of the kernel's contract: M = 64 (one q half), clusters of
    # 8, 4, 1 and 3, 6, 5, 7 pulse tiles (the merge's last block then
    # takes fewer rows), on 6 channel-sectors from offset 1
    for m, n in BREAKDOWN_GEOMETRIES:
        bpg = probes.breakdown_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                                    "cuda")
        xg = torch.from_numpy(np.random.default_rng(SEED + m + n).integers(
            -8192, 8192, (8, 2, m, n), dtype=np.int16)).cuda()
        for mode in probes.ABLATION_MODES:
            got = probes.radix_chain_ablation(xg, bpg, mode, 1, 6, BENCH_SALTS[-1])
            torch.cuda.synchronize()
            e, a = rel_dev(probes.radix_chain_ablation_reference(
                xg, bpg, mode, 1, 6, BENCH_SALTS[-1]), got)
            check(e <= PROBE_TOL, f"breakdown {mode} at {m} x {n}: kernel vs plain "
                                  f"rel-L2 {e:.3e} <= {PROBE_TOL} (max abs {a:.3e})")
    t = {}
    for mode in probes.ABLATION_MODES:
        t[mode] = timed({
            "plain": lambda: probes.radix_chain_ablation_reference(
                x_all, bp, mode, 0, bc, salt),
            "kernel": lambda: probes.radix_chain_ablation(
                x_all, bp, mode, 0, bc, salt)},
            ("plain", "kernel", "kernel", "plain"))
    t["fft_entry"] = timed({"kernel": lambda: fullchain.fused_chain_power_radix(
        x_all, plan, offset=0, bc=bc, salt=salt)}, ("kernel", "kernel"))
    # `full` against the FFT-form salted entry on the card alone: one call a
    # turn (above) also times the host work that outlasts the empty queue,
    # and the two wrappers' host work differs; queued, it hides
    pair = {"full": lambda: probes.radix_chain_ablation(x_all, bp, "full", 0, bc, salt),
            "fft_entry": lambda: fullchain.fused_chain_power_radix(
                x_all, plan, offset=0, bc=bc, salt=salt)}
    queued = {name: [] for name in pair}
    for name in ("full", "fft_entry", "fft_entry", "full"):
        queued[name].append(queued_ms(pair[name]))
    host = {name: host_ms(fn) for name, fn in pair.items()}
    print("full vs the FFT-form salted entry, queued 20 a turn (ms a call, "
          "order full/fft_entry/fft_entry/full): " + json.dumps(queued)
          + "; host ms a call " + json.dumps(host), flush=True)
    queued = {name: min(v) for name, v in queued.items()}
    reset_counts()
    r = kernel_breakdown.run(["--repeats", str(BREAKDOWN_REPEATS)])
    launches = read_counts()
    print("kernel_breakdown (repeats " + str(BREAKDOWN_REPEATS) + "): "
          + json.dumps(r), flush=True)
    occ = {mode: r[mode]["blocks_per_sm"] for mode in probes.ABLATION_MODES}
    occ["astage_at_fused_smem"] = r["astage_at_fused_smem"]["blocks_per_sm"]
    check(len(set(occ.values())) == 1,
          f"one body at one occupancy: blocks per SM {occ}, the A-stage at its "
          f"own 8 KB {r['astage']['blocks_per_sm']}")
    hgmma = {mode: r["sass"][mode]["HGMMA"] for mode in probes.ABLATION_MODES}
    check(min(hgmma.values()) > 0 and len(set(hgmma.values())) == 1,
          f"SASS HGMMA per mode {hgmma}: every mode's dots on the tensor cores, "
          f"none compiled away")
    log = _build.library_path().with_suffix(".log").read_text()
    serial = [ln for ln in log.splitlines()
              if re.search(r"wgmma", ln, re.I) and re.search(r"serializ|warn", ln, re.I)]
    check(not serial, f"ptxas: no wgmma serialisation warning ({serial[:2]})")
    check(launches["breakdown"] == 6 * 4 * r["steps"]
          and launches["radix_offset"] == launches["astage"] == 0,
          f"kernel_breakdown launches: {launches['breakdown']} of "
          f"csrc/kernel_breakdown.cu (dots, splits, combine, full, the "
          f"matrix-form A-stage at its own and at the breakdown body's shared "
          f"memory; {r['steps']} steps x (warm + 3 spans) each); production "
          f"entries {launches['radix_offset']} radix, {launches['astage']} A-stage")
    bound_ms, bound_by = bound(2.0 * bc * 2 * cfg.m * cfg.n,
                               bc * 2 * cfg.m * cfg.n * 2
                               + bp.a_kcat.numel() * 2 + bc * cfg.m // 2 * 4)
    # the matrix form's tensor-core floor: 24 dots of [M, 3M] @ [3M, n] a
    # channel-sector, printed beside the bound, never as it
    M = cfg.m // plan.radix
    tc_ms = 1e3 * bc * 24 * 2 * M * 3 * M * cfg.n / PEAK_BF16
    att = r["attribution_us"]
    print(f"breakdown per launch of {bc} channel-sectors: "
          + ", ".join(f"{mode} {t[mode]['kernel']:.3f} ms (plain "
                      f"{t[mode]['plain']:.3f})" for mode in probes.ABLATION_MODES)
          + f"; bound {bound_ms:.4f} ms ({bound_by}); the matrix form's "
          f"tensor-core floor {tc_ms:.4f} ms; full vs the FFT-form salted entry "
          f"at {bc}: one call a turn {t['full']['kernel']:.3f} vs "
          f"{t['fft_entry']['kernel']:.3f} ms, queued {queued['full']:.3f} vs "
          f"{queued['fft_entry']:.3f} ms "
          f"({queued['fft_entry'] / queued['full']:.3f}x); the tool: " + ", ".join(f"{k} {r[k]['ms_per_launch']}" for k in
                                        (*probes.ABLATION_MODES, "astage",
                                         "astage_at_fused_smem"))
          + f" ms; attribution (us per channel-step) {json.dumps(att)}; SASS "
          f"{json.dumps(r['sass'])}", flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst, "ms": t["dots"]["kernel"],
            "plain_ms": t["dots"]["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "launches": launches["breakdown"], "tensor_core_floor_ms": tc_ms,
            "fft_entry_ms": t["fft_entry"]["kernel"],
            "full_queued_ms": queued["full"], "fft_entry_queued_ms": queued["fft_entry"],
            "host_ms": host,
            "modes": {m: t[m]["kernel"] for m in probes.ABLATION_MODES},
            "tool": r}


@functools.lru_cache(maxsize=None)
def _tensor_core_sass() -> dict:
    return kernel_ab.sass_opcode_counts(
        _build.library_path(), Path(_build._nvcc()).parent, ("HGMMA", "HMMA"),
        only=("tc_dot_kernel", "int_split_kernel"))


def sass_counts(pattern: str) -> dict:
    """{kernel: {"HGMMA": n, "HMMA": n}} of the built library's probe
    kernels (tc_dot_kernel, int_split_kernel) whose names match `pattern`
    (warpgroup and warp-level tensor-core instructions in the SASS; one
    dump of the library serves every call)."""
    return {k: v for k, v in _tensor_core_sass().items()
            if re.search(pattern, k)}


def wgmma_serialized(pattern: str) -> list:
    """ptxas's warnings that it serialised the wgmma of a kernel matching
    `pattern` (the build log's lines that name both)."""
    log = _build.library_path().with_suffix(".log").read_text()
    return [ln for ln in log.splitlines()
            if "wgmma" in ln and "serializ" in ln and re.search(pattern, ln)]


def tc_identity(M: int, width: int) -> None:
    """The probe with A = I (M x M, so K = M) and X [M, width] integers:
    out[0] is the row sums of X, exact in fp32."""
    dev, bf = "cuda", torch.bfloat16
    xk = ((torch.arange(M * width, device=dev).reshape(M, width) * 7) % 61
          - 30).float()
    got = probes.tc_dot_probe(torch.eye(M, device=dev, dtype=bf)[None],
                              xk.to(bf), width, 1, 1, width)
    torch.cuda.synchronize()
    check(torch.equal(got[0], xk.sum(1)),
          f"tc probe {M} x {M} x {width}, A = I: row sums of X, exact")


def probe_tc() -> dict:
    """The tensor-core probe: its SASS (HGMMA, no HMMA) and ptxas's report,
    identity operands first (a wrong descriptor or fragment layout fails
    here; M below, at and past one warpgroup's 64 rows and widths off the
    128-column tile), its grid's units against the wrapper's plan, then
    each width of the tool's defaults at PROBE_STEPS steps vs the plain
    version, then `mxu_occupancy.run` at its defaults (its launches
    counted); times of one call at width 512 and 512 steps, of the plain
    version and of the two library yardsticks."""
    dev = "cuda"
    bf = torch.bfloat16
    sass = sass_counts(r"tc_dot_kernel")
    serial = wgmma_serialized(r"tc_dot_kernel")
    check(len(sass) == 1 and all(v["HGMMA"] > 0 and v["HMMA"] == 0
                                 for v in sass.values()) and not serial,
          f"tc probe SASS {json.dumps(sass)}: HGMMA, no HMMA; ptxas "
          f"serialises no wgmma ({serial})")
    # A = I (16 x 16), X [16, 8] = 16 k + n: out[m] = rowsum of X's row m
    xk = (16 * torch.arange(16, device=dev)[:, None]
          + torch.arange(8, device=dev)[None, :]).float()
    got = probes.tc_dot_probe(torch.eye(16, device=dev, dtype=bf)[None],
                              xk.to(bf), 8, 1, 1, 8)
    torch.cuda.synchronize()
    check(torch.equal(got[0], xk.sum(1)),
          f"tc probe 16 x 16 x 8, A = I: row sums of X {got[0].tolist()[:4]}... "
          f"== {xk.sum(1).tolist()[:4]}...")
    # X = [I8; 0] (16 x 8), A [16, 16] distinct integers: out[m] = sum_{k<8} A[m, k]
    ak = ((torch.arange(256, device=dev).reshape(16, 16) * 7) % 97 - 48).float()
    xi = torch.cat([torch.eye(8, device=dev), torch.zeros(8, 8, device=dev)])
    got = probes.tc_dot_probe(ak.to(bf)[None], xi.to(bf), 8, 1, 1, 8)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ak[:, :8].sum(1)),
          "tc probe 16 x 16 x 8, X = [I8; 0]: sums of A's first 8 columns")
    # two dots, three steps over two slabs, exact: A_d = I (128 x 128), X integers
    x64 = ((torch.arange(128 * 128, device=dev).reshape(128, 128) * 5) % 61
           - 30).float()
    got = probes.tc_dot_probe(torch.eye(128, device=dev, dtype=bf)[None]
                              .repeat(2, 1, 1).contiguous(), x64.to(bf), 64, 3,
                              2, 128)
    torch.cuda.synchronize()
    want = torch.stack([2 * x64[:, 64 * (b % 2):64 * (b % 2) + 64].sum(1)
                        for b in range(3)])
    check(torch.equal(got, want), "tc probe 2 x (128 x 128 identity) x 64 "
                                  "columns, 3 steps over 2 slabs: exact")
    for M in (64, 192):
        for width in (8, 136, 256):
            tc_identity(M, width)

    m, k, lanes, distinct, widths = 128, 384, 24 * 512, 4, (512, 1024, 2048)
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, K, w, nd, st in [(m, k, w, lanes // w, 512) for w in widths] + [
            (16, 16, 8, 1, 1), (192, 192, 136, 1, 1), (300, 48, 72, 3, 5)]:
        plan = probes.tc_probe_plan(M, w, nd, st, sms)
        units = lib.wrp_tc_dot_probe_units(M, K, w, nd, st)
        check(units == plan.units, f"tc probe grid M {M} K {K} width {w} "
                                   f"({nd} dots, {st} steps): the kernel's "
                                   f"{units} units == the plan's; "
                                   f"{plan.blocks} blocks")
    rng = np.random.default_rng(SEED)
    a = torch.from_numpy(rng.standard_normal((lanes // min(widths), m, k),
                                             dtype=np.float32)).to(bf).cuda()
    x = torch.from_numpy(rng.standard_normal((k, distinct * max(widths)),
                                             dtype=np.float32)).to(bf).cuda()
    worst = max_abs = 0.0
    for w in widths:
        got = probes.tc_dot_probe(a, x, w, PROBE_STEPS, distinct, lanes)
        torch.cuda.synchronize()
        e, ab = rel_dev(probes.tc_dot_probe_reference(a, x, w, PROBE_STEPS,
                                                      distinct, lanes), got)
        worst, max_abs = max(worst, e), max(max_abs, ab)
        check(e <= PROBE_TOL, f"tc probe width {w} ({lanes // w} dots), "
                              f"{PROBE_STEPS} steps: kernel vs plain rel-L2 "
                              f"{e:.3e} <= {PROBE_TOL} (max abs {ab:.3e})")
    reset_counts()
    r = mxu_occupancy.run([])
    launches = read_counts()["tc_probe"]
    print("mxu_occupancy (defaults): " + json.dumps(r), flush=True)
    check(launches == 4 * len(widths)
          and all(r[f"n{w}"]["tensor_core_utilisation"] > 0 for w in widths),
          f"mxu_occupancy launches: {launches} (warm + 3 spans per width); "
          f"tensor_core_utilisation "
          f"{[r[f'n{w}']['tensor_core_utilisation'] for w in widths]}")
    steps, w = 512, 512
    nd = lanes // w
    t = timed({"plain": lambda: probes.tc_dot_probe_reference(
                   a, x, w, steps, distinct, lanes),
               "kernel": lambda: probes.tc_dot_probe(a, x, w, steps, distinct,
                                                     lanes),
               "library": mxu_occupancy.library_steps(a, x, w, steps,
                                                      distinct, nd),
               "library_kcat": mxu_occupancy.library_kcat_steps(
                   a, x, w, steps, distinct, nd)},
              ("plain", "kernel", "library", "library_kcat", "library_kcat",
               "library", "kernel", "plain"))
    lib_form = min(("library", "library_kcat"), key=t.get)
    flops = 2.0 * m * k * lanes * steps
    bound_ms, bound_by = bound(flops, nd * m * k * 2 + x.numel() * 2
                               + steps * m * 4, PEAK_BF16)
    print(f"tc probe width {w}, {steps} steps: {t['kernel']:.3f} ms "
          f"({flops / t['kernel'] / 1e9:.1f} TFLOP/s, "
          f"{flops / t['kernel'] / 1e-3 / PEAK_BF16:.3f} of {PEAK_BF16 / 1e12} "
          f"TFLOP/s), plain {t['plain']:.3f} ms, library (from CUDA graphs) "
          f"torch.matmul bf16 [{nd}, {m}, {k}] @ [{k}, {w}] per step "
          f"{t['library']:.3f} ms, one [{m}, {nd * k}] @ [{nd * k}, {w}] GEMM "
          f"per step {t['library_kcat']:.3f} ms; bound {bound_ms:.3f} ms "
          f"({bound_by}); the kernel {t[lib_form] / t['kernel']:.2f}x faster "
          f"than the faster yardstick ({lib_form})", flush=True)
    return {"max_abs_err": max_abs, "rel_l2": worst, "ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t[lib_form],
            "library_form": lib_form, "library_batched_ms": t["library"],
            "library_kcat_ms": t["library_kcat"], "bound_ms": bound_ms,
            "bound_by": bound_by, "launches": launches,
            "blocks": probes.tc_probe_plan(m, w, nd, steps, sms).blocks,
            "tool": r}


def probe_split() -> dict:
    """The int16 -> bf16 split dot, both variants, on the tool's input (the
    14-bit range) and on every int16 value once ([128, 512]): vs the plain
    version; on the 14-bit range vs fp32 A @ x (TF32 off) and split exact;
    the inexact samples of the full range printed.  Then
    `int_split_repro.run` for both variants (its launches counted); times of
    the kernel, the plain version and torch.matmul in fp32: its `ms` and
    `library_ms` are device times per call from a CUDA graph of 100 calls,
    the times from Python (the wrapper's host work in them) beside."""
    m, n = 128, 512
    lib = _build.load_library()
    blocks = lib.wrp_int_split_dot_blocks(m, n)
    sass = sass_counts(r"int_split_kernel")
    check(blocks == len(probes.int_split_tiles(m, n)) and blocks >= 64
          and len(sass) == 2 and all(v["HMMA"] > 0 for v in sass.values()),
          f"int split grid at [{m}, {n}]: {blocks} blocks (>= 64, one per "
          f"{probes.SPLIT_TILE} x {probes.SPLIT_TILE} tile of "
          f"`int_split_tiles`); SASS {json.dumps(sass)}")
    rng = np.random.default_rng(0)            # the tool's inputs
    x14 = torch.from_numpy(rng.integers(-8192, 8192, (m, n), dtype=np.int16)).cuda()
    a = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)
                         ).to(torch.bfloat16).cuda()
    xfull = torch.arange(-32768, 32768, device="cuda").to(torch.int16).reshape(m, n)
    worst = max_abs = 0.0
    for label, x in (("14-bit", x14), ("full int16", xfull)):
        for variant in probes.SPLIT_VARIANTS:
            got = probes.int_split_dot(x, a, variant)
            torch.cuda.synchronize()
            e, ab = rel_dev(probes.int_split_dot_reference(x, a, variant), got)
            worst, max_abs = max(worst, e), max(max_abs, ab)
            inexact = probes.split_inexact_count(x, variant)
            check(e <= SPLIT_TOL, f"int split {variant} {label}: kernel vs plain "
                                  f"rel-L2 {e:.3e} <= {SPLIT_TOL} (max abs "
                                  f"{ab:.3e}); inexact samples {inexact} of "
                                  f"{x.numel()}")
            if label == "14-bit":
                e2, _ = rel_dev(torch.matmul(a.float(), x.float()), got)
                check(e2 <= SPLIT_TOL and inexact == 0,
                      f"int split {variant} 14-bit: vs fp32 A @ x rel-L2 "
                      f"{e2:.3e} <= {SPLIT_TOL}; split_exact")
    reset_counts()
    runs = {v: int_split_repro.run(["--variant", v])
            for v in probes.SPLIT_VARIANTS}
    launches = read_counts()["int_split"]
    for v, r in runs.items():
        print(f"int_split_repro --variant {v}: " + json.dumps(r), flush=True)
        check(r["ok"] and r["split_exact"] and not r["repro"],
              f"int_split_repro {v}: ok, split_exact, rel-L2 "
              f"{r['rel_l2_vs_f32_matmul']:.3e}, {r['us_per_call']} us a call")
    af, xf = a.float(), x14.float()
    t = timed({"plain": lambda: probes.int_split_dot_reference(x14, a, "int"),
               "kernel": lambda: probes.int_split_dot(x14, a, "int"),
               "library": lambda: torch.matmul(af, xf)},
              ("plain", "kernel", "library", "library", "kernel", "plain"))
    bound_ms, bound_by = bound(2 * 2.0 * m * m * n,
                               x14.numel() * 2 + a.numel() * 2 + m * n * 4,
                               PEAK_BF16)
    # device time per call, the wrapper's host work left out: 100 calls in
    # a CUDA graph, replayed (after the counted run: a capture counts its
    # calls)
    dev = {name: [] for name in ("kernel", "library")}
    for name in ("kernel", "library", "library", "kernel"):
        dev[name].append(kernel_ab.graph_ms(
            (lambda: probes.int_split_dot(x14, a, "int")) if name == "kernel"
            else (lambda: torch.matmul(af, xf))))
    print(f"int split dot (int) [{m}, {n}]: {t['kernel']:.4f} ms a call from "
          f"Python, plain {t['plain']:.4f} ms, library (fp32 A @ x) "
          f"{t['library']:.4f} ms; device time per call from a CUDA graph "
          f"(turns kernel/library/library/kernel): kernel {dev['kernel']}, "
          f"library {dev['library']} ms; bound {bound_ms:.5f} ms ({bound_by})",
          flush=True)
    # the device time is the kernel's time; from Python it is the wrapper's
    return {"max_abs_err": max_abs, "rel_l2": worst,
            "ms": min(dev["kernel"]), "plain_ms": t["plain"],
            "library_ms": min(dev["library"]), "bound_ms": bound_ms,
            "bound_by": bound_by, "launches": launches, "blocks": blocks,
            "python_ms": t["kernel"], "library_python_ms": t["library"]}


def phase_probes(orc: Oracle, noise, adv) -> dict:
    """The three probe kernels and their entry points (the TPU tools'
    kernels), at production geometry.  fp32 yardsticks with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    print_ptxas(r"tc_dot_kernel|int_split_kernel|breakdown_kernel|radix_chain_kernel")
    out = {"breakdown": probe_breakdown(orc, noise, adv), "tc": probe_tc(),
           "split": probe_split()}
    torch.cuda.empty_cache()
    print(f"probes phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _cli(argv) -> tuple:
    """(rc, stdout, stderr) of `wrp_tpu_torch.cli` run in this process, as a
    user runs the command; its output is echoed."""
    import contextlib
    import io

    from wrp_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    for stream in (out, err):
        if stream.getvalue():
            print(stream.getvalue().rstrip(), flush=True)
    return rc, out.getvalue(), err.getvalue()


CLI_STAGES = ["01hamm", "02fft1", "03fft2", "04abs", "07conv", "08pow"]


def phase_cli_process(tmp: Path) -> dict:
    """`cli process --method pallas --timings --output` on the card (the fft
    path's six stages fenced one by one, then one radix launch), and `cli
    compare` of its output against the fp64 oracle's products of the same
    synthetic sector written the same way (pass at 1e-4)."""
    from wrp_tpu_torch.io.files import write_ascii_matrix

    cfg = DEFAULT_CONFIG
    got = tmp / "process.out"
    reset_counts()
    rc, _, err = _cli(["process", "--method", "pallas", "--timings",
                       "--output", str(got)])
    counts = read_counts()
    stages = [ln.split()[1].rstrip(":") for ln in err.splitlines()
              if ln.startswith("stage ")]
    check(rc == 0 and stages == CLI_STAGES and counts["radix"] == 1,
          f"cli process --timings on the card: rc {rc}, stages {stages}, "
          f"radix launches {counts['radix']} (== 1)")
    want = tmp / "oracle.out"
    write_ascii_matrix(want, np.stack(oracle.process_sector(
        oracle.synthetic_iq(cfg, kind="noise", seed=0), cfg), 1))
    rc, out, _ = _cli(["compare", str(want), str(got)])
    line = json.loads(out)
    check(rc == 0 and line["pass"] and line["threshold"] == 1e-4,
          f"cli compare of process --output vs the fp64 oracle: relative L2 "
          f"{line['relative_l2']:.3e} <= 1e-4")
    return {"radix": counts["radix"], "stages_us": {
        ln.split()[1].rstrip(":"): float(ln.split()[2])
        for ln in err.splitlines() if ln.startswith("stage ")}}


def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_stream_trace(tmp: Path) -> tuple:
    """`cli stream --trace` as a user runs it: its own process, one paced
    cut of 143 sectors from `cli produce` over UDP loopback, host decode,
    the radix kernel, a volume checkpoint.  Then the port's trace_summary
    --overlap on the trace: the radix kernel's CUDA events (one per launch
    the worker counted), the executor's stage spans from the ingest thread
    and from the compute thread, the overlap of `ingest/decode` and
    `compute/h2d_enqueue` with the in-flight window, and the device's busy
    share (its kernels, copies and memsets over the traced window).
    Returns (the summary's numbers, the checkpoint's path)."""
    from wrp_tpu_torch.tools import trace_summary

    cfg = DEFAULT_CONFIG
    here = os.path.dirname(os.path.abspath(__file__))
    pool_n = 8
    port = free_udp_port()
    ready, trace, ckpt = tmp / "ready", tmp / "trace", tmp / "stream.npz"
    sink = _Sink()
    cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "stream", "--method",
           "pallas", "--batch", str(BATCH), "--timeout", "2", "--idle-limit",
           "15", "--max-sectors", str(SECTORS), "--ingest-port", str(port),
           "--zdb-port", str(sink.ports[0]), "--zdr-port", str(sink.ports[1]),
           "--extended-results", "--ready-file", str(ready), "--trace",
           str(trace), "--checkpoint", str(ckpt), "--checkpoint-every", "-1"]
    t0 = time.perf_counter()
    stream = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 180
        while not ready.exists():
            if stream.poll() is not None or time.monotonic() > deadline:
                raise SmokeFailure(f"stream --trace never became ready: rc "
                                   f"{stream.poll()} {stream.stderr.read()[-3000:]}")
            time.sleep(0.05)
        t_ready = time.perf_counter() - t0
        prod = subprocess.run(
            [sys.executable, "-m", "wrp_tpu_torch.cli", "produce", "--sectors",
             str(SECTORS), "--rate", str(RATE), "--pool", str(pool_n),
             "--seed", str(SEED), "--headers", "--ingest-port", str(port)],
            cwd=here, timeout=120)
        out, err = stream.communicate(timeout=180)
    finally:
        if stream.poll() is None:
            stream.kill()
            stream.wait()
        time.sleep(0.5)
        sink.close()
    print("\n".join(err.splitlines()[-4:]), flush=True)
    check(prod.returncode == 0 and stream.returncode == 0,
          f"stream --trace: producer rc {prod.returncode}, stream rc "
          f"{stream.returncode}, ready after {t_ready:.1f} s, "
          f"{time.perf_counter() - t0:.1f} s in all")
    stats = json.loads(out)
    tr = stats["transport"]
    radix = stats["kernel_launches"]["radix"]
    lat = stats["latency_ms"]
    print(f"stream --trace: {stats['processed_sectors']} sectors, latency "
          f"p50 {lat['p50_ms']} ms p99 {lat['p99_ms']} ms, ingest/decode "
          f"{stats['timers']['ingest/decode']['mean_ms']} ms; launches "
          f"{stats['kernel_launches']}; egress frames {sink.frames}",
          flush=True)
    check(stats["processed_sectors"] == SECTORS and tr["dropped_sectors"] == 0
          and tr["dropped_datagrams"] == 0
          and stats["volume_coverage"] == SECTORS / (
              cfg.num_sectors * cfg.num_elevations)
          and radix >= math.ceil(SECTORS / BATCH),
          f"stream --trace: {stats['processed_sectors']}/{SECTORS} sectors, "
          f"0 drops, the cut covered, {radix} radix launches")
    volume = VolumeScan.load(ckpt, cfg)
    check_cut_vs_oracle("stream --trace", volume, SEED, pool_n, cfg)

    summary = trace_summary.run(str(trace), top=10, overlap=True)
    dev = summary["device"]["trace"]
    traced_radix = sum(c for name, c in dev["kernel_launches"].items()
                       if "fft_chain_kernel" in name)
    check(traced_radix == radix,
          f"the trace holds {traced_radix} radix kernel events "
          f"(fft_chain_kernel), one per launch the stream counted ({radix})")
    spans = {}
    for e in trace_summary.load_events(summary["traces"][0]):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], set()).add(e["tid"])
    stages = ("ingest/recv", "ingest/decode", "compute/stage_copy",
              "compute/h2d_enqueue", "compute/dispatch", "compute/fetch",
              "egress/send")
    check(all(s in spans for s in stages)
          and spans["ingest/decode"].isdisjoint(spans["compute/dispatch"]),
          f"the trace holds the executor's stage spans {list(stages)}, the "
          f"ingest thread's and the compute thread's on their own threads "
          f"({sorted(spans['ingest/decode'])} vs "
          f"{sorted(spans['compute/dispatch'])})")
    ov = summary["overlap"]["overlap_with_in_flight"]
    active = summary["device"].get("trace:stream")
    in_window = sum(c for name, c in (active or {}).get(
        "kernel_launches", {}).items() if "fft_chain_kernel" in name)
    check(active is not None and in_window >= SECTORS // BATCH,
          f"trace_summary finds the stream's traffic window (first decode to "
          f"last fetch, {active and active['window_ms']} ms) and {in_window} "
          "radix kernel events inside it")
    with open(trace / "host_intervals.json") as f:
        decodes = sorted(t0 for name, _, t0, _ in json.load(f)
                         if name == "ingest/decode")
    arrival = (len(decodes) - 1) / (decodes[-1] - decodes[0])
    result = {"radix": radix, "traced_radix": traced_radix,
              "arrival_sectors_per_s": round(arrival, 3),
              "active_sectors_per_second": stats["active_sectors_per_second"],
              "in_flight_s": summary["overlap"]["in_flight_s"],
              "of_stage": {k: ov[k]["of_stage"] for k in
                           ("ingest/decode", "compute/h2d_enqueue")},
              "of_in_flight": {k: ov[k]["of_in_flight"] for k in
                               ("ingest/decode", "compute/h2d_enqueue")},
              "device": {k: dev[k] for k in
                         ("window_ms", "kernel_ms", "busy_ms",
                          "kernel_share", "busy_share")},
              "device_stream_window": {k: active[k] for k in
                                       ("window_ms", "kernel_ms", "busy_ms",
                                        "kernel_share", "busy_share")},
              "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"]}
    print("stream --trace summary: " + json.dumps(result), flush=True)
    return result, ckpt


def phase_volume(tmp: Path, ckpt: Path) -> None:
    """`cli volume --render` and `--export-ascii` on the traced stream's
    checkpoint: the JSON line, a PPM of the requested size, one 99result
    file per covered sector (143)."""
    size = 256
    ppm, ascii_dir = tmp / "ppi.ppm", tmp / "ascii"
    rc, out, _ = _cli(["volume", str(ckpt), "--render", str(ppm),
                       "--render-size", str(size), "--export-ascii",
                       str(ascii_dir)])
    info = json.loads(out)
    head = f"P6\n{size} {size}\n255\n".encode()
    data = ppm.read_bytes()
    n_files = len(list(ascii_dir.glob("s*e*.out")))
    check(rc == 0 and info["sectors_covered"] == SECTORS
          and data.startswith(head) and len(data) == len(head) + size * size * 3
          and n_files == SECTORS,
          f"cli volume: {info['sectors_covered']} sectors covered, a "
          f"{size} x {size} PPM ({len(data)} bytes), {n_files} 99result files")


def phase_hw_parity() -> dict:
    """tools/hw_parity.py on the card: every method and path against the
    fp64 oracle, each row passing with its kernels launched."""
    from wrp_tpu_torch.tools import hw_parity

    reset_counts()
    rows = hw_parity.run(device="cuda")
    counts = read_counts()
    for r in rows:
        print("hw_parity: " + json.dumps(r), flush=True)
    check(all(r["pass"] for r in rows)
          and [r["method"] for r in rows][:5] == list(hw_parity.METHODS),
          f"hw_parity: all {len(rows)} rows pass, every kernel a row names "
          f"launched ({', '.join(r['method'] for r in rows)})")
    return counts


def phase_ab_tools() -> dict:
    """tools/wire_ab.py and tools/decode_ab.py at production geometry on the
    card: parity pinned, per-sector us of every piece and variant."""
    from wrp_tpu_torch.tools import decode_ab, wire_ab

    cfg = DEFAULT_CONFIG
    reset_counts()
    w = wire_ab.run(cfg, device="cuda")
    counts = read_counts()
    print("wire_ab: " + json.dumps(w), flush=True)
    check("error" not in w and w["parity"]["wire_vs_i16_rel_l2"] < 1e-5,
          "wire_ab: parity (wire vs i16 kernel "
          f"{w['parity'].get('wire_vs_i16_rel_l2', float('nan')):.3e}, bit "
          f"identical at salt 0 {w['parity'].get('bit_identical_at_salt_0')}"
          f"); us per sector " + json.dumps(
              {k: w[k]["us_per_sector"] for k in
               ("k_i16", "k_wire", "slice+k_wire", "view") if k in w}))
    torch.cuda.empty_cache()
    reset_counts()
    d = decode_ab.run(cfg, device="cuda")
    d_counts = read_counts()
    print("decode_ab: " + json.dumps(d), flush=True)
    timed = {k: v["us_per_sector"] for k, v in d.items()
             if isinstance(v, dict) and "us_per_sector" in v}
    check("error" not in d, f"decode_ab: every variant bit-exact vs the host "
                            f"codec; us per sector {json.dumps(timed)}")
    torch.cuda.empty_cache()
    return {"wire_ab": {k: w[k]["us_per_sector"] for k in
                        ("k_i16", "k_wire", "slice+k_wire", "view")},
            "decode_ab": timed,
            "launches": {"wire_ab": counts, "decode_ab": d_counts}}


def phase_cli_tools() -> dict:
    """The rest of the CLI and the tools that read or check it: process
    --timings and compare, stream --trace with trace_summary --overlap,
    volume on that stream's checkpoint, hw_parity, wire_ab and decode_ab."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="wrp_smoke_cli_"))
    try:
        out = {"process": phase_cli_process(tmp)}
        out["stream"], ckpt = phase_stream_trace(tmp)
        phase_volume(tmp, ckpt)
        out["hw_parity"] = phase_hw_parity()
        out["ab"] = phase_ab_tools()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cli and tools phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


#: ab_sweep's repeats here (its default: 48, the bench's 96 steps)
AB_SWEEP_REPEATS = 16
#: the i16 row of ab_sweep over phase_bench's pallas int16 value: both run
#: #4 under the bench's methodology on the bench's slabs
AB_SWEEP_RATIO = (0.8, 1.25)
#: consolidation_soak runs: (tag, flags); 4 feeds = 1 UDP + 3 ZMQ
SOAKS = (
    ("host", ["--feeds", "4", "--udp-feeds", "1", "--duration", "8"]),
    ("device-decode", ["--feeds", "4", "--udp-feeds", "1", "--duration",
                       "6", "--device-decode"]),
    ("stub", ["--feeds", "8", "--udp-feeds", "1", "--duration", "6",
              "--stub-device"]),
)


def _tool(argv, timeout: float) -> tuple:
    """(rc, stdout, stderr) of `python -m wrp_tpu_torch.tools.<argv>` in its
    own process, from the repository root; its output's tail is echoed."""
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-m", "wrp_tpu_torch.tools." + argv[0],
                        *argv[1:]], cwd=here, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        print(r.stderr[-4000:], flush=True)
    return r.returncode, r.stdout, r.stderr


def phase_ab_sweep(bench_value: float) -> dict:
    """tools/ab_sweep.py in this process at the bench's shapes (batch 128,
    2 slabs): every variant passes the bench's gate and launches its offset
    entry (the first pass, 3 spans, 2 gate calls), and the i16 row lies
    within AB_SWEEP_RATIO of phase_bench's value."""
    from wrp_tpu_torch.tools import ab_sweep

    reset_counts()
    rows, summary = ab_sweep.run(DEFAULT_CONFIG, batch=BENCH_BATCH,
                                 distinct=2, repeats=AB_SWEEP_REPEATS,
                                 device="cuda")
    counts = read_counts()
    for r in rows + [summary]:
        print("ab_sweep: " + json.dumps(r), flush=True)
    for r in rows:
        entry = "wire_offset" if r["variant"] == "wire" else "radix_offset"
        other = "radix_offset" if entry == "wire_offset" else "wire_offset"
        want = (1 + len(r["timed_runs_s"])) * r["steps"] + 2
        check(r["parity_ok"] and r["sectors_per_second"] > 0
              and r["launches"][entry] == want and r["launches"][other] == 0,
              f"ab_sweep {r['variant']}: gate {r['parity_rel_l2']} under "
              f"{BENCH_GATE}, {r['sectors_per_second']} sectors/s, "
              f"{entry} launches {r['launches'][entry]} == {want}")
    ratio = rows[0]["sectors_per_second"] / bench_value
    check(rows[0]["variant"] == "i16"
          and AB_SWEEP_RATIO[0] <= ratio <= AB_SWEEP_RATIO[1],
          f"ab_sweep i16 {rows[0]['sectors_per_second']} sectors/s over the "
          f"bench's {bench_value}: {ratio:.4f} (within {AB_SWEEP_RATIO})")
    torch.cuda.empty_cache()
    return {"rows": {r["variant"]: r["sectors_per_second"] for r in rows},
            "i16_over_bench": ratio, "launches": counts}


def phase_multihost() -> list:
    """tools/multihost_bench.py --method pallas at 1024 x 512, 16 sectors a
    host, over min(GPU count, 4) hosts (one on a one-card machine): exit 0,
    its line, and every rank of the N-host world launching the fused chain
    (#3) once a timed step.  Returns those ranks' launches."""
    hosts = min(torch.cuda.device_count(), 4)
    steps = 8
    rc, out, err = _tool(["multihost_bench", "--method", "pallas", "--m",
                          "1024", "--n", "512", "--per-host-batch", "16",
                          "--steps", str(steps), "--hosts", str(hosts)], 300)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    found = [ln for ln in err.splitlines() if ln.startswith("launches: ")]
    check(rc == 0 and bool(lines) and bool(found),
          f"multihost_bench --hosts {hosts}: exit {rc}, its line printed")
    r = json.loads(lines[-1])
    launches = json.loads(found[-1][len("launches: "):])
    print("multihost_bench: " + json.dumps(r), flush=True)
    print("multihost_bench launches: " + json.dumps(launches), flush=True)
    check(r["efficiency_raw"] > 0 and r["backend"].startswith("nccl")
          and all(k["radix"] == steps for k in
                  launches["1host"] + launches["nhost"]),
          f"multihost_bench: {r['sectors_per_second_1host']} sectors/s on 1 "
          f"host, {r['sectors_per_second_nhost']} on {hosts}, efficiency "
          f"{r['efficiency_raw']} ({r['backend']}); each rank's #3 launches "
          f"== {steps} ({launches})")
    return [k["radix"] for k in launches["nhost"]]


def phase_soak(tag: str, flags) -> dict:
    """tools/consolidation_soak.py in its own process (the executor's CPU
    time is that process's): every feed's sectors processed, 0 drops, 0
    contamination failures (the oracle check without --stub-device), and
    the kernel of its path launched.  Returns its launches."""
    rc, out, err = _tool(["consolidation_soak", *flags], 300)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(rc == 0 and bool(lines), f"soak {tag}: exit {rc}")
    r = json.loads(lines[-1])
    feeds = r["per_feed"]
    for f in feeds:
        print(f"soak {tag} feed {f['feed']} ({f['kind']}): "
              + json.dumps(f), flush=True)
    print(f"soak {tag}: {r['total_sectors']} sectors over "
          f"{r['duration_s']} s, executor {r['executor_cpu_ms_per_sector']} "
          f"ms CPU a sector, {r['executor_core_fraction']} of a core; "
          f"p50/p99 per feed "
          + json.dumps([[f["p50_ms"], f["p99_ms"]] for f in feeds])
          + "; stages " + json.dumps({k: v["mean_ms"]
                                      for k, v in r["timers"].items()}),
          flush=True)
    kernel = {"host": "radix", "device-decode": "wire"}.get(tag)
    launched = r["kernel_launches"]
    check(not r["contamination_failures"]
          and all(f["drops"] == 0 and f["processed_sectors"]
                  == f["sent_sectors"] == f["coverage_sectors"]
                  for f in feeds)
          and (r["method"] == "stub") == (tag == "stub")
          and (kernel is None or launched[kernel] > 0)
          and sum(launched.values()) == (launched[kernel] if kernel else 0),
          f"soak {tag}: {len(feeds)} feeds, each {feeds[0]['sent_sectors']} "
          f"sectors processed, 0 drops, contamination failures "
          f"{r['contamination_failures']}; launches {launched}")
    return launched


def phase_last_tools(bench_value: float) -> dict:
    """The last three tools of the JAX package's tools/ on the card:
    ab_sweep, multihost_bench, consolidation_soak (host decode, device
    decode, the host stub)."""
    t0 = time.perf_counter()
    out = {"ab_sweep": phase_ab_sweep(bench_value),
           "multihost": phase_multihost()}
    out["soak"] = {tag: phase_soak(tag, flags) for tag, flags in SOAKS}
    print(f"last tools phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


#: the demo's sectors: one cut (the JAX package's tools/hw_demo.sh default
#: is two, 286; one keeps the script's run well inside its time limit)
DEMO_SECTORS = 143


def phase_hw_demo() -> dict:
    """`python -m wrp_tpu_torch.tools.hw_demo 143`, with host decode and with
    --device-decode, each in its own process and both at once (free ports
    each; one after the other they took 118 s on an H100 host, each run
    mostly its producer making sectors on the host): exit 0, MATCH, 143/143 sectors
    through the stream, and the path's kernel (#3 on host decode, #7 with
    --device-decode) launched, read from the stream's stats in
    OUT/stream_stats.json.  Returns {"radix": n, "wire": n}."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    runs = []
    try:
        for tag, flags, kernel in (
                ("host-decode", [], "radix"),
                ("device-decode", ["--device-decode"], "wire")):
            demo = Path(tempfile.mkdtemp(prefix="wrp_smoke_hw_demo_"))
            runs.append((tag, kernel, demo, subprocess.Popen(
                [sys.executable, "-m", "wrp_tpu_torch.tools.hw_demo", *flags,
                 "--out", str(demo), str(DEMO_SECTORS)], cwd=here,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        out = {}
        for tag, kernel, demo, proc in runs:
            stdout, stderr = proc.communicate(timeout=300)
            took = time.perf_counter() - t0
            print(stdout.rstrip(), flush=True)
            if proc.returncode != 0:
                print(stderr[-4000:], flush=True)
            stats = json.loads((demo / "stream_stats.json").read_text())
            lines = stdout.strip().splitlines()
            launched = stats["kernel_launches"]
            tr, lat = stats["transport"], stats["latency_ms"]
            print(f"hw_demo {tag}: done after {took:.1f} s; "
                  f"{stats['processed_sectors']} sectors, "
                  f"{stats['sectors_per_second']} sectors/s (active "
                  f"{stats['active_sectors_per_second']}), latency p50 "
                  f"{lat['p50_ms']} ms p99 {lat['p99_ms']} ms, dropped "
                  f"sectors {tr['dropped_sectors']}, datagrams "
                  f"{tr['dropped_datagrams']}; launches {launched}",
                  flush=True)
            check(proc.returncode == 0 and bool(lines)
                  and lines[-1] == "MATCH"
                  and stats["processed_sectors"] == DEMO_SECTORS
                  and launched[kernel] >= math.ceil(DEMO_SECTORS / BATCH)
                  and sum(launched.values()) == launched[kernel],
                  f"hw_demo {tag}: exit {proc.returncode}, "
                  f"{lines[-1] if lines else None}, "
                  f"{stats['processed_sectors']}/{DEMO_SECTORS} sectors, "
                  f"{kernel} launches {launched[kernel]} (>= "
                  f"{math.ceil(DEMO_SECTORS / BATCH)}), no other kernel")
            out[kernel] = launched[kernel]
    finally:
        for _, _, demo, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(demo, ignore_errors=True)
    print(f"hw_demo phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def kernel_entry(name, source, replaces, launches, res, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "rel_l2": res["rel_l2"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            # None: no single PyTorch call computes the function (the fused
            # chains, the row epilogue, the ablations); the A-stage's is
            # cuFFT over range of the windowed input, then the crop
            "library_ms": res.get("library_ms"), **extra}


def zmq_on_this_machine() -> bool:
    """Whether pyzmq is installed here; the ZMQ cut runs only then."""
    if importlib.util.find_spec("zmq") is None:
        print("zmq: not installed on this machine", flush=True)
        return False
    import zmq

    print(f"zmq: pyzmq {zmq.__version__} (libzmq {zmq.zmq_version()})",
          flush=True)
    return True


def main() -> int:
    t_start = time.perf_counter()
    phase_environment()
    has_zmq = zmq_on_this_machine()
    phase_build()
    occ = phase_fft_build()
    orc = Oracle()
    cfg = DEFAULT_CONFIG
    noise = [oracle.synthetic_iq(cfg, kind="noise", seed=SEED + b)
             for b in range(BATCH)]
    adv = adversarial_sector(cfg)
    offsets = phase_offsets(noise, adv)
    stage2 = phase_stage2(orc, noise)
    bench_launches, bench_value = phase_bench()
    sharded = phase_bench_sharded(bench_value)
    probe = phase_probes(orc, noise, adv)
    radix = phase_kernel(orc, noise, adv)
    wire = phase_kernel_wire(orc, noise, adv)
    dense = phase_kernel_dense(orc)
    astage = phase_kernel_astage(noise, adv)
    rows = phase_kernel_rows(noise, adv, astage)
    phase_seq_composition(orc, noise, adv)
    host = phase_stream(device_decode=False)
    dev = phase_stream(device_decode=True)
    tcp = phase_stream_v2("tcp")
    zmq_counts = phase_stream_v2("zmq") if has_zmq else None
    supervised = phase_supervise()
    phase_capacity(device_decode=False)
    phase_capacity(device_decode=True)
    dense_launches = phase_dense_path()
    long = phase_long_rays(orc)
    lr = long["launches"]
    c16 = long["cluster16"]
    shard = phase_pulse_shard(orc, noise)
    phase_halo_ranks()
    tools = phase_cli_tools()
    last = phase_last_tools(bench_value)
    demo = phase_hw_demo()
    print(f"chip_smoke.py: every phase in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        kernel_entry("fused_chain_power_radix",
                     "wrp_tpu_torch/csrc/fused_chain_radix.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:809", host["radix"],
                     radix, tcp_stream_launches=tcp["radix"],
                     zmq_stream_launches=(zmq_counts["radix"] if zmq_counts
                                          else None),
                     cli_process_launches=tools["process"]["radix"],
                     traced_stream_launches=tools["stream"]["radix"],
                     hw_parity_launches=tools["hw_parity"]["radix"],
                     soak_launches=last["soak"]["host"]["radix"],
                     multihost_bench_launches=last["multihost"],
                     ab_sweep_gate_launches=last["ab_sweep"]["launches"]["radix"],
                     hw_demo_launches=demo["radix"],
                     matrix_route=long["matrix"]["radix"],
                     matrix_offset_route=long["matrix"]["radix_offset"],
                     **occ["radix"]),
        # the cluster body (1024 < m <= 8192): launches on the long-ray
        # executor's host-decode run (#3) and the bench at m = 2048 (#4);
        # errors over CLUSTER_CHECK_MS, int16 and f32; ms, plain and bound
        # per 48 channel-sectors at m = 4096, every m's in times_by_m (f32
        # queued in f32_times_by_m)
        kernel_entry("fused_chain_power_radix (cluster body, 1024 < m <= 8192)",
                     "wrp_tpu_torch/csrc/fused_chain_radix_cluster.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:809", lr["radix"],
                     {**long["res"]["radix"], **long["at_4096"]["radix"]},
                     m=4096, times_by_m=long["times"]["radix"],
                     f32_times_by_m=long["times"]["radix_f32"]),
        kernel_entry("fused_chain_power_radix (offset, salt; cluster body)",
                     "wrp_tpu_torch/csrc/fused_chain_radix_cluster.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:840",
                     lr["radix_offset"],
                     {**long["res"]["radix_offset"],
                      **long["at_4096"]["radix_offset"]},
                     m=4096, times_by_m=long["times"]["radix_offset"]),
        # the cluster of 16 (8192 < m <= 16384): launches on the slice's
        # main path at m = 8320, 16384 and 8208 (the pallas processor; #4:
        # the bench at 8320; #5: the pallas-seq steps); errors over the
        # checks at every m of CLUSTER16_MS; ms, plain and bound on 6
        # channel-sectors at m = 8320, every timed m's in times_by_m; its
        # kernels in the four part files of `sources` (8320's first,
        # 16384's second, P = 1's third)
        kernel_entry("fused_chain_power_radix (cluster of 16, 8192 < m <= 16384)",
                     CLUSTER16_SOURCES["radix"][0],
                     "wrp_tpu/ops/pallas/fullchain.py:809",
                     c16["launches"]["radix"],
                     {**c16["res"]["radix"], **c16["times"][8320]["radix"]},
                     m=8320, sources=CLUSTER16_SOURCES["radix"],
                     times_by_m={str(m): t["radix"]
                                 for m, t in c16["times"].items()},
                     f32_times_by_m={str(m): t["radix_f32"]
                                     for m, t in c16["times"].items()},
                     resident_clusters={str(m): r["radix"] for m, r
                                        in c16["resident"].items()}),
        kernel_entry("fused_chain_power_radix (offset, salt; cluster of 16)",
                     CLUSTER16_SOURCES["radix"][0],
                     "wrp_tpu/ops/pallas/fullchain.py:840",
                     c16["launches"]["radix_offset"],
                     {**c16["res"]["radix_offset"],
                      **c16["times"][8320]["radix_offset"]},
                     m=8320, sources=CLUSTER16_SOURCES["radix"],
                     times_by_m={str(m): t["radix_offset"]
                                 for m, t in c16["times"].items()}),
        kernel_entry("fused_chain_astage (cluster of 16, 8192 < m <= 16384)",
                     CLUSTER16_SOURCES["astage"][0],
                     "wrp_tpu/ops/pallas/fullchain.py:955",
                     c16["launches"]["astage"],
                     {**c16["res"]["astage"], **c16["times"][8320]["astage"]},
                     m=8320, sources=CLUSTER16_SOURCES["astage"],
                     times_by_m={str(m): t["astage"]
                                 for m, t in c16["times"].items()},
                     resident_clusters={str(m): r["astage"] for m, r
                                        in c16["resident"].items()}),
        kernel_entry("fused_chain_power_wire",
                     "wrp_tpu_torch/csrc/fused_chain_wire.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:1170", dev["wire"],
                     wire, supervised_worker_launches=[
                         supervised["wire_run1"], supervised["wire_run2"]],
                     hw_parity_launches=tools["hw_parity"]["wire"],
                     wire_ab_launches=tools["ab"]["launches"]["wire_ab"]["wire"],
                     decode_ab_launches=tools["ab"]["launches"]["decode_ab"]["wire"],
                     soak_device_decode_launches=last["soak"]["device-decode"]["wire"],
                     hw_demo_launches=demo["wire"],
                     matrix_route=long["matrix"]["wire"],
                     **occ["wire"]),
        # the cluster body (1024 < m <= 8192): launches on the long-ray
        # executor's device-decode run; errors over CLUSTER_CHECK_MS; ms,
        # plain and bound per 48 channel-sectors at m = 4096, every m's in
        # times_by_m
        kernel_entry("fused_chain_power_wire (cluster body, 1024 < m <= 8192)",
                     "wrp_tpu_torch/csrc/fused_chain_wire_cluster.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:1170", lr["wire"],
                     {**long["res"]["wire"], **long["at_4096"]["wire"]},
                     m=4096, times_by_m=long["times"]["wire"]),
        kernel_entry("fused_chain_power_wire (offset, salt; cluster body)",
                     "wrp_tpu_torch/csrc/fused_chain_wire_cluster.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:1210",
                     lr["wire_offset"],
                     {**long["res"]["wire_offset"],
                      **long["at_4096"]["wire_offset"]},
                     m=4096, times_by_m=long["times"]["wire_offset"]),
        # the cluster of 16 for the wire chain: launches on the slice's
        # main path at m = 8320, 16384 and 8208 (the fused wire processor;
        # #8: the wire bench at 8320); errors over the checks at every m
        # of CLUSTER16_MS; ms, plain and bound on 6 channel-sectors at m =
        # 8320, every timed m's in times_by_m; its kernels in the four
        # part files of `sources`
        kernel_entry("fused_chain_power_wire (cluster of 16, 8192 < m <= 16384)",
                     CLUSTER16_SOURCES["wire"][0],
                     "wrp_tpu/ops/pallas/fullchain.py:1170",
                     c16["launches"]["wire"],
                     {**c16["res"]["wire"], **c16["times"][8320]["wire"]},
                     m=8320, sources=CLUSTER16_SOURCES["wire"],
                     times_by_m={str(m): t["wire"]
                                 for m, t in c16["times"].items()},
                     resident_clusters={str(m): r["wire"] for m, r
                                        in c16["resident"].items()}),
        kernel_entry("fused_chain_power_wire (offset, salt; cluster of 16)",
                     CLUSTER16_SOURCES["wire"][0],
                     "wrp_tpu/ops/pallas/fullchain.py:1210",
                     c16["launches"]["wire_offset"],
                     {**c16["res"]["wire_offset"],
                      **c16["times"][8320]["wire_offset"]},
                     m=8320, sources=CLUSTER16_SOURCES["wire"],
                     times_by_m={str(m): t["wire_offset"]
                                 for m, t in c16["times"].items()}),
        kernel_entry("fused_chain_astage (cluster body, 1024 < m <= 8192)",
                     "wrp_tpu_torch/csrc/fused_chain_astage_cluster.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:955", lr["astage"],
                     {**long["res"]["astage"], **long["at_4096"]["astage"]},
                     m=4096, times_by_m=long["times"]["astage"]),
        kernel_entry("fused_chain_power_dense",
                     "wrp_tpu_torch/csrc/fused_chain_dense.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:194",
                     dense_launches["dense"], dense,
                     body=fullchain.chain_route(DENSE_M),
                     fft_body_launches=dense_launches["dense_fft"],
                     matrix_plain_ms=dense["matrix_plain_ms"],
                     long_ray_launches=lr["dense"], **occ["dense"]),
        # the dense entries' cluster route (radix-1 m = S x odd up to 8192):
        # launches and errors over CLUSTER_DENSE_MS (#1 and #2); ms, plain
        # and bound per 48 channel-sectors at LONG_DENSE_M; the one m left
        # on the long-ray body in long_ray_body
        kernel_entry("fused_chain_power_dense (cluster body, m = S x odd)",
                     "wrp_tpu_torch/csrc/fused_chain_radix_cluster.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:194",
                     long["dense"]["dense_cluster"], long["dense"],
                     m=long["dense"]["m"],
                     queued_ms=long["dense"]["queued_ms"],
                     matrix_kernel_ms=long["dense"]["matrix_ms"],
                     by_m=long["dense"]["by_m"],
                     long_ray_body=long["dense"]["long_body"]),
        kernel_entry("fused_chain_astage",
                     "wrp_tpu_torch/csrc/fused_chain_astage.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:955", shard["astage"],
                     astage, matmul_ms=astage["matmul_ms"],
                     hw_parity_launches=tools["hw_parity"]["astage"],
                     matrix_route=long["matrix"]["astage"],
                     blocks_per_sm=occ["astage"]["blocks_per_sm"]),
        kernel_entry("parseval_rows_power",
                     "wrp_tpu_torch/csrc/parseval_rows.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:998", shard["rows"],
                     rows, form="one read, float4 rows in registers, "
                     "persistent grid, 1 row a warp (two-pass form for other "
                     "n and alignments)",
                     queued_ms=rows["queued_ms"],
                     two_pass_queued_ms=rows["two_pass_queued_ms"],
                     two_pass_rel_l2=rows["two_pass_rel_l2"],
                     two_pass_max_abs_err=rows["two_pass_max_abs_err"],
                     host_ms=rows["host_ms"],
                     hw_parity_launches=tools["hw_parity"]["rows"],
                     long_ray_launches=lr["rows"],
                     blocks_per_sm=rows["blocks_per_sm"]),
        kernel_entry("fused_chain_power_at",
                     "wrp_tpu_torch/csrc/fused_chain_dense.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:271",
                     bench_launches["dense_offset"], offsets["dense"],
                     body=fullchain.chain_route(DENSE_M),
                     long_ray_launches=lr["dense_offset"]),
        kernel_entry("fused_chain_power_radix (offset, salt)",
                     "wrp_tpu_torch/csrc/fused_chain_radix_salted.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:840",
                     bench_launches["radix_offset"], offsets["radix"],
                     sharded_launches=sharded["launches"],
                     sharded_devices=sharded["devices"],
                     sharded_profile_traced=sharded["traced"],
                     wire_ab_launches=tools["ab"]["launches"]["wire_ab"]["radix_offset"],
                     ab_sweep_launches=last["ab_sweep"]["launches"]["radix_offset"]),
        kernel_entry("fused_chain_power_wire (offset, salt)",
                     "wrp_tpu_torch/csrc/fused_chain_wire_salted.cu",
                     "wrp_tpu/ops/pallas/fullchain.py:1210",
                     bench_launches["wire_offset"], offsets["wire"],
                     wire_ab_launches=tools["ab"]["launches"]["wire_ab"]["wire_offset"],
                     ab_sweep_launches=last["ab_sweep"]["launches"]["wire_offset"],
                     matrix_route=long["matrix"]["wire_offset"]),
        kernel_entry("fused_stage2", "wrp_tpu_torch/csrc/fused_stage2.cu",
                     "wrp_tpu/ops/pallas/postprocess.py:86",
                     stage2["launches"], stage2, form="3xTF32 wgmma",
                     operator_launches=stage2["operator_launches"],
                     hw_parity_launches=tools["hw_parity"]["stage2"],
                     long_ray_launches=lr["stage2"]),
        kernel_entry("radix_chain_ablation (dots; ms of each mode in 'modes')",
                     "wrp_tpu_torch/csrc/kernel_breakdown.cu",
                     "tools/kernel_breakdown.py:158",
                     probe["breakdown"]["launches"], probe["breakdown"],
                     form="bf16 wgmma, TMA, cluster-merged epilogue",
                     modes=probe["breakdown"]["modes"],
                     tensor_core_floor_ms=probe["breakdown"]["tensor_core_floor_ms"],
                     fft_entry_ms=probe["breakdown"]["fft_entry_ms"],
                     full_queued_ms=probe["breakdown"]["full_queued_ms"],
                     fft_entry_queued_ms=probe["breakdown"]["fft_entry_queued_ms"],
                     long_ray_launches=0),
        kernel_entry("tc_dot_probe (width 512, 512 steps)",
                     "wrp_tpu_torch/csrc/tc_occupancy.cu",
                     "tools/mxu_occupancy.py:110",
                     probe["tc"]["launches"], probe["tc"],
                     form="bf16 wgmma, TMA", blocks=probe["tc"]["blocks"],
                     library_form=probe["tc"]["library_form"],
                     library_batched_ms=probe["tc"]["library_batched_ms"],
                     library_kcat_ms=probe["tc"]["library_kcat_ms"],
                     long_ray_launches=0),
        kernel_entry("int_split_dot (int)", "wrp_tpu_torch/csrc/int_split.cu",
                     "tools/int_split_repro.py:85",
                     probe["split"]["launches"], probe["split"],
                     form="bf16 mma.sync, 32 x 32 tiles, split in registers",
                     blocks=probe["split"]["blocks"],
                     python_ms=probe["split"]["python_ms"],
                     library_python_ms=probe["split"]["library_python_ms"],
                     long_ray_launches=0),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
