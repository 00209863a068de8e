"""The sharded pipelines over torch.distributed.

Counterpart of ``wrp_tpu/parallel/sharded.py``, with one rank per device
(parallel/mesh.py) in place of shard_map over a device mesh.  Each rank's
step takes its own shard and returns (zdb, zdr) for its batch rows:

* data axis — sectors are independent problems; the batch is split over
  ranks with no communication ("pallas": the fused kernel per rank).
* seq axis — inside a sector the chain alternates between "needs the full
  range axis" (the range DFT) and "needs the full pulse axis" (Doppler or
  Parseval).  Each rank of a seq group holds n/seq pulses of every sector
  of its batch: stage A runs on the pulse slab, one all_to_all over the
  seq group re-shards the half-spectrum onto m/2/seq range rows with all
  n pulses, the pulse stages run on the row shard, and an all_gather of
  the [m/2/seq] powers gives every rank the full products ("pallas-seq",
  "mxu", "fft").

Collectives run only when seq > 1, as in ``wrp_tpu``.  They use
`all_to_all_single` and `all_gather` (a list), which exist in every torch
this port runs on; gloo carries CPU tensors, NCCL CUDA tensors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..config import RadarConfig, DEFAULT_CONFIG
from ..constants import PipelineConstants, hamming_factors
from .. import pipeline
from .mesh import Mesh, make_mesh

METHODS = ("pallas", "pallas-seq", "mxu", "fft")


def split_rows(y: torch.Tensor, seq: int) -> torch.Tensor:
    """[..., rows, w] -> [seq, ..., rows/seq, w]: chunk k of the rows,
    destined for seq rank k, first (the send buffer of the all_to_all)."""
    *lead, rows, w = y.shape
    return y.reshape(*lead, seq, rows // seq, w).movedim(-3, 0).contiguous()


def join_pulses(recv: torch.Tensor) -> torch.Tensor:
    """[seq, ..., r, w] received chunks (chunk k from seq rank k, which
    holds pulses k w .. (k+1) w - 1) -> [..., r, seq w], the pulses
    concatenated in source-rank order."""
    seq, *lead, r, w = recv.shape
    return recv.movedim(0, -2).reshape(*lead, r, seq * w)


def rows_to_pulses(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The transpose collective: pulse-sharded spectra [..., rows, n/seq]
    -> range-row-sharded full-pulse rows [..., rows/seq, n]."""
    send = split_rows(y, mesh.seq)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.seq_group)
    return join_pulses(recv)


def gather_rows(p_loc: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[..., rows/seq] row-shard powers -> [..., rows] on every seq rank."""
    parts = [torch.empty_like(p_loc) for _ in range(mesh.seq)]
    dist.all_gather(parts, p_loc.contiguous(), group=mesh.seq_group)
    return torch.cat(parts, dim=-1)


def _shard_body(iq: torch.Tensor, consts: PipelineConstants, dc,
                cfg: RadarConfig, method: str, mesh: Mesh):
    """Per-rank body of "mxu" and "fft": planar iq [b, C, 2, m, n/seq]
    -> (zdb, zdr) [b, m/2].  Real dataflow except inside the fft method."""
    m, n = cfg.num_range_cells, cfg.num_pulses
    n_loc = n // mesh.seq
    xf = iq.to(torch.float32)
    xr, xi = xf[:, :, 0], xf[:, :, 1]
    if method == "mxu":
        yr, yi = pipeline._rmatmul(dc.ar, dc.ai, xr, xi)
        y = torch.stack([yr, yi], dim=2)                  # [b, C, 2, m/2, n_loc]
    else:
        # the range factor is whole here; the pulse factor is this rank's
        # slice of the global pulse window
        wr, wd, c = hamming_factors(cfg)
        col0 = mesh.seq_index * n_loc
        win = torch.from_numpy(np.outer(wr * c, wd[col0:col0 + n_loc])
                               .astype(np.float32)).to(iq.device)
        x = torch.fft.fft(torch.complex(xr, xi) * win, dim=-2)[..., : m // 2, :]
        y = torch.stack([x.real, x.imag], dim=2)
    if mesh.seq > 1:
        y = rows_to_pulses(y, mesh)                       # [b, C, 2, m/2/seq, n]
    if method == "mxu":
        zr, zi = pipeline._rmatmul(y[:, :, 0], y[:, :, 1], dc.br, dc.bi)
        p = zr * zr + zi * zi
    else:
        z = pipeline.stage03_doppler(torch.complex(y[:, :, 0], y[:, :, 1]))
        p = z.real ** 2 + z.imag ** 2
    pow_loc = pipeline.stage08_pulse_sum(
        pipeline.matched_filter_direct(p, consts.ma_taps))  # [b, C, m/2/seq]
    pow_all = gather_rows(pow_loc, mesh) if mesh.seq > 1 else pow_loc
    return pipeline.stage09_10_products(pow_all[:, 0], pow_all[:, 1], dc.gain)


def build_sharded_processor(cfg: RadarConfig = DEFAULT_CONFIG,
                            mesh: Mesh | None = None, method: str = "mxu",
                            wire_input: bool = False,
                            device=None,
                            consts: PipelineConstants | None = None
                            ) -> Callable:
    """This rank's step: `step(x_local) -> (zdb, zdr)` [b, m/2] tensors on
    its device, the device work enqueued.

    method="mxu"|"fft": the transpose-FFT seq sharding; x_local is planar
    IQ [b, C, 2, m, n/seq] (int16 or f32), this rank's pulse slice.
    method="pallas": the fused kernel, data-parallel; x_local is the
    rank's own sectors [b, C, 2, m, n]; no collective.
    method="pallas-seq": the fused chain split at its communication point:
    the A-stage kernel on the [b C, 2, m, n/seq] slab, the all_to_all onto
    [b C, 2, m/2/seq, n] rows, the row-epilogue kernel, the all_gather of
    the powers.  wire_input=True (pallas-seq only) takes this rank's
    pulse-byte columns of the wire rows, uint8 [b, m, n/seq * bps], and
    decodes them on the device first.

    n and m/2 must divide by seq.  device defaults to the mesh's.  The step
    names the input layout it takes as `step.layout`: "data" (pallas),
    "mesh" (the others), "wire" (pallas-seq with wire_input); `shard_batch`
    cuts the first two from a host batch.  consts: the chain's constants
    (default: built from cfg, as SectorProcessor's)."""
    cfg.validate()
    if mesh is None:
        mesh = make_mesh(device=device or "cuda")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}: use one of {METHODS}")
    if wire_input and method != "pallas-seq":
        raise ValueError("wire_input is the pallas-seq on-device decode; "
                         f"method {method!r} takes planar input")
    dev = pipeline.resolve_device(device if device is not None
                                  else mesh.device)
    consts = consts if consts is not None else PipelineConstants.build(cfg)
    m, n = cfg.num_range_cells, cfg.num_pulses
    mh = m // 2
    if method == "pallas":
        proc = pipeline.SectorProcessor(cfg, method="pallas", device=dev,
                                        consts=consts)
        proc.layout = "data"
        return proc
    if n % mesh.seq or mh % mesh.seq:
        raise ValueError(f"n={n} and m/2={mh} must divide by seq={mesh.seq}")
    if method == "pallas-seq":
        step = _build_pallas_seq(cfg, consts, mesh, dev, wire_input)
        step.layout = "wire" if wire_input else "mesh"
        return step
    dc = pipeline._DeviceConstants(consts, dev)

    def step(x_local):
        x = torch.as_tensor(x_local).to(dev, non_blocking=True)
        return _shard_body(x, consts, dc, cfg, method, mesh)

    step.layout = "mesh"
    return step


def gather_batch(t: torch.Tensor, mesh: Mesh, layout: str) -> torch.Tensor:
    """The inverse of shard_batch for a step's output: every rank's rows
    [b, ...] -> the whole batch on every rank, over the world group.
    "data" holds the batch in rank order; "mesh" in data-row order, from
    seq index 0 of each row (the row's ranks hold equal rows)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t)
    return torch.cat(parts[::mesh.seq] if layout == "mesh" else parts)


def shard_batch(iq, mesh: Mesh, layout: str = "mesh") -> torch.Tensor:
    """Host batch -> this rank's part of it, on its device.

    iq: complex [B, C, m, n] (made planar f32 on the host) or planar
    [B, C, 2, m, n] (its dtype kept).  layout (a step's `layout`):
    "mesh": data row d's B/data sectors and seq index s's n/seq pulse
    columns (wrp_tpu's iq_sharding); "data": the rank's B/world sectors,
    all pulses (iq_sharding_flat, the batch over every rank)."""
    return torch.from_numpy(host_share(iq, mesh, layout)).to(mesh.device)


def host_share(iq, mesh: Mesh, layout: str = "mesh") -> np.ndarray:
    """shard_batch's cut on the host: this rank's part of `iq`, a
    contiguous planar numpy array (no copy to the device)."""
    x = np.asarray(iq)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag], axis=-3).astype(np.float32)
    if x.ndim != 5 or x.shape[2] != 2:
        raise ValueError(f"expected planar [B, C, 2, m, n] or complex "
                         f"[B, C, m, n]; got {np.asarray(iq).shape}")
    b, n = x.shape[0], x.shape[-1]
    if layout == "data":
        parts, k = mesh.world, mesh.rank
        cols = slice(None)
    elif layout == "mesh":
        parts, k = mesh.data, mesh.data_index
        if n % mesh.seq:
            raise ValueError(f"n={n} must divide by seq={mesh.seq}")
        w = n // mesh.seq
        cols = slice(mesh.seq_index * w, (mesh.seq_index + 1) * w)
    else:
        raise ValueError(f"layout {layout!r}: shard_batch cuts 'mesh' or "
                         "'data'")
    if b % parts:
        raise ValueError(f"batch {b} must divide by {parts} ({layout} "
                         f"layout of a {mesh.data}x{mesh.seq} mesh)")
    rows = slice(k * (b // parts), (k + 1) * (b // parts))
    return np.ascontiguousarray(x[rows, ..., cols])


def _build_pallas_seq(cfg, consts, mesh, dev, wire_input):
    """The fused chain seq-sharded over pulses: A-stage kernel per pulse
    slab (the register body up to 1024 range cells, the cluster body up to
    16384, the matrix form where it refuses m: m's route,
    `fullchain.chain_route`),
    all_to_all, row-epilogue kernel per row shard, all_gather of the
    powers.  The same range DFT and epilogue
    as the fused kernel, so the products agree with it to fp32
    reassociation."""
    from ..ops import device_codec
    from ..ops.fullchain import (build_plan, fused_chain_astage,
                                 parseval_rows_power, radix_for)

    m, n = cfg.num_range_cells, cfg.num_pulses
    if radix_for(m) < 2:
        raise ValueError(
            f"pallas-seq needs the radix kernel plan (m={m} supports radix "
            "1 only); use method='mxu' at this geometry")
    plan = build_plan(consts, dev)
    gain = torch.from_numpy(consts.gain).to(dev)
    n_loc = n // mesh.seq
    rows = m // 2 // mesh.seq

    def step(x_local):
        x = torch.as_tensor(x_local).to(dev, non_blocking=True)
        if wire_input:
            # [b, m, n_loc * bps] bytes -> [b, C, 2, m, n_loc] int16
            x = device_codec.decode_wire_i16(x.reshape(x.shape[0], -1), cfg,
                                             num_pulses=n_loc)
        b, c, two, m_, w = x.shape
        y = fused_chain_astage(x.reshape(b * c, two, m_, w).contiguous(), plan)
        if mesh.seq > 1:
            y = rows_to_pulses(y, mesh)          # [b c, 2, m/2/seq, n]
        p = parseval_rows_power(y.contiguous(), plan).reshape(b, c, rows)
        if mesh.seq > 1:
            p = gather_rows(p, mesh)
        return pipeline.stage09_10_products(p[:, 0], p[:, 1], gain)

    return step
