"""Overlap-save halo exchange for the matched filter on a pulse-sharded mesh.

Counterpart of ``wrp_tpu/parallel/halo.py``, over torch.distributed (one
rank a device, parallel/mesh.py).  When the pulse axis stays sharded after
the Doppler stage (instead of sharded.py's all_to_all transpose), stages
05-07's circular convolution

    conv[j] = sum_k ma[k] * p[(j - k) mod n]

needs each shard's left neighbour's last (ma_count - 1) pulse columns: seq
rank s computes its columns from [halo from seq rank s-1 | local], the halo
moved by one send/receive pair in the row's seq group (circular: seq rank 0
receives from seq rank S-1, which closes the mod-n wrap).  The pulse sum
then reduces locally and one all_reduce over the seq group gives the full
stage-08 power.  The exchange moves (taps - 1) columns x m/2 rows x 4 bytes
per channel-sector to one neighbour.

Use when the batch is too small to fill the mesh data-parallel; for a full
batch, sharded.py's transpose formulation is the faster one.  The products
here are plain torch matmuls, as the JAX package computes them with XLA
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import RadarConfig, DEFAULT_CONFIG
from ..constants import PipelineConstants
from .. import pipeline
from .mesh import Mesh, make_mesh


def exchange_halo(tail: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Send this rank's `tail` [..., h] to seq rank (i + 1) mod S and
    return the tail of seq rank (i - 1) mod S, over one send/receive pair
    in the seq group."""
    send = tail.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, mesh.seq_rank(mesh.seq_index + 1),
                      group=mesh.seq_group),
           dist.P2POp(dist.irecv, recv, mesh.seq_rank(mesh.seq_index - 1),
                      group=mesh.seq_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def halo_conv(p_loc: torch.Tensor, halo: torch.Tensor, taps) -> torch.Tensor:
    """The overlap-save sum on one shard: local power columns
    [..., n_loc] and the left neighbour's last len(taps) - 1 columns ->
    the local matched-filter output [..., n_loc]."""
    w = [float(t) for t in np.asarray(taps)]
    h = len(w) - 1
    ext = torch.cat([halo, p_loc], dim=-1)            # [..., h + n_loc]
    out = w[0] * ext[..., h:]
    for k in range(1, h + 1):
        out = out + w[k] * ext[..., h - k:-k]
    return out


def matched_filter_halo(p_loc: torch.Tensor, taps, mesh: Mesh) -> torch.Tensor:
    """This rank's local power columns [..., n_loc] -> its matched-filter
    output [..., n_loc]; the shards of a seq row partition the pulse axis
    in seq order.  At seq = 1 the circular filter itself."""
    if mesh.seq == 1:
        return pipeline.matched_filter_direct(p_loc, taps)
    h = len(np.asarray(taps)) - 1
    return halo_conv(p_loc, exchange_halo(p_loc[..., -h:], mesh), taps)


def build_halo_processor(cfg: RadarConfig = DEFAULT_CONFIG,
                         mesh: Mesh | None = None, device=None):
    """The full chain with the pulse axis sharded end to end (no
    transpose): the range stage by the A operator (local: it contracts over
    range rows, which every shard holds), the Doppler stage by this rank's
    columns of the B operator on Y gathered once over the seq group, then
    the halo matched filter, the local pulse sum and an all_reduce.

    Returns this rank's step: `step(x_local) -> (zdb, zdr)` [b, m/2] on its
    device, where x_local is planar IQ [b, C, 2, m, n/seq] (int16 or f32),
    its data row's sectors and its seq index's pulses (`step.layout` is
    "mesh", the layout `shard_batch` cuts)."""
    cfg.validate()
    if mesh is None:
        mesh = make_mesh(device=device or "cuda")
    seq = mesh.seq
    n = cfg.num_pulses
    if n % seq:
        raise ValueError(f"n={n} must divide by seq={seq}")
    n_loc = n // seq
    consts = PipelineConstants.build(cfg)
    halo_cols = len(consts.ma_taps) - 1
    if seq > 1 and n_loc < halo_cols:
        # one neighbour's tail must cover the whole overlap: with fewer
        # columns the slices would clamp and the filter silently cover the
        # wrong columns (the pulse sum hides any shape error)
        raise ValueError(
            f"pulse shard n/seq = {n_loc} is smaller than the matched "
            f"filter overlap ({halo_cols} columns); use seq <= "
            f"{n // halo_cols} or the transpose formulation")
    dev = pipeline.resolve_device(device if device is not None
                                  else mesh.device)
    dc = pipeline._DeviceConstants(consts, dev)
    col0 = mesh.seq_index * n_loc
    br_loc = dc.br[:, col0:col0 + n_loc].contiguous()
    bi_loc = dc.bi[:, col0:col0 + n_loc].contiguous()

    def gather_pulses(y):
        parts = [torch.empty_like(y) for _ in range(seq)]
        dist.all_gather(parts, y.contiguous(), group=mesh.seq_group)
        return torch.cat(parts, dim=-1)

    def step(x_local):
        x = torch.as_tensor(x_local).to(dev, non_blocking=True)
        xf = x.to(torch.float32)
        yr, yi = pipeline._rmatmul(dc.ar, dc.ai, xf[:, :, 0], xf[:, :, 1])
        if seq > 1:
            yr, yi = gather_pulses(yr), gather_pulses(yi)
        zr, zi = pipeline._rmatmul(yr, yi, br_loc, bi_loc)
        p_loc = zr * zr + zi * zi                     # [b, C, m/2, n_loc]
        pw = matched_filter_halo(p_loc, consts.ma_taps, mesh).sum(dim=-1)
        if seq > 1:
            dist.all_reduce(pw, op=dist.ReduceOp.SUM, group=mesh.seq_group)
        return pipeline.stage09_10_products(pw[:, 0], pw[:, 1], dc.gain)

    step.layout = "mesh"
    return step
