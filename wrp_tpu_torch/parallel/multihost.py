"""Multi-host (multi-process) scaling of the radar chain over torch.distributed.

Counterpart of ``wrp_tpu/parallel/multihost.py``, one rank per device
(parallel/mesh.py).  Two modes, each the `processor=` override of a
lock-step `StreamingExecutor` (`cli stream --coordinator ...`):

* `MultiHostProcessor` — data-parallel: each rank ingests its own feed
  and computes its own sectors; no collective in the step.
* `PulseShardedProcessor` — every rank ingests the SAME broadcast wire and
  computes a 1/N pulse slice of every sector; the step's all_to_all and
  all_gather cross the ranks (parallel/sharded.py), so every rank gets the
  full products of every sector (N-way redundancy), and a silent peer
  blocks the step, which is what the executor's collective timeout bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RadarConfig, DEFAULT_CONFIG
from .mesh import Mesh, init_distributed, make_mesh  # noqa: F401
from .sharded import build_sharded_processor


@dataclasses.dataclass
class MultiHostProcessor:
    """Data-parallel: this rank's products for the sectors it fed.

        proc = MultiHostProcessor.build(cfg, per_host_batch=16)
        zdb, zdr = proc.step_local(local_planar)   # [16, C, 2, m, n]
    """

    cfg: RadarConfig
    mesh: Mesh
    per_host_batch: int
    _step: Callable
    _local_shape: tuple

    @classmethod
    def build(cls, cfg: RadarConfig = DEFAULT_CONFIG, per_host_batch: int = 16,
              method: str = "mxu", device="cuda") -> "MultiHostProcessor":
        cfg.validate()
        mesh = make_mesh(seq=1, device=device)
        step = build_sharded_processor(cfg, mesh, method=method,
                                       device=mesh.device)
        c, m, n = cfg.sector_shape
        return cls(cfg=cfg, mesh=mesh, per_host_batch=per_host_batch,
                   _step=step, _local_shape=(per_host_batch, c, 2, m, n))

    def step_local(self, local_planar):
        """[per_host_batch, C, 2, m, n] -> (zdb, zdr) [per_host_batch, m/2]
        tensors on this rank's device."""
        if tuple(local_planar.shape) != self._local_shape:
            raise ValueError(f"expected {self._local_shape}, got "
                             f"{tuple(local_planar.shape)}")
        return self._step(local_planar)


@dataclasses.dataclass
class PulseShardedProcessor:
    """Sequence parallelism across ranks: every rank ingests the same
    broadcast wire (the reference's producer sends to INADDR_BROADCAST,
    udpbroadcast.cpp:30) and computes pulses [k n/N, (k+1) n/N) of every
    sector; the seq group is all N ranks.  Every rank feeds the full batch
    and gets the full [batch, m/2] products back."""

    cfg: RadarConfig
    mesh: Mesh
    batch: int
    wire_input: bool
    _step: Callable
    _pulse_slice: slice
    _local_shape: tuple

    @classmethod
    def build(cls, cfg: RadarConfig = DEFAULT_CONFIG, batch: int = 16,
              method: str = "mxu", device_decode: bool = False,
              device="cuda") -> "PulseShardedProcessor":
        """method: "mxu" | "fft" (the transpose-FFT torch paths) | "pallas"
        (the fused chain seq-sharded: the A-stage kernel per pulse slice,
        the all_to_all, the row-epilogue kernel; sharded.py "pallas-seq").

        device_decode (pallas only): step_local takes raw wire bytes
        [batch, sector_nbytes_wire] uint8; each rank slices its 1/N
        pulse-byte columns and decodes them on its device."""
        if device_decode and method != "pallas":
            raise ValueError("device_decode (on-device wire decode) requires "
                             "method='pallas'")
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(seq=world, device=device)
        # "pallas" means the seq-sharded fused chain here: pulse sharding is
        # this processor's whole point, and the data-parallel pallas layout
        # ignores the seq axis
        build_method = "pallas-seq" if method == "pallas" else method
        step = build_sharded_processor(cfg, mesh, method=build_method,
                                       wire_input=device_decode,
                                       device=mesh.device)
        c, m, n = cfg.sector_shape
        n_loc = n // world
        k = mesh.seq_index
        local_shape = ((batch, cfg.sector_nbytes_wire) if device_decode
                       else (batch, c, 2, m, n))
        return cls(cfg=cfg, mesh=mesh, batch=batch, wire_input=device_decode,
                   _step=step, _pulse_slice=slice(k * n_loc, (k + 1) * n_loc),
                   _local_shape=local_shape)

    def step_local(self, planar, labels: Optional[np.ndarray] = None):
        """The full batch [batch, C, 2, m, n] (every rank passes the same
        sectors, decoded from the shared wire), or with wire_input the raw
        wire bytes [batch, sector_nbytes_wire] uint8 -> (zdb, zdr)
        [batch, m/2], the FULL products, as tensors on this rank's device.

        labels: optional [batch, 2] int32 (sector, elevation) rows, -1
        padding.  When given, the batch's alignment is checked across ranks
        before the step: the all_to_all mixes each slot's pulse columns from
        every rank, so one rank that dropped a wire sector would corrupt
        every product from that slot on.  The check turns that into a
        RuntimeError on every rank (which the lock-step executor turns into
        its bounded exit).  The executor passes labels itself."""
        if tuple(planar.shape) != self._local_shape:
            raise ValueError(f"expected {self._local_shape}, got "
                             f"{tuple(planar.shape)}")
        if labels is not None:
            self._check_aligned(labels)
        if self.wire_input:
            # wire rows are [m, n * bps] bytes with the channels interleaved
            # per sample, so this rank's pulses are a byte column slice:
            # 1/N of the wire bytes reach the device
            c, m, n = self.cfg.sector_shape
            bps = self.cfg.bytes_per_sample
            sl = slice(self._pulse_slice.start * bps,
                       self._pulse_slice.stop * bps)
            rows = torch.as_tensor(planar).reshape(self.batch, m, n * bps)
            local = rows[:, :, sl]
        else:
            local = torch.as_tensor(planar)[..., self._pulse_slice]
        return self._step(local.contiguous())

    def _check_aligned(self, labels) -> None:
        lab = np.asarray(labels, np.int32)
        if lab.shape != (self.batch, 2):
            raise ValueError(f"labels must be [{self.batch}, 2] "
                             f"(sector, elevation); got {lab.shape}")
        if self.mesh.seq_group is None:      # one process, no group
            return
        mine = torch.from_numpy(lab).to(self.mesh.device)
        parts = [torch.empty_like(mine) for _ in range(self.mesh.seq)]
        dist.all_gather(parts, mine, group=self.mesh.seq_group)
        allv = torch.stack(parts).cpu().numpy()
        ref = allv[0]
        bad = np.argwhere((allv != ref[None]).any(axis=2))
        if len(bad):
            p, i = (int(v) for v in bad[0])
            raise RuntimeError(
                f"pulse-shard batch misaligned across ranks: slot {i} is "
                f"(sector, elevation) {tuple(ref[i])} on rank 0 but "
                f"{tuple(allv[p, i])} on rank {p}; a feed dropped or "
                "reordered a wire sector; refusing the step before the "
                "all_to_all mixes pulse columns of different sectors")
