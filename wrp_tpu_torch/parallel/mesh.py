"""Process groups for the sharded pipelines, over torch.distributed.

Counterpart of ``wrp_tpu/parallel/mesh.py``.  The JAX package lays a
[data, seq] mesh over devices, with several devices per process; here
there is one rank per device (rank k on ``cuda:(k % device_count)``), and
the ranks form the same [data, seq] mesh, row-major: rank r sits in data
row r // seq at seq index r % seq.

  * "data" — sectors/elevations (the independent batch axis): each data
    row takes its own sectors, no communication between rows;
  * "seq"  — the in-sector pulse/range split: the ranks of one row hold the
    pulse (or range-row) slices of the same sectors, and the all_to_all,
    all_gather, halo exchange and power reduction run over the row's
    process group, `Mesh.seq_group`.

seq = 1 is the data-parallel mesh (MultiHostProcessor), seq = world the
pulse-sharded one (PulseShardedProcessor).

NCCL carries the collectives of CUDA tensors, gloo those of CPU tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device="cuda", timeout_s: Optional[float] = None
                     ) -> torch.device:
    """Join the process group (a second call does nothing) and return this
    rank's device.

    coordinator: "host:port" of rank 0 (or a full "tcp://host:port").
    device: "cuda" gives NCCL and cuda:(process_id % device_count); "cpu"
    gives gloo.  A CUDA request without CUDA raises; nothing falls back to
    gloo or the CPU.  timeout_s: the group's collective timeout.  A
    lock-step executor with a collective timeout needs a larger one here,
    or the backend's own watchdog may end the process before the
    executor's bounded exit (checkpoint, exit 3) runs."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA requested but not "
                               "available; pass device='cpu' for gloo")
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"init_distributed: unsupported device {dev}")
    if dist.is_initialized():
        return dev
    method = (coordinator if coordinator.startswith("tcp://")
              else f"tcp://{coordinator}")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=method, world_size=num_processes,
                            rank=process_id, **kw)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the [data, seq] mesh of ranks."""

    rank: int
    world: int
    data: int
    seq: int
    device: torch.device
    seq_group: Optional[object] = None   # process group of this rank's seq row

    @property
    def seq_index(self) -> int:
        return self.rank % self.seq

    @property
    def data_index(self) -> int:
        return self.rank // self.seq

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}

    def seq_rank(self, index: int) -> int:
        """The global rank at seq index `index` (mod seq) of this row."""
        return self.data_index * self.seq + index % self.seq


def make_mesh(data: Optional[int] = None, seq: int = 1,
              device="cuda") -> Mesh:
    """The [data, seq] mesh of the joined ranks; data=None takes
    world // seq.  data x seq must equal the world size.  Without a
    process group: one rank, a 1 x 1 mesh.

    Each data row's ranks form its seq group: every rank creates every
    row's group, in row order, as `dist.new_group` requires.  With one row
    the group is the world group itself; with several rows of one rank
    (seq = 1) there is none, since no collective runs along a one-rank
    axis."""
    if seq < 1 or (data is not None and data < 1):
        raise ValueError(f"a {data}x{seq} mesh: each axis must be >= 1")
    if not dist.is_initialized():
        if seq != 1 or data not in (None, 1):
            raise ValueError(f"a {data or 1}x{seq} mesh needs an "
                             "initialised process group (init_distributed)")
        return Mesh(rank=0, world=1, data=1, seq=1,
                    device=torch.device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    if data is None:
        if world % seq:
            raise ValueError(f"{world} ranks not divisible by seq={seq}")
        data = world // seq
    if data * seq != world:
        raise ValueError(f"mesh {data}x{seq} needs {data * seq} ranks, "
                         f"the group has {world}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    group = None
    if data == 1:
        group = dist.group.WORLD
    elif seq > 1:
        for row in range(data):
            g = dist.new_group(list(range(row * seq, (row + 1) * seq)))
            if row == rank // seq:
                group = g
    return Mesh(rank=rank, world=world, data=data, seq=seq, device=dev,
                seq_group=group)
