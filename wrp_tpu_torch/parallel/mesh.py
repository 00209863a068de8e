"""Process groups for the sharded pipelines, over torch.distributed.

Counterpart of ``wrp_tpu/parallel/mesh.py``.  The JAX package lays a
[data, seq] mesh over devices, with several devices per process; here
there is one rank per device (rank k on ``cuda:(k % device_count)``), and
the ranks form the mesh along one of its two axes:

  * "data" — sectors/elevations (the independent batch axis): seq = 1,
    every rank its own sectors, no group (MultiHostProcessor);
  * "seq"  — the in-sector pulse/range split: seq = world, the all_to_all
    and all_gather run over every rank (PulseShardedProcessor).

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
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}


def make_mesh(seq: int = 1, device="cuda") -> Mesh:
    """The mesh of the joined ranks: seq = 1 (data-parallel, no group) or
    seq = world size (pulse-sharded, the whole group); one rank with seq 1
    when no process group exists."""
    if not dist.is_initialized():
        if seq != 1:
            raise ValueError(f"seq={seq} needs an initialised process group "
                             "(init_distributed)")
        return Mesh(rank=0, world=1, data=1, seq=1,
                    device=torch.device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    if seq not in (1, world):
        raise ValueError(f"seq={seq}: the ranks split either the batch "
                         f"(seq=1) or the pulses (seq={world})")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(rank=rank, world=world, data=world // seq, seq=seq,
                device=dev,
                seq_group=dist.group.WORLD if seq == world else None)
