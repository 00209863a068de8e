"""Multi-rank pipelines over torch.distributed (counterpart of
``wrp_tpu/parallel``): the mesh of ranks, the sharded steps and the
multi-host processors."""

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, init_distributed, make_mesh  # noqa: F401
from .halo import build_halo_processor  # noqa: F401
from .sharded import (build_sharded_processor, gather_batch,  # noqa: F401
                      shard_batch)
