"""wrp_tpu_torch — the weather-radar chain in PyTorch and CUDA for NVIDIA Hopper.

The port of ``wrp_tpu`` (JAX on a TPU), which stays beside it as the
reference: IQ on the UDP wire -> host decode -> the fused chain (one
hand-written CUDA kernel, ops/fullchain.py) -> reflectivity zdb and
differential reflectivity zdr -> egress and volume accumulation.  Module
names mirror ``wrp_tpu``'s.  This package imports torch and numpy, never
JAX and never ``wrp_tpu``.
"""

from .config import RadarConfig, DEFAULT_CONFIG, tiny_config  # noqa: F401
from .constants import PipelineConstants  # noqa: F401
from .pipeline import SectorProcessor, process_sectors  # noqa: F401

__version__ = "0.1.0"
