from .executor import StreamingExecutor  # noqa: F401
from .volume import VolumeScan  # noqa: F401
from .metrics import StageTimers, Throughput, configure_logging  # noqa: F401
