"""ctypes binding for the native UDP sector ingest loop (ingest.cpp).

The port's counterpart of ``wrp_tpu/native/ingest_native.py``.  ctypes
releases the GIL for the call, so the reassembly of sector k + 1 (m
datagrams) runs beside the compute thread's work on sector k.  The library
is built at the first call (build.py); a failure raises.
"""

from __future__ import annotations

import numpy as np

from .build import load_library


def recv_sector(fd: int, timeout_ms: int, out: bytearray | np.ndarray,
                rows: int, row_bytes: int, stats: np.ndarray,
                hdr: np.ndarray) -> int:
    """Receive one sector into `out` (rows * row_bytes bytes) from the
    blocking datagram socket `fd` (timeout_ms <= 0: no timeout).

    stats: int64[5] (datagrams, dropped_datagrams, dropped_sectors,
    timeouts, duplicate_datagrams), incremented in place.  hdr: int32[3]
    (has_header, sector, elevation), written.  Returns 1 ok, 0 idle,
    -1 stall (the partial sector dropped), -2 socket error.
    """
    buf = np.frombuffer(out, np.uint8)
    if buf.size < rows * row_bytes or not buf.flags.writeable:
        raise ValueError(f"out must be a writeable buffer of >= "
                         f"{rows * row_bytes} bytes, got {buf.size}")
    for a, dtype, size in ((stats, np.int64, 5), (hdr, np.int32, 3)):
        if (a.dtype != dtype or a.size != size
                or not a.flags.c_contiguous or not a.flags.writeable):
            raise ValueError(f"stats must be int64[5] and hdr int32[3], "
                             f"contiguous and writeable; got {a.dtype} "
                             f"{a.shape}")
    return load_library().wrp_udp_recv_sector(
        fd, timeout_ms, buf.ctypes.data, rows, row_bytes, stats.ctypes.data,
        hdr.ctypes.data)
