"""ctypes binding for the native UDP sector ingest loop (ingest.cpp).

The port's counterpart of ``wrp_tpu/native/ingest_native.py``.  ctypes
releases the GIL for the call, so the reassembly of sector k + 1 (m
datagrams) runs beside the compute thread's work on sector k.  A `Drain`
keeps a native thread reading the socket between those calls too.  The
library is built at the first call (build.py); a failure raises.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

from .build import load_library


def _checked(out, rows: int, row_bytes: int, stats: np.ndarray,
             hdr: np.ndarray) -> np.ndarray:
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
    return buf


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
    buf = _checked(out, rows, row_bytes, stats, hdr)
    return load_library().wrp_udp_recv_sector(
        fd, timeout_ms, buf.ctypes.data, rows, row_bytes, stats.ctypes.data,
        hdr.ctypes.data)


class Drain:
    """A native thread that moves every datagram of the socket `fd` into a
    ring of `nslots` slots of `slot_bytes` in user memory, from start to
    close(), without the GIL.  The kernel's receive buffer then only has
    to bridge that thread's wake-ups, not the receiving Python thread's
    waits for the GIL.  A full ring leaves datagrams in the socket.

    close() stops the thread (a receive waiting on it returns -2 once the
    ring is empty) and must come before the socket is closed."""

    def __init__(self, fd: int, slot_bytes: int, nslots: int):
        lib = load_library()
        self._lib = lib
        self._h = lib.wrp_udp_drain_start(fd, slot_bytes, nslots)
        self._lock = threading.Lock()       # held by a receive in progress
        self._closing = threading.Lock()
        self._free = weakref.finalize(self, lib.wrp_udp_drain_free, self._h)

    def recv_sector(self, timeout_ms: int, out: bytearray | np.ndarray,
                    rows: int, row_bytes: int, stats: np.ndarray,
                    hdr: np.ndarray) -> int:
        """`recv_sector` on the ring: the same arguments without the
        socket, the same returns; -2 after close()."""
        buf = _checked(out, rows, row_bytes, stats, hdr)
        with self._lock:
            if not self._free.alive:
                return -2
            return self._lib.wrp_udp_drain_recv_sector(
                self._h, timeout_ms, buf.ctypes.data, rows, row_bytes,
                stats.ctypes.data, hdr.ctypes.data)

    def close(self) -> None:
        with self._closing:
            if self._free.alive:
                self._lib.wrp_udp_drain_stop(self._h)
                with self._lock:
                    self._free()
