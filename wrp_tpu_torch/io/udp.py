"""UDP ingest/egress — wire-compatible with the reference v1 pipeline.

Reference behaviour (read_single.cc:125-148, udpbroadcast.cpp):
  * ingest: one sector = m datagrams x (bytes_per_sample * n) bytes on
    port 19001, strictly in row order, blocking recv with no timeout;
  * egress: zdb/zdr frames broadcast to ports 19002/19003.

Like ``wrp_tpu.io.udp`` this fixes the reference's silent-corruption modes
(SURVEY.md section 5): a receive timeout, sector resynchronisation on drops
(count-based for bare v1 datagrams, header-based with frames.IngestHeader),
and drop accounting.  Reassembly runs in the GIL-free C++ loop
(native/ingest.cpp, built with g++ at first use; a build failure raises)
unless the caller passes native=False; then the Python loop runs, with the
same results and stats.  The native loop reads a ring that a native thread
fills from the socket, so a clamped kernel receive buffer does not turn the
receiving thread's waits for the GIL into lost datagrams.
"""

from __future__ import annotations

import logging
import socket
import time
import weakref
from typing import Optional

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG
from ..native import ingest_native
from . import frames
from .stats import IngestStats

log = logging.getLogger("wrp_tpu_torch")


class UdpIngest:
    """Reassembles sectors from per-pulse-row datagrams.

    With bare v1 datagrams, rows are assumed in order (the reference's
    contract); a timeout mid-sector drops the partial sector and resyncs.
    With extended headers (frames.IngestHeader) rows are placed by index and
    loss is detected exactly.
    """

    def __init__(
        self,
        cfg: RadarConfig = DEFAULT_CONFIG,
        port: int | None = None,
        host: str = "",
        timeout_s: Optional[float] = None,
        rcvbuf_bytes: int = 1 << 27,
        reuse_port: bool = False,
        native: bool = True,
    ):
        """native: reassemble in the C++ loop without the GIL
        (native/ingest.cpp), fed by a native drain thread that moves the
        socket's datagrams into a ring of rcvbuf_bytes in user memory from
        bind to close(), so the buffer asked for exists even where the
        kernel clamps SO_RCVBUF; False runs the Python loop on the socket.

        reuse_port: bind with SO_REUSEPORT, so that the N ranks of a
        pulse-sharded fleet on one host can read ONE broadcast port
        (broadcast datagrams reach every bound socket).  Off by default:
        for unicast traffic the kernel routes each sender to one of the
        bound sockets, so an accidental port collision between two feeds
        would split them silently."""
        self.cfg = cfg
        self.port = port if port is not None else cfg.udp_ingest_port
        self.stats = IngestStats()
        self._row_bytes = cfg.datagram_nbytes
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  rcvbuf_bytes)
        except OSError:
            pass
        # Linux silently clamps SO_RCVBUF to net.core.rmem_max (and
        # getsockopt reports twice the effective size); an undersized
        # buffer is the reference's silent datagram-loss mode, so say so.
        got = self._sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
        if got < 2 * rcvbuf_bytes:
            log.warning(
                "UDP receive buffer clamped to %.1f MB (requested %.0f MB);"
                " raise net.core.rmem_max to avoid burst drops",
                got / 2 / 1e6, rcvbuf_bytes / 1e6)
        self._sock.bind((host, self.port))
        self._native = native
        if native:
            ingest_native.load_library()    # build now: a failure raises here
            # the drain thread blocks in recv (SO_RCVTIMEO bounds it), so
            # the socket must be blocking; the C++ loop waits on the ring
            # and treats timeout_ms <= 0 as no timeout, so a sub-ms
            # timeout rounds up
            self._sock.setblocking(True)
            self._timeout_ms = (max(1, int(timeout_s * 1000))
                                if timeout_s is not None else -1)
            self._nstats = np.zeros(5, np.int64)
            self._nhdr = np.zeros(3, np.int32)
            slot = self._row_bytes + frames.IngestHeader.SIZE
            self._drain = ingest_native.Drain(
                self._sock.fileno(), slot, max(1, rcvbuf_bytes // slot))
        else:
            self._sock.settimeout(timeout_s)
            self._drain = None
        # the drain thread stops before the socket closes (its descriptor
        # must not be reused under it), on close() or collection
        self._close = weakref.finalize(self, _close_ingest, self._drain,
                                       self._sock)
        # Full-datagram scratch: a right-sized buffer would make recv_into
        # silently TRUNCATE an oversized datagram to row_bytes and accept
        # it; oversized rows must fail the length check instead.
        self._scratch = bytearray(65536)

    @property
    def local_port(self) -> int:
        return self._sock.getsockname()[1]

    def recv_sector(self, out: bytearray | None = None):
        """Receive one sector.

        Returns (buffer, header | None) where buffer is the raw
        sector_nbytes_wire byte payload and header carries (sector,
        elevation) when the producer sent extended frames.  Returns
        (None, None) on timeout with no data (idle).  Raises TimeoutError
        if a sector is partially received and then the stream stalls.
        """
        m = self.cfg.num_range_cells
        rb = self._row_bytes
        buf = out if out is not None else bytearray(self.cfg.sector_nbytes_wire)
        if self._native:
            return self._recv_sector_native(buf, m)
        view = memoryview(buf)
        first_header = None
        filled = bytearray(m)   # unique-row tracking (extended headers)
        rows = 0
        while rows < m:
            try:
                nbytes = self._sock.recv_into(self._scratch)
            except socket.timeout:
                self.stats.timeouts += 1
                if rows == 0:
                    return None, None
                # mid-sector stall: drop partial sector, stay alive
                self.stats.dropped_sectors += 1
                self.stats.dropped_datagrams += m - rows
                raise TimeoutError(
                    f"sector stalled after {rows}/{m} rows") from None
            self.stats.datagrams += 1
            header, payload = frames.try_unpack_ingest_row(
                bytes(self._scratch[:nbytes]))
            if len(payload) != rb:
                self.stats.dropped_datagrams += 1
                continue
            if header is not None:
                if first_header is None:
                    first_header = header
                elif (header.sector != first_header.sector
                      or header.elevation != first_header.elevation):
                    # producer moved on: we lost the tail of this sector
                    self.stats.dropped_sectors += 1
                    self.stats.dropped_datagrams += m - rows
                    buf[:] = b"\x00" * len(buf)
                    first_header = header
                    filled = bytearray(m)
                    rows = 0
                row_idx = header.row
                if not (0 <= row_idx < m):
                    self.stats.dropped_datagrams += 1
                    continue
                # count UNIQUE rows: a duplicate plus one lost row must not
                # "complete" the sector with a zero-filled hole
                if filled[row_idx]:
                    self.stats.duplicate_datagrams += 1
                    view[row_idx * rb:(row_idx + 1) * rb] = payload
                    continue
                filled[row_idx] = 1
            else:
                row_idx = rows  # bare v1 wire: rows arrive in order
            view[row_idx * rb:(row_idx + 1) * rb] = payload
            rows += 1
        self.stats.sectors += 1
        return buf, first_header

    def _recv_sector_native(self, buf, m):
        """The C++ reassembly (native/ingest.cpp), with the Python loop's
        returns, raises and stats."""
        st = self._nstats
        before = st.copy()
        rc = self._drain.recv_sector(self._timeout_ms, buf, m,
                                     self._row_bytes, st, self._nhdr)
        d = st - before
        self.stats.datagrams += int(d[0])
        self.stats.dropped_datagrams += int(d[1])
        self.stats.dropped_sectors += int(d[2])
        self.stats.timeouts += int(d[3])
        self.stats.duplicate_datagrams += int(d[4])
        if rc == 0:
            return None, None
        if rc == -1:
            raise TimeoutError("sector stalled mid-receive")
        if rc == -2:
            raise OSError("native ingest: socket error")
        self.stats.sectors += 1
        header = None
        if self._nhdr[0]:
            header = frames.IngestHeader(int(self._nhdr[1]),
                                         int(self._nhdr[2]), 0)
        return buf, header

    def close(self):
        self._close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _close_ingest(drain, sock) -> None:
    if drain is not None:
        drain.close()
    sock.close()


class UdpEgress:
    """Broadcast result frames like the reference's udpclient
    (udpbroadcast.cpp:15-43): one socket per product port."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 zdb_port: int | None = None, zdr_port: int | None = None,
                 host: str = "127.0.0.1", broadcast: bool = False,
                 extended: bool = False):
        """extended: emit v1x frames (frames.RESULT_MAGIC header carrying
        the elevation) instead of bare v1, so a UDP consumer can rebuild
        the multi-elevation volume; off by default for reference parity."""
        self.cfg = cfg
        self.host = "255.255.255.255" if broadcast else host
        self.zdb_port = zdb_port if zdb_port is not None else cfg.udp_zdb_port
        self.zdr_port = zdr_port if zdr_port is not None else cfg.udp_zdr_port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if broadcast:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        self.extended = extended

    def send(self, sector: int, elevation: int, zdb: np.ndarray,
             zdr: np.ndarray) -> None:
        """v1 frame [sector:int16 BE][m/2 float32 BE] (read_single.cc:
        510-520), or v1x (frames.pack_result_v1x) with `extended`."""
        if self.extended:
            pack = lambda v: frames.pack_result_v1x(sector, elevation, v)  # noqa: E731
        else:
            pack = lambda v: frames.pack_result_v1(sector, v)  # noqa: E731
        self._sock.sendto(pack(zdb), (self.host, self.zdb_port))
        self._sock.sendto(pack(zdr), (self.host, self.zdr_port))

    def close(self):
        self._sock.close()


class UdpProducer:
    """Replays sector byte streams as v1 row datagrams (the external
    producer process of the reference's localhost test topology,
    SURVEY.md section 4.5)."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 host: str = "127.0.0.1", port: int | None = None,
                 extended_headers: bool = False,
                 burst_bytes: int = 1 << 20, burst_gap_s: float = 1e-3):
        """burst_bytes/burst_gap_s: datagram pacing.  Kernel receive
        buffers are typically capped well below one sector's 6.3 MB, so an
        unpaced sector burst overruns the receiver and loses datagrams;
        the producer pauses burst_gap_s after each burst_bytes of rows.
        The budget is in bytes, not rows: a sleep can last several times
        burst_gap_s on a coarse-timer host, and a fixed 64-row burst then
        capped the wire below a radar's 21.45 sectors/s (16.36 on an H100
        host).  burst_bytes=0 disables pacing."""
        self.cfg = cfg
        self.addr = (host, port if port is not None else cfg.udp_ingest_port)
        self.extended = extended_headers
        self.rows_per_burst = (max(1, burst_bytes // cfg.datagram_nbytes)
                               if burst_bytes else 0)
        self.burst_gap_s = burst_gap_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # the reference producer sends to INADDR_BROADCAST
        # (udpbroadcast.cpp:30)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)

    def send_sector(self, wire: bytes, sector: int = 0,
                    elevation: int = 0) -> None:
        rb = self.cfg.datagram_nbytes
        for row in range(self.cfg.num_range_cells):
            payload = wire[row * rb:(row + 1) * rb]
            if self.extended:
                payload = frames.pack_ingest_row(
                    frames.IngestHeader(sector, elevation, row), payload)
            self._sock.sendto(payload, self.addr)
            if (self.rows_per_burst and self.burst_gap_s
                    and (row + 1) % self.rows_per_burst == 0):
                time.sleep(self.burst_gap_s)

    def close(self):
        self._sock.close()
