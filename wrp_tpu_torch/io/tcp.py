"""TCP stream transport — the working equivalent of the reference's built-
but-unused tcp.{h,cpp} (localhost client/server with echo-ack, tcp.cpp:46-51,
96-101; never linked into a pipeline).  Counterpart of ``wrp_tpu.io.tcp``,
byte for byte on the wire: a producer of either package feeds the other's
ingest, and either egress feeds either consumer.

Topology matches the reference's localhost dataflow (SURVEY.md section 1):
the processor *listens* for the producer (like udpserver) and *connects* to
result consumers (like udpclient).  TCP gives what the UDP wire could not —
no datagram loss, no reordering — at the cost of head-of-line blocking, so
it suits replay/test topologies more than live radar feeds.

Framing: every message is [u32 BE length][payload].
  ingest payload:  [u16 BE sector][u16 BE elevation][sector wire bytes]
  result payload:  [u8 topic 'B'|'C'][v2 result frame]  (frames.pack_result_v2)

A message is received into one fresh buffer (``recv_into``), and the ingest
hands the executor a view of its wire bytes, not a copy.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Optional

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG
from . import frames
from .stats import IngestStats

_LEN = struct.Struct(">I")
_ING = struct.Struct(">HH")


class _PartialRead(Exception):
    """Timeout after part of a frame arrived: the stream is desynced and
    the connection must be dropped (a plain retry would misparse)."""


class _BadFrame(Exception):
    """Declared frame length is impossible for this endpoint: a corrupt or
    hostile peer.  Handled like a desync — drop the connection — instead
    of buffering up to 4 GiB on a bogus u32 length."""


def _recv_exact(sock: socket.socket, nbytes: int) -> Optional[bytearray]:
    """Read exactly nbytes; None on clean EOF.  Raises socket.timeout on
    an idle boundary, _PartialRead on a mid-frame stall."""
    buf = bytearray(nbytes)
    view = memoryview(buf)
    got = 0
    while got < nbytes:
        try:
            k = sock.recv_into(view[got:])
        except socket.timeout:
            if got:
                raise _PartialRead() from None
            raise
        if not k:
            if got:
                raise _PartialRead()
            return None
        got += k
    return buf


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket, max_len: int) -> Optional[bytearray]:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > max_len:
        raise _BadFrame()
    body = _recv_exact(sock, length)
    if body is None:           # EOF between header and body: desynced
        raise _PartialRead()
    return body


class TcpIngest:
    """Listening sector server; one producer connection at a time.

    recv_sector() -> (wire bytes, IngestHeader) | (None, None) on idle
    timeout or producer disconnect.  The listener sets SO_REUSEADDR, so a
    relaunched processor rebinds its port while the old connection sits
    in TIME_WAIT."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 port: int | None = None, host: str = "",
                 timeout_s: Optional[float] = None):
        self.cfg = cfg
        self.stats = IngestStats()
        self.port = port if port is not None else cfg.tcp_ingest_port
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, self.port))
        self._listener.listen(1)
        self._listener.settimeout(timeout_s)
        self._timeout_s = timeout_s
        self._conn: Optional[socket.socket] = None

    @property
    def local_port(self) -> int:
        return self._listener.getsockname()[1]

    def _accept(self) -> bool:
        try:
            self._conn, _ = self._listener.accept()
        except socket.timeout:
            return False
        self._conn.settimeout(self._timeout_s)
        self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return True

    def _drop(self) -> None:
        self._conn.close()
        self._conn = None

    def recv_sector(self):
        if self._conn is None and not self._accept():
            self.stats.timeouts += 1   # idle wire: no producer connected
            return None, None
        expected = _ING.size + self.cfg.sector_nbytes_wire
        try:
            msg = _recv_msg(self._conn, max_len=expected)
        except socket.timeout:
            self.stats.timeouts += 1
            return None, None
        except (_PartialRead, _BadFrame):
            # mid-frame stall/EOF or an impossible declared length: the
            # byte stream is desynced or corrupt — drop the connection
            # (the reference's blocking recv would hang or misparse here,
            # SURVEY.md section 5); no retry
            self.stats.dropped_sectors += 1
            self._drop()
            return None, None
        if msg is None:  # producer closed; await the next one
            self._drop()
            return None, None
        self.stats.datagrams += 1
        if len(msg) != expected:  # short frame: never feed a truncated
            self.stats.dropped_sectors += 1   # payload into the codec
            self._drop()
            return None, None
        sector, elevation = _ING.unpack_from(msg, 0)
        self.stats.sectors += 1
        return (memoryview(msg)[_ING.size:],
                frames.IngestHeader(sector, elevation, row=0))

    def close(self):
        if self._conn is not None:
            self._conn.close()
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TcpProducer:
    """Connects to a TcpIngest and streams framed sectors."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 host: str = "127.0.0.1", port: int | None = None,
                 connect_timeout_s: float = 5.0):
        self.cfg = cfg
        self._sock = socket.create_connection(
            (host, port if port is not None else cfg.tcp_ingest_port),
            timeout=connect_timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send_sector(self, wire: bytes, sector: int = 0,
                    elevation: int = 0) -> None:
        _send_msg(self._sock, _ING.pack(sector, elevation) + bytes(wire))

    def close(self):
        self._sock.close()


class TcpEgress:
    """Connects to a result collector and pushes topic-tagged v2 frames
    ('B' = zdb, 'C' = zdr, matching the ZMQ topics, rpv2.cu:216-220).
    Connection is lazy and reconnect-on-failure: the processor must not
    die because a visualiser restarted."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 host: str = "127.0.0.1", port: int | None = None,
                 reconnect_backoff_s: float = 5.0):
        """reconnect_backoff_s: after a FAILED connect attempt, skip
        further attempts for this long.  A down collector whose connect
        must time out (firewalled, routed-but-dead host) would otherwise
        stall the compute thread's publish epilogue 2 s per sector —
        long enough to overflow the ingest queue and turn a visualiser
        outage into processor drops."""
        self.cfg = cfg
        self.addr = (host, port if port is not None else cfg.tcp_result_port)
        self._sock: Optional[socket.socket] = None
        self._backoff_s = reconnect_backoff_s
        self._next_attempt = 0.0

    def _ensure(self) -> bool:
        if self._sock is not None:
            return True
        if time.monotonic() < self._next_attempt:
            return False
        try:
            self._sock = socket.create_connection(self.addr, timeout=2.0)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return True
        except OSError:
            self._sock = None
            self._next_attempt = time.monotonic() + self._backoff_s
            return False

    def send(self, sector: int, elevation: int, zdb: np.ndarray,
             zdr: np.ndarray) -> None:
        if not self._ensure():
            return
        try:
            for topic, values in ((b"B", zdb), (b"C", zdr)):
                _send_msg(self._sock,
                          topic + frames.pack_result_v2(sector, elevation,
                                                        values))
        except OSError:
            self._sock.close()
            self._sock = None

    def close(self):
        if self._sock is not None:
            self._sock.close()


class TcpResultConsumer:
    """Listening result collector (visualiser stand-in)."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 port: int | None = None, host: str = "",
                 timeout_s: Optional[float] = 5.0):
        self.cfg = cfg
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port if port is not None
                             else cfg.tcp_result_port))
        self._listener.listen(1)
        self._listener.settimeout(timeout_s)
        self._timeout_s = timeout_s
        self._conn: Optional[socket.socket] = None

    @property
    def local_port(self) -> int:
        return self._listener.getsockname()[1]

    def _drop(self) -> None:
        self._conn.close()
        self._conn = None

    def recv(self):
        """-> (topic bytes, sector, elevation, values) | None on timeout."""
        if self._conn is None:
            try:
                self._conn, _ = self._listener.accept()
            except socket.timeout:
                return None
            self._conn.settimeout(self._timeout_s)
        try:
            msg = _recv_msg(self._conn,
                            max_len=1 + 4 + 4 * self.cfg.num_output_bins)
        except socket.timeout:
            return None
        except (_PartialRead, _BadFrame):
            self._drop()
            return None
        if msg is None:
            self._drop()
            return None
        try:
            # undersized or misaligned frames are as corrupt as oversized
            # ones — drop the connection, don't crash the consumer
            sector, elevation, values = frames.unpack_result_v2(
                bytes(msg[1:]))
        except (struct.error, ValueError, IndexError):
            self._drop()
            return None
        return bytes(msg[:1]), sector, elevation, values

    def close(self):
        if self._conn is not None:
            self._conn.close()
        self._listener.close()
