"""ZeroMQ pub/sub transport — wire-compatible with the reference v2 (rpv2),
and with ``wrp_tpu.io.zmq_io`` in both directions.

Reference behaviour (rpv2.cu:216-220, 350-365, 620-663):
  * ingest: SUB connect tcp://localhost:5563, topic "A", one message =
    one whole sector of interleaved BE int16;
  * egress: PUB bind tcp://*:5564, topic "B" = zdb frame, "C" = zdr frame,
    each [sector:int16 BE][elevation:int16 BE][m/2 float32 BE].

Bounded queues.  libzmq's default high-water mark is 1000 messages a
socket; at 6.3 MB a sector a backlogged SUB then holds ~6.3 GB and turns
overload into tens of seconds of latency with no drop recorded anywhere.
Every socket here sets both its high-water marks (SNDHWM, RCVHWM), from
one constructor argument `hwm` counted in sectors: a sector socket
(ZmqIngest, ZmqProducer) queues `hwm` messages, DEFAULT_HWM by default; a
result socket (ZmqEgress, ZmqResultConsumer) queues 2 x `hwm` frames (zdb
and zdr), RESULT_HWM sectors by default.  Past the mark PUB/SUB sheds
whole messages at the socket.  A sector shed there never reaches the
ingest, so it shows as missing coverage of the volume, not as latency.
No socket reports the messages its mark sheds, so no counter here does
either.

pyzmq is imported when a socket is built, not when this module is
imported: the rest of the port works without it, and a missing pyzmq
raises ImportError from the constructor.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG
from . import frames
from .stats import IngestStats

#: sectors a sector socket queues before PUB/SUB sheds (~100 MB at the
#: reference geometry)
DEFAULT_HWM = 16
#: sectors of results a result socket queues (2 frames of 2 KB each, ~4 MB);
#: far above one batch's burst of frames, which DEFAULT_HWM is not
RESULT_HWM = 1024


def _zmq():
    try:
        import zmq
    except ImportError:
        raise ImportError("pyzmq is required for the ZMQ transport") from None
    return zmq


def _socket(ctx, kind, messages: int):
    """A socket with both high-water marks at `messages` (set before any
    bind/connect: libzmq applies them to pipes created afterwards)."""
    zmq = _zmq()
    if messages < 1:
        raise ValueError(f"hwm must be >= 1 sector, got {messages}")
    sock = ctx.socket(kind)
    sock.setsockopt(zmq.SNDHWM, messages)
    sock.setsockopt(zmq.RCVHWM, messages)
    return sock


class ZmqIngest:
    """SUB socket receiving whole-sector messages under the ingest topic."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 endpoint: str | None = None, timeout_ms: Optional[int] = None,
                 hwm: int = DEFAULT_HWM):
        zmq = _zmq()
        self.cfg = cfg
        self.stats = IngestStats()
        self.ctx = zmq.Context.instance()
        self.sock = _socket(self.ctx, zmq.SUB, hwm)
        self.sock.connect(endpoint or cfg.zmq_sub_endpoint)
        self.sock.setsockopt(zmq.SUBSCRIBE, cfg.zmq_ingest_topic)
        if timeout_ms is not None:
            self.sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._again = zmq.Again

    def recv_sector(self) -> Tuple[Optional[bytes],
                                   Optional[frames.IngestHeader]]:
        """(wire bytes | None, IngestHeader | None) — None bytes on an
        idle timeout; the header is present only when the producer opted
        into extended framing (the same contract as UdpIngest/TcpIngest,
        so the executor places sectors by label).

        A short body is a lost sector, not an idle wire: it counts as
        dropped in `stats` and raises TimeoutError, as UdpIngest does for
        a lost sector, so the executor advances the positional counter of
        a header-less feed instead of labelling every later sector one
        early."""
        try:
            parts = self.sock.recv_multipart()
        except self._again:
            self.stats.timeouts += 1
            return None, None
        self.stats.datagrams += 1
        # envelope = [topic, body] (zhelpers s_sendmore/s_send convention);
        # extended framing inserts a header frame: [topic, header, body].
        # The reference's 2-part wire carries no labels (rpv2.cu:356-358,
        # sector ids are positional), which is unsound across a
        # checkpoint and relaunch; the opt-in header places sectors by
        # label, as `produce --headers` does for udp.
        body = parts[-1]
        header = None
        if len(parts) >= 3:
            h, rest = frames.try_unpack_ingest_row(parts[-2])
            if h is not None and not rest:
                header = h
        want = self.cfg.sector_nbytes_wire
        if len(body) < want:
            self.stats.dropped_sectors += 1
            raise TimeoutError(
                f"short zmq body ({len(body)} < {want} bytes); "
                "sector dropped")
        self.stats.sectors += 1
        return body[:want], header

    def close(self):
        self.sock.close(0)


class ZmqEgress:
    """PUB socket publishing v2 result frames under topics B (zdb) and
    C (zdr)."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 endpoint: str | None = None, hwm: int = RESULT_HWM):
        zmq = _zmq()
        self.cfg = cfg
        # a private context, as ZmqProducer's: the last result frames of
        # a draining stream process must flush before it exits
        self.ctx = zmq.Context()
        self.sock = _socket(self.ctx, zmq.PUB, 2 * hwm)
        self.sock.bind(endpoint or cfg.zmq_pub_endpoint)

    def send(self, sector: int, elevation: int,
             zdb: np.ndarray, zdr: np.ndarray) -> None:
        self.sock.send_multipart(
            [self.cfg.zmq_zdb_topic,
             frames.pack_result_v2(sector, elevation, zdb)])
        self.sock.send_multipart(
            [self.cfg.zmq_zdr_topic,
             frames.pack_result_v2(sector, elevation, zdr)])

    def close(self, linger_ms: int = 5000):
        self.sock.close(linger_ms)
        self.ctx.term()


class ZmqProducer:
    """PUB socket publishing whole sectors under the ingest topic (the
    external data source of the reference's v2 topology)."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 endpoint: str = "tcp://*:5563",
                 extended_headers: bool = False, hwm: int = DEFAULT_HWM):
        """extended_headers: insert a label frame ([topic, header, body])
        so the processor places sectors by (sector, elevation) instead of
        positionally; off by default — the reference's v2 wire is the
        2-part form (rpv2.cu:356-358)."""
        zmq = _zmq()
        self.cfg = cfg
        self.extended = extended_headers
        # a PRIVATE context so close() can term it: PUB sends are queued
        # to an io thread, and a producer process exiting right after
        # send_sector would drop the queued message (a 6.3 MB sector
        # takes real time to flush); term() blocks until pending sends
        # deliver or the bounded linger expires
        self.ctx = zmq.Context()
        self.sock = _socket(self.ctx, zmq.PUB, hwm)
        self.sock.bind(endpoint)

    def send_sector(self, wire: bytes, sector: int = 0,
                    elevation: int = 0) -> None:
        if self.extended:
            hdr = frames.pack_ingest_row(
                frames.IngestHeader(sector, elevation, 0), b"")
            self.sock.send_multipart(
                [self.cfg.zmq_ingest_topic, hdr, wire])
        else:
            self.sock.send_multipart([self.cfg.zmq_ingest_topic, wire])

    def close(self, linger_ms: int = 5000):
        """Flushes queued sectors (bounded): close(0) here lost the last
        messages of every short-lived producer process."""
        self.sock.close(linger_ms)
        self.ctx.term()


class ZmqResultConsumer:
    """SUB socket collecting v2 result frames (test/visualiser side)."""

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 endpoint: str = "tcp://localhost:5564",
                 timeout_ms: int = 5000, hwm: int = RESULT_HWM):
        zmq = _zmq()
        self.cfg = cfg
        self.ctx = zmq.Context.instance()
        self.sock = _socket(self.ctx, zmq.SUB, 2 * hwm)
        self.sock.connect(endpoint)
        for topic in (cfg.zmq_zdb_topic, cfg.zmq_zdr_topic):
            self.sock.setsockopt(zmq.SUBSCRIBE, topic)
        self.sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._again = zmq.Again

    def recv(self) -> Optional[Tuple[bytes, int, int, np.ndarray]]:
        """(topic, sector, elevation, values) or None on timeout or a
        malformed frame (a corrupt publisher must not crash the
        consumer)."""
        try:
            parts = self.sock.recv_multipart()
        except self._again:
            return None
        try:
            topic, body = parts
            sector, elevation, values = frames.unpack_result_v2(body)
        except (struct.error, ValueError):
            return None
        return topic, sector, elevation, values

    def close(self):
        self.sock.close(0)
