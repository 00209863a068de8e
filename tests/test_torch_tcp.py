"""The port's TCP transport (wrp_tpu_torch/io/tcp.py) on loopback: the
behaviours of tests/test_tcp.py on the port, the v2 result frames, and the
wire against wrp_tpu's in both directions, byte for byte.  Ephemeral ports
and a timeout on every socket."""

import socket
import struct
import threading

import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.io import frames as jframes
from wrp_tpu.io import tcp as jtcp
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.io import codec, frames
from wrp_tpu_torch.io.tcp import (TcpEgress, TcpIngest, TcpProducer,
                                  TcpResultConsumer)
from wrp_tpu_torch.runtime import StreamingExecutor, VolumeScan

torch.set_num_threads(2)


@pytest.fixture()
def cfg():
    return tiny_config(m=32, n=16)


def _wire_sectors(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        iq = (rng.integers(-2048, 2048, cfg.sector_shape)
              + 1j * rng.integers(-2048, 2048, cfg.sector_shape))
        out.append((iq, codec.encode_iq(iq, cfg)))
    return out


def _raw(port):
    return socket.create_connection(("127.0.0.1", port), timeout=5.0)


def test_tcp_roundtrip_single_sector(cfg):
    ingest = TcpIngest(cfg, port=0, timeout_s=3.0)
    producer = TcpProducer(cfg, port=ingest.local_port)
    (_, wire), = _wire_sectors(cfg, 1)
    producer.send_sector(wire, sector=5, elevation=1)
    buf, header = ingest.recv_sector()
    assert (header.sector, header.elevation) == (5, 1)
    assert bytes(buf) == wire
    producer.close()
    ingest.close()


def test_tcp_idle_timeout(cfg):
    ingest = TcpIngest(cfg, port=0, timeout_s=0.05)
    assert ingest.recv_sector() == (None, None)
    assert ingest.stats.timeouts == 1
    ingest.close()


def test_tcp_producer_disconnect_then_reconnect(cfg):
    """A producer restart must not kill the ingest loop: EOF surfaces as
    one idle (None, None), then a new producer is accepted."""
    ingest = TcpIngest(cfg, port=0, timeout_s=2.0)
    sectors = _wire_sectors(cfg, 2)
    p1 = TcpProducer(cfg, port=ingest.local_port)
    p1.send_sector(sectors[0][1], sector=0)
    buf, h = ingest.recv_sector()
    assert h.sector == 0 and bytes(buf) == sectors[0][1]
    p1.close()
    assert ingest.recv_sector() == (None, None)
    p2 = TcpProducer(cfg, port=ingest.local_port)
    p2.send_sector(sectors[1][1], sector=1)
    buf, h = ingest.recv_sector()
    assert h.sector == 1 and bytes(buf) == sectors[1][1]
    p2.close()
    ingest.close()


def test_tcp_relaunch_rebinds_port(cfg):
    """SO_REUSEADDR: a relaunched ingest binds the port its predecessor
    held while that connection sits in TIME_WAIT (the supervisor's
    relaunch of a feed)."""
    ingest = TcpIngest(cfg, port=0, timeout_s=2.0)
    port = ingest.local_port
    p = TcpProducer(cfg, port=port)
    (_, wire), = _wire_sectors(cfg, 1)
    p.send_sector(wire, sector=2)
    assert ingest.recv_sector()[1].sector == 2
    ingest.close()           # the server side closes first: TIME_WAIT here
    p.close()
    again = TcpIngest(cfg, port=port, timeout_s=2.0)
    p = TcpProducer(cfg, port=port)
    p.send_sector(wire, sector=3)
    assert again.recv_sector()[1].sector == 3
    p.close()
    again.close()


def test_full_tcp_streaming_pipeline(cfg):
    """producer -> TcpIngest -> StreamingExecutor (device cpu) -> TcpEgress
    -> TcpResultConsumer over loopback, against the fp64 oracle."""
    n_sectors = 4
    sectors = _wire_sectors(cfg, n_sectors, seed=3)
    ingest = TcpIngest(cfg, port=0, timeout_s=2.0)
    consumer = TcpResultConsumer(cfg, port=0, timeout_s=10.0)
    egress = TcpEgress(cfg, port=consumer.local_port)
    ex = StreamingExecutor(cfg, transport=ingest, publish=egress, batch=2,
                           method="pallas", max_sectors=n_sectors,
                           device="cpu")
    runner = threading.Thread(target=ex.run, daemon=True)
    runner.start()
    producer = TcpProducer(cfg, port=ingest.local_port)
    for k, (_, wire) in enumerate(sectors):
        producer.send_sector(wire, sector=k, elevation=0)
    got = {}
    while len(got) < n_sectors * 2:
        item = consumer.recv()
        if item is None:
            break
        topic, sector, elevation, values = item
        assert elevation == 0
        got[(topic, sector)] = values
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert len(got) == n_sectors * 2, f"got {len(got)} frames"
    for k, (iq, _) in enumerate(sectors):
        zdb64, zdr64 = oracle.process_sector(iq, cfg)
        assert oracle.relative_l2(zdb64, got[(b"B", k)]) < 1e-4
        assert oracle.relative_l2(zdr64, got[(b"C", k)]) < 1e-4
    for x in (producer, ingest, egress, consumer):
        x.close()


def test_tcp_partial_frame_drops_connection(cfg):
    """A producer stalling mid-frame must not desync the stream: the
    connection is dropped (no retry) and a fresh producer works."""
    ingest = TcpIngest(cfg, port=0, timeout_s=0.2)
    raw = _raw(ingest.local_port)
    raw.sendall(struct.pack(">I", 1000) + b"only-a-little")
    assert ingest.recv_sector() == (None, None)
    assert ingest.stats.dropped_sectors == 1
    raw.close()
    (_, wire), = _wire_sectors(cfg, 1)
    p2 = TcpProducer(cfg, port=ingest.local_port)
    p2.send_sector(wire, sector=3)
    buf, h = ingest.recv_sector()
    assert h.sector == 3 and bytes(buf) == wire
    p2.close()
    ingest.close()


@pytest.mark.parametrize("frame", [
    struct.pack(">I", 1 << 30),              # impossible length: nothing buffered
    struct.pack(">I", 10) + b"x" * 10,       # complete but short frame
], ids=["oversized", "short"])
def test_tcp_bad_frames_drop_connection(cfg, frame):
    """A hostile or corrupt frame length must neither buffer gigabytes nor
    feed a truncated payload into the codec: both drop the connection,
    after which a fresh producer works."""
    ingest = TcpIngest(cfg, port=0, timeout_s=0.5)
    raw = _raw(ingest.local_port)
    raw.sendall(frame)
    assert ingest.recv_sector() == (None, None)
    assert ingest.stats.dropped_sectors == 1
    raw.close()
    (_, wire), = _wire_sectors(cfg, 1)
    p2 = TcpProducer(cfg, port=ingest.local_port)
    p2.send_sector(wire, sector=5)
    buf, h = ingest.recv_sector()
    assert h.sector == 5 and bytes(buf) == wire
    p2.close()
    ingest.close()


def _stats_script(ingest_cls, producer_cls, cfg):
    """idle, short frame, partial frame, one sector, disconnect: the
    ingest's stats after each step."""
    ingest = ingest_cls(cfg, port=0, timeout_s=0.1)
    seen = []

    def snap():
        s = ingest.stats
        seen.append((s.sectors, s.datagrams, s.dropped_sectors, s.timeouts))

    ingest.recv_sector()
    snap()
    raw = _raw(ingest.local_port)
    raw.sendall(struct.pack(">I", 10) + b"x" * 10)
    ingest.recv_sector()
    snap()
    raw.close()
    raw = _raw(ingest.local_port)
    raw.sendall(struct.pack(">I", 1000) + b"part")
    ingest.recv_sector()
    snap()
    raw.close()
    (_, wire), = _wire_sectors(cfg, 1)
    p = producer_cls(cfg, port=ingest.local_port)
    p.send_sector(wire, sector=1)
    buf, _ = ingest.recv_sector()
    assert bytes(buf) == wire
    snap()
    p.close()
    ingest.recv_sector()
    snap()
    ingest.close()
    return seen


def test_tcp_ingest_stats_uniform_and_equal_to_wrp_tpu(cfg):
    """TCP carries the same IngestStats surface as UDP/ZMQ (sectors,
    timeouts, dropped frames), and the port counts as wrp_tpu does."""
    from wrp_tpu.config import tiny_config as jtiny

    port = _stats_script(TcpIngest, TcpProducer, cfg)
    assert port[0] == (0, 0, 0, 1)           # idle
    assert port[1] == (0, 1, 1, 1)           # short frame
    assert port[2][2] == 2                   # partial frame
    assert port[3][0] == 1                   # one sector
    assert port == _stats_script(jtcp.TcpIngest, jtcp.TcpProducer,
                                 jtiny(m=32, n=16))


def test_tcp_result_consumer_short_frame_survives(cfg):
    """An undersized result frame (valid length header, fewer bytes than a
    topic and a v2 header) drops the connection, not the consumer."""
    consumer = TcpResultConsumer(cfg, port=0, timeout_s=1.0)
    raw = _raw(consumer.local_port)
    raw.sendall(struct.pack(">I", 4) + b"\x00" * 4)
    assert consumer.recv() is None
    raw.close()
    raw2 = _raw(consumer.local_port)
    body = b"B" + frames.pack_result_v2(
        3, 1, np.arange(cfg.num_output_bins, dtype=np.float32))
    raw2.sendall(struct.pack(">I", len(body)) + body)
    topic, sector, elevation, values = consumer.recv()
    assert (topic, sector, elevation) == (b"B", 3, 1)
    np.testing.assert_array_equal(values, np.arange(cfg.num_output_bins))
    raw2.close()
    consumer.close()


def test_tcp_egress_backs_off_from_a_dead_collector(cfg):
    """No collector: one failed connect, then no attempt inside the
    backoff, so a dead visualiser never stalls the compute thread."""
    port = _free_listen_port()
    egress = TcpEgress(cfg, port=port, reconnect_backoff_s=60.0)
    zeros = np.zeros(cfg.num_output_bins, np.float32)
    egress.send(0, 0, zeros, zeros)
    assert egress._sock is None and egress._next_attempt > 0
    consumer = TcpResultConsumer(cfg, port=port, timeout_s=0.3)
    egress.send(1, 0, zeros, zeros)          # inside the backoff: dropped
    assert egress._sock is None and consumer.recv() is None
    egress._next_attempt = 0.0               # the backoff elapsed
    egress.send(2, 0, zeros, zeros)
    assert consumer.recv()[1] == 2
    egress.close()
    consumer.close()


def _free_listen_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tcp_multifeed_consolidation(cfg):
    """Two framed feeds with different data under the same sector labels:
    per-feed volumes, each pinned to its own oracle."""
    n_per_feed = 2
    data = [_wire_sectors(cfg, n_per_feed, seed=30 + f) for f in range(2)]
    ingests = [TcpIngest(cfg, port=0, timeout_s=3.0) for _ in range(2)]
    vols = [VolumeScan(cfg, None) for _ in range(2)]
    ex = StreamingExecutor(cfg, transport=ingests, volume=vols, batch=2,
                           method="pallas", max_sectors=n_per_feed,
                           device="cpu")
    res = []
    runner = threading.Thread(target=lambda: res.append(ex.run()),
                              daemon=True)
    runner.start()
    producers = [TcpProducer(cfg, port=ing.local_port) for ing in ingests]
    for k in range(n_per_feed):
        for f in range(2):
            producers[f].send_sector(data[f][k][1], sector=k, elevation=0)
    runner.join(timeout=60)
    assert res and res[0]["processed_sectors"] == 2 * n_per_feed
    assert [fs["processed_sectors"] for fs in res[0]["feeds"]] == [2, 2]
    for f in range(2):
        for k in range(n_per_feed):
            assert vols[f].coverage[k, 0]
            zdb64, _ = oracle.process_sector(data[f][k][0], cfg)
            assert oracle.relative_l2(zdb64, vols[f].data[0, :, k, 0]) < 1e-4
    for x in ingests + producers:
        x.close()


# ---------------------------------------------------------------------------
# The wire against wrp_tpu's, both ways.
# ---------------------------------------------------------------------------


def _jcfg():
    from wrp_tpu.config import tiny_config as jtiny

    return jtiny(m=32, n=16)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tcp_ingest_interop(cfg, direction):
    """A producer of either package feeds the other's ingest: the same
    wire bytes and labels arrive."""
    sectors = _wire_sectors(cfg, 2, seed=9)
    if direction == "jax_to_port":
        ingest = TcpIngest(cfg, port=0, timeout_s=3.0)
        producer = jtcp.TcpProducer(_jcfg(), port=ingest.local_port)
    else:
        ingest = jtcp.TcpIngest(_jcfg(), port=0, timeout_s=3.0)
        producer = TcpProducer(cfg, port=ingest.local_port)
    for k, (_, wire) in enumerate(sectors):
        producer.send_sector(wire, sector=7 + k, elevation=1)
    for k, (_, wire) in enumerate(sectors):
        buf, h = ingest.recv_sector()
        assert bytes(buf) == wire
        assert (h.sector, h.elevation) == (7 + k, 1)
    assert ingest.stats.sectors == 2
    producer.close()
    ingest.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tcp_egress_interop(cfg, direction):
    """Either package's egress feeds the other's result consumer: topics,
    labels and values arrive exactly."""
    rng = np.random.default_rng(11)
    zdb = rng.standard_normal(cfg.num_output_bins).astype(np.float32)
    zdr = rng.standard_normal(cfg.num_output_bins).astype(np.float32)
    if direction == "jax_to_port":
        consumer = TcpResultConsumer(cfg, port=0, timeout_s=3.0)
        egress = jtcp.TcpEgress(_jcfg(), port=consumer.local_port)
    else:
        consumer = jtcp.TcpResultConsumer(_jcfg(), port=0, timeout_s=3.0)
        egress = TcpEgress(cfg, port=consumer.local_port)
    egress.send(4, 1, zdb, zdr)
    for topic, values in ((b"B", zdb), (b"C", zdr)):
        got = consumer.recv()
        assert got[:3] == (topic, 4, 1)
        np.testing.assert_array_equal(got[3], values)
    egress.close()
    consumer.close()


@pytest.mark.parametrize("seed", range(4))
def test_result_v2_frames_equal_wrp_tpu(seed):
    """pack_result_v2 is byte-equal to wrp_tpu's, and each package unpacks
    the other's frame to the same sector, elevation and values."""
    rng = np.random.default_rng(seed)
    sector = int(rng.integers(-(1 << 15), 1 << 15))
    elevation = int(rng.integers(-(1 << 15), 1 << 15))
    values = (rng.standard_normal(int(rng.integers(1, 700))) * 1e3).astype(
        np.float32)
    values[0] = -np.inf
    buf = frames.pack_result_v2(sector, elevation, values)
    assert buf == jframes.pack_result_v2(sector, elevation, values)
    assert len(buf) == 4 + 4 * values.size
    for unpack in (frames.unpack_result_v2, jframes.unpack_result_v2):
        s, e, v = unpack(buf)
        assert (s, e) == (sector, elevation)
        np.testing.assert_array_equal(v, values)
