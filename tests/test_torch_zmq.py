"""The port's ZMQ transport (wrp_tpu_torch/io/zmq_io.py, the reference's v2
wire) on loopback: the ZMQ behaviours of tests/test_streaming.py on the
port, the wire against wrp_tpu's in both directions, and the high-water
marks of every socket the module builds.  Ephemeral ports and a receive
timeout on every SUB socket."""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

zmq = pytest.importorskip("zmq")

from conftest import cpu_subprocess_env  # noqa: E402

from wrp_tpu import oracle  # noqa: E402
from wrp_tpu import pipeline as jpipe  # noqa: E402
from wrp_tpu.config import tiny_config as jtiny  # noqa: E402
from wrp_tpu.constants import PipelineConstants as JConstants  # noqa: E402
from wrp_tpu.io import zmq_io as jzmq  # noqa: E402
from wrp_tpu_torch import cli  # noqa: E402
from wrp_tpu_torch.config import DEFAULT_CONFIG, tiny_config  # noqa: E402
from wrp_tpu_torch.io import codec  # noqa: E402
from wrp_tpu_torch.io.zmq_io import (DEFAULT_HWM, RESULT_HWM, ZmqEgress,  # noqa: E402
                                     ZmqIngest, ZmqProducer,
                                     ZmqResultConsumer)
from wrp_tpu_torch.runtime import StreamingExecutor, VolumeScan  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
JOIN_S = 0.3     # PUB/SUB join grace


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _endpoint():
    return f"tcp://127.0.0.1:{_free_port()}"


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


def _run(ex):
    res = []
    runner = threading.Thread(target=lambda: res.append(ex.run()),
                              daemon=True)
    runner.start()
    return runner, res


def test_zmq_short_body_counts_as_drop(cfg):
    """A short body is a lost sector: counted in the uniform IngestStats
    and raised like UdpIngest's lost-sector path, so the executor advances
    the positional counter of a header-less feed."""
    ep = _endpoint()
    producer = ZmqProducer(cfg, endpoint=ep)
    ingest = ZmqIngest(cfg, endpoint=ep, timeout_ms=2000)
    time.sleep(JOIN_S)
    producer.send_sector(b"\x00" * 16)
    with pytest.raises(TimeoutError, match="short zmq body"):
        ingest.recv_sector()
    assert ingest.stats.dropped_sectors == 1
    (_, wire), = _wire_sectors(cfg, 1)
    producer.send_sector(wire)
    assert ingest.recv_sector() == (wire, None)   # 2-part wire: no labels
    assert ingest.stats.sectors == 1
    producer.close()
    ingest.close()


def test_zmq_loopback_pipeline_matches_wrp_tpu(cfg):
    """ZmqProducer -> ZmqIngest -> executor (device cpu) -> ZmqEgress ->
    ZmqResultConsumer, topics A/B/C on the reference's 2-part v2 wire;
    products against wrp_tpu's process_sectors and the fp64 oracle."""
    n_sectors = 4
    sectors = _wire_sectors(cfg, n_sectors, seed=6)
    ep_in, ep_out = _endpoint(), _endpoint()
    producer = ZmqProducer(cfg, endpoint=ep_in)
    ingest = ZmqIngest(cfg, endpoint=ep_in, timeout_ms=3000)
    egress = ZmqEgress(cfg, endpoint=ep_out)
    consumer = ZmqResultConsumer(cfg, endpoint=ep_out, timeout_ms=10000)
    time.sleep(JOIN_S)
    ex = StreamingExecutor(cfg, transport=ingest, publish=egress, batch=2,
                           method="pallas", max_sectors=n_sectors,
                           device="cpu")
    runner, _ = _run(ex)
    time.sleep(0.2)
    for _, wire in sectors:
        producer.send_sector(wire)
    got = {}
    while len(got) < n_sectors * 2:
        item = consumer.recv()
        if item is None:
            break
        topic, sector, elevation, values = item
        got[(topic, sector)] = values
    runner.join(timeout=30)
    assert len(got) == n_sectors * 2, f"got {len(got)} frames"
    iq = np.stack([s[0] for s in sectors]).astype(np.complex64)
    jzdb, jzdr = (np.asarray(a) for a in jpipe.process_sectors(
        iq, JConstants.build(jtiny(m=32, n=16)), method="mxu"))
    for k, (iq_k, _) in enumerate(sectors):
        zdb64, zdr64 = oracle.process_sector(iq_k, cfg)
        assert oracle.relative_l2(zdb64, got[(b"B", k)]) < 1e-4
        assert oracle.relative_l2(zdr64, got[(b"C", k)]) < 1e-4
        assert oracle.relative_l2(jzdb[k], got[(b"B", k)]) < 2e-4
        assert oracle.relative_l2(jzdr[k], got[(b"C", k)]) < 2e-4
    producer.close()
    ingest.close()
    egress.close()
    consumer.close()


def test_multifeed_zmq_consolidation(cfg):
    """One SUB socket per feed endpoint, per-feed volumes, no cross-
    contamination; bodies carry no labels, so each feed's positional
    counter advances on its own."""
    n_per_feed, feeds = 3, 2
    data = [_wire_sectors(cfg, n_per_feed, seed=30 + f) for f in range(feeds)]
    eps = [_endpoint() for _ in range(feeds)]
    producers = [ZmqProducer(cfg, endpoint=e) for e in eps]
    ingests = [ZmqIngest(cfg, endpoint=e, timeout_ms=2000) for e in eps]
    time.sleep(JOIN_S)
    vols = [VolumeScan(cfg, None) for _ in range(feeds)]
    ex = StreamingExecutor(cfg, transport=ingests, volume=vols, batch=2,
                           method="pallas", max_sectors=n_per_feed,
                           device="cpu")
    runner, res = _run(ex)
    time.sleep(0.2)
    for k in range(n_per_feed):
        for f in range(feeds):
            producers[f].send_sector(data[f][k][1])
    runner.join(timeout=60)
    assert res, "executor did not finish"
    assert res[0]["processed_sectors"] == feeds * n_per_feed
    assert [fs["processed_sectors"] for fs in res[0]["feeds"]] == [
        n_per_feed] * feeds
    for f in range(feeds):
        for k in range(n_per_feed):
            assert vols[f].coverage[k, 0]
            zdb64, zdr64 = oracle.process_sector(data[f][k][0], cfg)
            assert oracle.relative_l2(zdb64, vols[f].data[0, :, k, 0]) < 1e-4
            assert oracle.relative_l2(zdr64, vols[f].data[1, :, k, 0]) < 1e-4
    assert oracle.relative_l2(vols[0].data[0, 1:, 0, 0],
                              vols[1].data[0, 1:, 0, 0]) > 1e-3
    for x in ingests + producers:
        x.close()


def test_zmq_extended_headers_place_sectors_by_label(cfg):
    """The opt-in [topic, header, body] framing: sectors land at their
    carried (sector, elevation), not at positional labels."""
    ep = _endpoint()
    producer = ZmqProducer(cfg, endpoint=ep, extended_headers=True)
    ingest = ZmqIngest(cfg, endpoint=ep, timeout_ms=2000)
    time.sleep(JOIN_S)
    labels = [(5, 1), (2, 0)]          # non-positional on purpose
    sectors = _wire_sectors(cfg, len(labels), seed=40)
    vs = VolumeScan(cfg, None)
    ex = StreamingExecutor(cfg, transport=ingest, volume=vs, batch=2,
                           method="pallas", max_sectors=len(labels),
                           device="cpu")
    runner, res = _run(ex)
    time.sleep(0.2)
    for (sec, elev), (_, wire) in zip(labels, sectors):
        producer.send_sector(wire, sector=sec, elevation=elev)
    runner.join(timeout=60)
    assert res, "executor did not finish"
    assert int(vs.coverage.sum()) == len(labels)
    for (sec, elev), (iq, _) in zip(labels, sectors):
        assert vs.coverage[sec, elev]
        zdb64, _ = oracle.process_sector(iq, cfg)
        assert oracle.relative_l2(zdb64, vs.data[0, :, sec, elev]) < 1e-4
    producer.close()
    ingest.close()


def test_zmq_producer_process_exit_flushes_tail():
    """`cli produce --transport zmq` with no --rate exits right after its
    last send; close() must block until the queued 6.3 MB sector is
    delivered (or the bounded linger expires), not drop it."""
    ep = _endpoint()
    ctx = zmq.Context.instance()
    sub = ctx.socket(zmq.SUB)
    sub.connect(ep)
    sub.setsockopt(zmq.SUBSCRIBE, b"A")
    sub.setsockopt(zmq.RCVTIMEO, 30000)
    subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
         "--transport", "zmq", "--zmq-bind", ep, "--sectors", "1",
         "--headers"],
        cwd=REPO, check=True, capture_output=True, timeout=120,
        env=cpu_subprocess_env(OMP_NUM_THREADS="1"))
    try:
        parts = sub.recv_multipart()
    except zmq.Again:
        raise AssertionError("producer exited without flushing its tail")
    finally:
        sub.close(0)
    assert len(parts) == 3                      # topic, header, body
    assert len(parts[-1]) == DEFAULT_CONFIG.sector_nbytes_wire


@pytest.mark.parametrize("argv, message", [
    (["--transport", "udp", "--feed-endpoint", "tcp://127.0.0.1:5563"],
     "zmq transport only"),
    (["--transport", "zmq", "--feed-endpoint", "tcp://127.0.0.1:5563",
      "--feed-endpoint", "tcp://127.0.0.1:5563"],
     "duplicate --feed-endpoint"),
    (["--transport", "zmq", "--feed-port", "9000"], "--feed-endpoint"),
    (["--transport", "zmq", "--feed-endpoint", "tcp://127.0.0.1:5563",
      "--feed-checkpoint", "a.npz", "--feed-checkpoint", "b.npz"],
     "one path per --feed-port/--feed-endpoint"),
], ids=["endpoint-without-zmq", "duplicate-endpoint", "port-with-zmq",
        "checkpoint-count"])
def test_stream_feed_flag_refusals(capsys, argv, message):
    """The flag-kind refusals of `stream`, before any socket is bound."""
    rc = cli.main(["stream", "--device", "cpu", *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The wire against wrp_tpu's, both ways, and the high-water marks.
# ---------------------------------------------------------------------------


def _jcfg():
    return jtiny(m=32, n=16)


@pytest.mark.parametrize("extended", [False, True], ids=["2-part", "labels"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zmq_ingest_interop(cfg, direction, extended):
    """A producer of either package feeds the other's ingest: the same
    bytes, and the same labels when the producer sends them."""
    ep = _endpoint()
    sectors = _wire_sectors(cfg, 2, seed=12)
    if direction == "jax_to_port":
        producer = jzmq.ZmqProducer(_jcfg(), endpoint=ep,
                                    extended_headers=extended)
        ingest = ZmqIngest(cfg, endpoint=ep, timeout_ms=3000)
    else:
        producer = ZmqProducer(cfg, endpoint=ep, extended_headers=extended)
        ingest = jzmq.ZmqIngest(_jcfg(), endpoint=ep, timeout_ms=3000)
    time.sleep(JOIN_S)
    for k, (_, wire) in enumerate(sectors):
        producer.send_sector(wire, sector=3 + k, elevation=1)
    for k, (_, wire) in enumerate(sectors):
        buf, h = ingest.recv_sector()
        assert bytes(buf) == wire
        if extended:
            assert (h.sector, h.elevation) == (3 + k, 1)
        else:
            assert h is None
    producer.close()
    ingest.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zmq_egress_interop(cfg, direction):
    """Either package's result PUB feeds the other's consumer exactly."""
    ep = _endpoint()
    rng = np.random.default_rng(13)
    zdb = rng.standard_normal(cfg.num_output_bins).astype(np.float32)
    zdr = rng.standard_normal(cfg.num_output_bins).astype(np.float32)
    if direction == "jax_to_port":
        egress = jzmq.ZmqEgress(_jcfg(), endpoint=ep)
        consumer = ZmqResultConsumer(cfg, endpoint=ep, timeout_ms=3000)
    else:
        egress = ZmqEgress(cfg, endpoint=ep)
        consumer = jzmq.ZmqResultConsumer(_jcfg(), endpoint=ep,
                                          timeout_ms=3000)
    time.sleep(JOIN_S)
    egress.send(6, 2, zdb, zdr)
    for topic, values in ((b"B", zdb), (b"C", zdr)):
        got = consumer.recv()
        assert got[:3] == (topic, 6, 2)
        np.testing.assert_array_equal(got[3], values)
    egress.close()
    consumer.close()


def _build(kind, cfg, ep, **kw):
    if kind == "ingest":
        return ZmqIngest(cfg, endpoint=ep, timeout_ms=100, **kw)
    if kind == "producer":
        return ZmqProducer(cfg, endpoint=ep, **kw)
    if kind == "egress":
        return ZmqEgress(cfg, endpoint=ep, **kw)
    return ZmqResultConsumer(cfg, endpoint=ep, timeout_ms=100, **kw)


@pytest.mark.parametrize("kind, default_messages", [
    ("ingest", DEFAULT_HWM), ("producer", DEFAULT_HWM),
    ("egress", 2 * RESULT_HWM), ("consumer", 2 * RESULT_HWM)])
def test_every_socket_sets_both_high_water_marks(cfg, kind,
                                                 default_messages):
    """Both marks, read back with getsockopt, on every socket the module
    builds: a sector socket queues `hwm` sectors, a result socket 2 x
    `hwm` frames (zdb, zdr); libzmq's default of 1000 would let a
    backlogged SUB hold ~6.3 GB of sectors."""
    for kw, want in (({}, default_messages),
                     ({"hwm": 3}, 3 if kind in ("ingest", "producer")
                      else 6)):
        obj = _build(kind, cfg, _endpoint(), **kw)
        try:
            assert obj.sock.getsockopt(zmq.SNDHWM) == want
            assert obj.sock.getsockopt(zmq.RCVHWM) == want
        finally:
            obj.close()
    assert DEFAULT_HWM * DEFAULT_CONFIG.sector_nbytes_wire < 128 << 20
    with pytest.raises(ValueError, match="hwm"):
        _build(kind, cfg, _endpoint(), hwm=0)
