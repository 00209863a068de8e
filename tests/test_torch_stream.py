"""The port's stream path on the CPU: UdpProducer -> UdpIngest (loopback)
-> StreamingExecutor -> UdpEgress + VolumeScan, its CLI, and volume
checkpoints shared with wrp_tpu.  Ephemeral ports throughout."""

import json
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.runtime.volume import VolumeScan as JVolume
from wrp_tpu_torch import cli
from wrp_tpu_torch import config as tconfig
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.io import codec, frames
from wrp_tpu_torch.io.files import read_ascii_matrix
from wrp_tpu_torch.io.udp import UdpEgress, UdpIngest, UdpProducer
from wrp_tpu_torch.runtime import StreamingExecutor, VolumeScan

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

M, N = 64, 32


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sink():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(10.0)
    return s


def _jax_products(iqs):
    proc = jpipe.SectorProcessor(jtiny(m=M, n=N), method="pallas")
    zdb, zdr = proc(jnp.asarray(np.stack(iqs), jnp.complex64))
    return np.asarray(zdb), np.asarray(zdr)


def test_udp_stream_matches_jax_pallas():
    """Every sector arrives, and the products (volume and egress frames)
    equal wrp_tpu's SectorProcessor(method="pallas") to < 2e-4."""
    cfg = tiny_config(m=M, n=N)
    n_sectors = 7
    iqs = [oracle.produce_sector_iq(jtiny(m=M, n=N), 3, k)
           for k in range(n_sectors)]
    ingest = UdpIngest(cfg, port=0, timeout_s=1.0)
    zdb_sock, zdr_sock = _sink(), _sink()
    egress = UdpEgress(cfg, zdb_port=zdb_sock.getsockname()[1],
                       zdr_port=zdr_sock.getsockname()[1], extended=True)
    volume = VolumeScan(cfg)
    ready = threading.Event()
    ex = StreamingExecutor(cfg, transport=ingest, publish=egress, batch=3,
                           method="pallas", volume=volume,
                           max_sectors=n_sectors, idle_limit=5,
                           on_ready=ready.set, device="cpu")
    ex.timers.enable_intervals(annotate=True)   # NVTX is a no-op on the CPU
    out = {}
    runner = threading.Thread(target=lambda: out.update(ex.run()),
                              daemon=True)
    runner.start()
    assert ready.wait(timeout=60)
    producer = UdpProducer(cfg, port=ingest.local_port, extended_headers=True)
    for k, iq in enumerate(iqs):
        producer.send_sector(codec.encode_iq(iq, cfg), sector=k, elevation=1)
    runner.join(timeout=60)
    assert not runner.is_alive()
    frames_db = {}
    for _ in range(n_sectors):
        sec, elev, zdb = frames.unpack_result_udp(zdb_sock.recv(65536))
        sec2, elev2, zdr = frames.unpack_result_udp(zdr_sock.recv(65536))
        assert (sec, elev) == (sec2, elev2)
        frames_db[sec] = (elev, zdb, zdr)
    for s in (zdb_sock, zdr_sock):
        s.close()
    producer.close()
    ingest.close()
    egress.close()

    assert out["processed_sectors"] == n_sectors
    assert out["transport"]["dropped_sectors"] == 0
    assert out["latency_ms"]["count"] == n_sectors
    spans = {(name, thread.startswith("wrp-ingest"))
             for name, thread, t0, t1 in ex.timers.intervals if t1 >= t0}
    assert {("ingest/recv", True), ("ingest/decode", True),
            ("compute/dispatch", False), ("compute/in_flight", False),
            ("egress/send", False)} <= spans
    assert volume.coverage[:n_sectors, 1].all()
    assert volume.coverage.sum() == n_sectors
    jzdb, jzdr = _jax_products(iqs)
    for k in range(n_sectors):
        elev, fzdb, fzdr = frames_db[k]
        assert elev == 1
        np.testing.assert_array_equal(fzdb, volume.data[0, :, k, 1])
        assert oracle.relative_l2(jzdb[k], volume.data[0, :, k, 1]) < 2e-4
        assert oracle.relative_l2(jzdr[k], volume.data[1, :, k, 1]) < 2e-4
        assert volume.data[0, 0, k, 1] == -np.inf


def test_executor_stages_batches_on_cpu():
    """Batches smaller than the staging shape scrub no live rows, and an
    override processor sees the padded batch with its labels."""
    cfg = tiny_config(m=M, n=N)
    seen = []

    def step(planar, labels):
        seen.append((planar.shape, planar.dtype, labels.copy()))
        z = np.full((planar.shape[0], cfg.num_output_bins), 1.0, np.float32)
        return z, z

    ex = StreamingExecutor(cfg, transport=None, batch=4, processor=step)
    from wrp_tpu_torch.runtime.executor import SectorTask

    sector = np.ones((cfg.num_channels, 2, M, N), np.int16)
    tasks = [SectorTask(sector, k, 0) for k in range(3)]
    assert ex._process_batch(tasks) == 3
    assert ex._process_batch(tasks[:1]) == 1
    assert ex._process_batch(tasks[:2]) == 2
    shape, dtype, labels = seen[-1]
    assert shape == (4, cfg.num_channels, 2, M, N) and dtype == np.int16
    assert labels.tolist() == [[0, 0], [1, 0], [-1, -1], [-1, -1]]
    # slot 0 held 3 rows, then 2: its third row was scrubbed
    assert not ex._host_np[0][2].any() and ex._host_np[0][1].all()


def test_cli_stream_and_produce(tmp_path, monkeypatch, capsys):
    """`cli stream` fed by `cli produce` over loopback, with a volume
    checkpoint, at a tiny geometry; products vs wrp_tpu < 2e-4."""
    monkeypatch.setattr(tconfig, "DEFAULT_CONFIG", tiny_config(m=M, n=N))
    port = _free_port()
    ready = tmp_path / "ready"
    ckpt = tmp_path / "vol.npz"
    rc = {}
    args = ["stream", "--device", "cpu", "--method", "pallas",
            "--ingest-port", str(port), "--batch", "2", "--timeout", "1",
            "--idle-limit", "4", "--max-sectors", "4", "--ready-file",
            str(ready), "--checkpoint", str(ckpt), "--zdb-port",
            str(_free_port()), "--zdr-port", str(_free_port())]
    runner = threading.Thread(target=lambda: rc.update(s=cli.main(args)),
                              daemon=True)
    runner.start()
    deadline = time.monotonic() + 60
    while not ready.exists():
        assert time.monotonic() < deadline, "stream never became ready"
        time.sleep(0.05)
    assert cli.main(["produce", "--sectors", "4", "--ingest-port", str(port),
                     "--per-sector-seed", "--seed", "8", "--headers"]) == 0
    runner.join(timeout=60)
    assert not runner.is_alive() and rc["s"] == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["processed_sectors"] == 4
    assert stats["volume_coverage"] == pytest.approx(4 / (8 * 2))
    vol = JVolume.load(ckpt)     # the JAX package reads the port's file
    jzdb, jzdr = _jax_products([oracle.produce_sector_iq(jtiny(m=M, n=N), 8, k)
                                for k in range(4)])
    for k in range(4):
        assert oracle.relative_l2(jzdb[k], vol.data[0, :, k, 0]) < 2e-4
        assert oracle.relative_l2(jzdr[k], vol.data[1, :, k, 0]) < 2e-4


def test_volume_checkpoints_interoperate(tmp_path):
    cfg = tiny_config(m=M, n=N)
    rng = np.random.default_rng(0)
    mine = VolumeScan(cfg, tmp_path / "port.npz")
    mine.store(3, 1, rng.standard_normal(M // 2), rng.standard_normal(M // 2))
    mine.save()
    theirs = JVolume.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(theirs.data, mine.data)
    np.testing.assert_array_equal(theirs.coverage, mine.coverage)
    jv = JVolume(jtiny(m=M, n=N), tmp_path / "jax.npz")
    jv.store(5, 0, rng.standard_normal(M // 2), rng.standard_normal(M // 2))
    jv.save()
    back = VolumeScan.load(tmp_path / "jax.npz", cfg)
    np.testing.assert_array_equal(back.data, jv.data)
    np.testing.assert_array_equal(back.coverage, jv.coverage)
    assert back.fraction() == jv.fraction()


@pytest.mark.parametrize("method,tol", [("pallas", 2e-4), ("mxu", 1e-5)])
def test_cli_process_synthetic_matches_oracle(tmp_path, method, tol):
    out = tmp_path / "result.out"
    assert cli.main(["process", "--input", "synthetic", "--device", "cpu",
                     "--method", method, "--output", str(out)]) == 0
    got = read_ascii_matrix(out)
    zdb64, zdr64 = oracle.process_sector(
        oracle.synthetic_iq(kind="noise", seed=0))
    # the ASCII output keeps 6 significant digits (format "g")
    assert oracle.relative_l2(zdb64, got[:, 0]) < tol + 1e-6
    assert oracle.relative_l2(zdr64, got[:, 1]) < tol + 1e-6
    assert got[0, 0] == -np.inf


def test_cli_refuses_cuda_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["process", "--input", "synthetic"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


class _EndlessFeed:
    """An endless memory feed: the same encoded sector, sector labels
    counting up, as fast as the executor takes them."""

    def __init__(self, wire, num_sectors):
        self.wire, self.num_sectors, self.k = wire, num_sectors, 0

    def recv_sector(self):
        self.k += 1
        return self.wire, frames.IngestHeader(self.k % self.num_sectors, 0, 0)


def test_stop_from_another_thread_ends_run():
    """stop() from a second thread ends a run() that streams an endless
    feed: run() returns within a bounded time with its stats, its ingest
    threads joined."""
    cfg = tiny_config(m=M, n=N)
    wire = codec.encode_iq(oracle.produce_sector_iq(jtiny(m=M, n=N), 3, 0),
                           cfg)
    published = threading.Event()
    ex = StreamingExecutor(cfg, transport=_EndlessFeed(wire, cfg.num_sectors),
                           publish=lambda *a: published.set(), batch=2,
                           method="pallas", device="cpu")
    out = {}
    runner = threading.Thread(target=lambda: out.update(ex.run()),
                              daemon=True)
    runner.start()
    assert published.wait(timeout=60)
    t0 = time.monotonic()
    ex.stop()
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert time.monotonic() - t0 < 30
    assert out["processed_sectors"] >= 1
    assert out["latency_ms"]["count"] == out["processed_sectors"]
    assert ex._ingest_threads and not any(t.is_alive()
                                          for t in ex._ingest_threads)


class _V1Recorder:
    """A user's egress with the v1 signature: send(sector, zdb, zdr)."""

    def __init__(self):
        self.calls = []

    def send(self, sector, zdb, zdr):
        self.calls.append((int(sector), np.array(zdb), np.array(zdr)))


class _OpaqueRecorder(_V1Recorder):
    """A v1 send whose signature cannot be read: the executor probes it
    once by call."""

    def send(self, sector, zdb, zdr):
        super().send(sector, zdb, zdr)

    send.__signature__ = "unreadable"     # inspect.signature raises


def _fixed_step(cfg):
    """An override step both executors run: products from the staged
    samples, the same float32 arrays for the same batch."""
    def step(planar, labels):
        x = np.asarray(planar, np.float32)
        zdb = (x[:, 0, 0, : cfg.num_output_bins, 0]
               + labels[:, :1].astype(np.float32))
        return zdb, -zdb
    return step


@pytest.mark.parametrize("egress", ["v1-object", "v1-opaque", "udp-v1"])
def test_v1_egress_through_executor_matches_wrp_tpu(egress):
    """An egress whose send takes (sector, zdb, zdr) runs through the
    port's executor as through wrp_tpu's: the arity read once, by
    signature (or one probing call when it cannot be read), and the same
    calls or v1 frames (wrp_tpu.io.udp.UdpEgress(extended=False) to a
    loopback consumer) from both."""
    from wrp_tpu.io.udp import UdpEgress as JUdpEgress
    from wrp_tpu.runtime.executor import SectorTask as JTask
    from wrp_tpu.runtime.executor import StreamingExecutor as JExecutor
    from wrp_tpu_torch.runtime.executor import SectorTask

    cfg, jcfg = tiny_config(m=M, n=N), jtiny(m=M, n=N)
    rng = np.random.default_rng(5)
    sectors = rng.integers(-2048, 2048, (3, cfg.num_channels, 2, M, N)
                           ).astype(np.int16)
    got = {}
    for name, Executor, Task, c in (("port", StreamingExecutor, SectorTask,
                                     cfg),
                                    ("wrp_tpu", JExecutor, JTask, jcfg)):
        sinks = None
        if egress == "udp-v1":
            sinks = (_sink(), _sink())
            pub = JUdpEgress(jcfg, zdb_port=sinks[0].getsockname()[1],
                             zdr_port=sinks[1].getsockname()[1],
                             extended=False)
        else:
            pub = _V1Recorder() if egress == "v1-object" else _OpaqueRecorder()
        ex = Executor(c, transport=None, publish=pub, batch=2,
                      processor=_fixed_step(cfg), checkpoint_every_s=None)
        tasks = [Task(sectors[k], 10 + k, 1) for k in range(3)]
        assert ex._process_batch(tasks[:2]) == 2
        assert ex._process_batch(tasks[2:]) == 1
        assert ex._pub_v2 == {0: False}
        if sinks is None:
            got[name] = pub.calls
        else:
            got[name] = [(s0.recv(65536), s1.recv(65536))
                         for s0, s1 in [sinks] * 3]
            for s in sinks:
                s.close()
            pub.close()
    assert len(got["port"]) == 3
    if egress == "udp-v1":
        assert got["port"] == got["wrp_tpu"]
        sec, zdb = frames.unpack_result_v1(got["port"][0][0])
        assert sec == 10 and zdb.shape == (cfg.num_output_bins,)
    else:
        for (s0, db0, dr0), (s1, db1, dr1) in zip(got["port"], got["wrp_tpu"]):
            assert s0 == s1
            np.testing.assert_array_equal(db0, db1)
            np.testing.assert_array_equal(dr0, dr1)
