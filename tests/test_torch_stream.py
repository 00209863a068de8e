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
