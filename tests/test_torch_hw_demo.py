"""The port's end-to-end demo, `python -m wrp_tpu_torch.tools.hw_demo`, on
the CPU (the card runs it in chip_smoke.py, phase_hw_demo): stream ->
consume -> produce -> volume over UDP loopback on free ports, the two
volumes equal and equal to wrp_tpu's fp64 oracle; its verdict; its refusal
without CUDA; and `cli consume`'s graceful end on SIGTERM, which bounds the
demo's wait for a consumer that will not reach its count."""

import json
import selectors
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from wrp_tpu_torch.tools import hw_demo

REPO = Path(__file__).resolve().parent.parent
SECTORS = 3


def _env(**extra):
    from conftest import cpu_subprocess_env

    return cpu_subprocess_env(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="",
                              **extra)


def test_demo_on_the_cpu_prints_match_and_equals_the_oracle(tmp_path):
    """A few sectors at the production geometry, paced so that loopback
    drops nothing: exit 0, MATCH, and both volumes (the processor's
    checkpoint and the consumer's rebuild) within the stream tests' 2e-4 of
    wrp_tpu's oracle products for the sectors `cli produce` sent (its
    default source: seed 0, sector k the k-th draw)."""
    from wrp_tpu import DEFAULT_CONFIG, oracle
    from wrp_tpu_torch.runtime import VolumeScan

    out = tmp_path / "demo"
    done = subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.tools.hw_demo", "--device",
         "cpu", "--rate", "2", "--out", str(out), str(SECTORS)], cwd=REPO, capture_output=True, text=True,
        timeout=400, env=_env())
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-3000:])
    lines = done.stdout.strip().splitlines()
    assert lines[-1] == "MATCH"
    assert lines[0].startswith("stream rc=0 consume rc=0 produce rc=0")
    stats = json.loads((out / "stream_stats.json").read_text())
    assert stats["processed_sectors"] == SECTORS
    assert stats["kernel_launches"]["radix"] == 0     # the CPU: plain
    assert (out / "mosaic.ppm").read_bytes().startswith(b"P6")

    cfg = DEFAULT_CONFIG
    rng = np.random.default_rng(0)
    vols = [VolumeScan.load(out / name) for name in ("proc.npz", "rx.npz")]
    for k in range(SECTORS):
        iq = (rng.integers(-8192, 8192, cfg.sector_shape)
              + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
        zdb, zdr = oracle.process_sector(iq, cfg)
        for vol in vols:
            assert vol.coverage[k, 0]
            assert oracle.relative_l2(zdb, vol.data[0, :, k, 0]) < 2e-4
            assert oracle.relative_l2(zdr, vol.data[1, :, k, 0]) < 2e-4
    assert all(int(v.coverage.sum()) == SECTORS for v in vols)


def test_verdict_names_the_keys_that_differ():
    proc = {"coverage": 0.0031, "sectors_covered": 4,
            "elevations_touched": 1, "complete": False, "zdb_min": 7.18,
            "zdb_max": 62.48, "zdr_mean": 0.0}
    assert hw_demo.verdict(proc, dict(proc)) == ("MATCH", 0)
    # "complete" is not among the compared keys, as in the script
    assert hw_demo.verdict(proc, {**proc, "complete": True}) == ("MATCH", 0)
    assert hw_demo.verdict(proc, {**proc, "zdb_max": 62.49}) == (
        "MISMATCH on ['zdb_max']", 1)


def test_no_cuda_without_device_cpu_exits_2(tmp_path):
    """The default device is cuda: nothing starts, nothing is written."""
    done = subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.tools.hw_demo", "--out",
         str(tmp_path / "demo"), "2"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=_env())
    assert done.returncode == 2, (done.stdout[-500:], done.stderr[-1000:])
    assert "CUDA is not available" in done.stderr and done.stdout == ""
    assert not (tmp_path / "demo").exists()


def test_consume_saves_its_volume_on_sigterm(tmp_path):
    """`cli consume` takes SIGTERM as the end of its reception, as `cli
    stream` does: it exits 0 and saves what it received."""
    from wrp_tpu_torch.config import DEFAULT_CONFIG
    from wrp_tpu_torch.io.frames import pack_result_v1x
    from wrp_tpu_torch.parallel.launch import free_port
    from wrp_tpu_torch.runtime import VolumeScan

    cfg = DEFAULT_CONFIG
    zdb_port, zdr_port = (free_port(socket.SOCK_DGRAM) for _ in range(2))
    vol = tmp_path / "rx.npz"
    consume = subprocess.Popen(
        [sys.executable, "-m", "wrp_tpu_torch.cli", "consume", "--count", "5",
         "--timeout", "120", "--volume", str(vol), "--port", str(zdb_port),
         "--zdr-port", str(zdr_port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(PYTHONUNBUFFERED="1"))
    values = np.linspace(1.0, 2.0, cfg.num_output_bins, dtype=np.float32)
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s, \
                selectors.DefaultSelector() as sel:
            sel.register(consume.stdout, selectors.EVENT_READ)

            def send():
                # zdr first: loopback queues it before the zdb frame, so a
                # printed zdb frame means its zdr frame was read too
                for port in (zdr_port, zdb_port):
                    s.sendto(pack_result_v1x(7, 1, values),
                             ("127.0.0.1", port))

            # the consumer binds after its imports: resend until it prints
            # a frame (one line a zdb frame), then once more, both bound
            for _ in range(240):
                send()
                if sel.select(timeout=0.5):
                    break
            lines = [consume.stdout.readline()]
            send()
            lines.append(consume.stdout.readline())
        assert all(ln.startswith("sector 7 elev 1:") for ln in lines), lines
        consume.send_signal(signal.SIGTERM)
        _, err = consume.communicate(timeout=60)
    finally:
        if consume.poll() is None:
            consume.kill()
            consume.wait()
    assert consume.returncode == 0, err[-2000:]
    assert "interrupted: reception ended" in err
    got = VolumeScan.load(vol)
    assert got.coverage[7, 1] and int(got.coverage.sum()) == 1
    np.testing.assert_array_equal(got.data[0, :, 7, 1], values)
    np.testing.assert_array_equal(got.data[1, :, 7, 1], values)
