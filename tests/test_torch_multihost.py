"""The port's multi-rank paths on the CPU: real 2-rank process groups over
gloo (torch.distributed), in subprocesses on ephemeral ports.

* PulseShardedProcessor (pallas-seq, fft, mxu; host and device decode) and
  the data-parallel MultiHostProcessor against wrp_tpu's single-device
  SectorProcessor (zdb/zdr <= 1e-5, tests/test_multihost.py:139's check);
* a misaligned batch refused on both ranks;
* `cli stream --pulse-shard --method pallas` on one broadcast wire, host
  and device decode: identical volumes on both ranks, products within 1e-5
  of wrp_tpu's single-device pallas;
* a SIGSTOPped peer: the survivor saves its checkpoint and exits 3 within
  a bound.

Every subprocess has a timeout.  The rank pairs run through the shared
runner (parallel/launch.py), which reruns a pair once on a fresh port when
its rendezvous could not bind the port it was handed.  The card runs the
same code at world size 1 over NCCL (chip_smoke.py)."""

import json
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import cpu_subprocess_env

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import DEFAULT_CONFIG as JDEFAULT
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu_torch.parallel.launch import run_ranks
from wrp_tpu_torch.runtime import VolumeScan

REPO = Path(__file__).resolve().parent.parent
M, N, B = 128, 64, 4


def _free_port(kind=socket.SOCK_STREAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    # two torch threads per rank: the suite runs beside CPU-time floors
    return cpu_subprocess_env(OMP_NUM_THREADS="2")


def _run_ranks(script, *args, timeout=240):
    """Run `script` as ranks 0 and 1 of a fresh group; (rc, out, err) each.
    The shared rank runner (parallel/launch.py) reruns both ranks once on a
    fresh port when the group's store could not bind the one it was given
    (another test took it after the runner found it free)."""
    results = run_ranks(
        lambda pid, port: [sys.executable, "-c", script, str(pid), "2",
                           str(port), *map(str, args)],
        2, timeout, env=_env(), cwd=str(REPO))
    return [(r.rc, r.out, r.err) for r in results]


def _iq(seed):
    rng = np.random.default_rng(seed)
    shape = (B, 3, M, N)
    return rng.integers(-2048, 2048, shape) + 1j * rng.integers(-2048, 2048, shape)


PARITY_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.parallel.launch import end_rank
from wrp_tpu_torch.parallel.multihost import (
    MultiHostProcessor, PulseShardedProcessor, init_distributed)

pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = init_distributed(f"127.0.0.1:{port}", nproc, pid, "cpu")
assert init_distributed(f"127.0.0.1:{port}", nproc, pid, "cpu") == dev
cfg = tiny_config(m=128, n=64)
B = 4

def iq(seed):
    rng = np.random.default_rng(seed)
    shape = (B, *cfg.sector_shape)
    return rng.integers(-2048, 2048, shape) + 1j * rng.integers(-2048, 2048, shape)

def planar(x):
    return np.stack([x.real, x.imag], 2).astype(np.int16)

shared = iq(7)                       # the SAME sectors on every rank: one wire
labels = np.stack([np.arange(B), np.zeros(B)], 1).astype(np.int32)
res = {}
for method in ("pallas", "fft", "mxu"):
    proc = PulseShardedProcessor.build(cfg, batch=B, method=method, device="cpu")
    assert proc.mesh.shape == {"data": 1, "seq": nproc}, proc.mesh
    assert proc._pulse_slice == slice(pid * 32, (pid + 1) * 32)
    zdb, zdr = proc.step_local(planar(shared), labels=labels)
    res[method + "_zdb"], res[method + "_zdr"] = zdb.numpy(), zdr.numpy()
wires = np.stack([np.frombuffer(codec.encode_iq(shared[k], cfg), np.uint8)
                  for k in range(B)])
proc = PulseShardedProcessor.build(cfg, batch=B, method="pallas",
                                   device_decode=True, device="cpu")
assert proc.wire_input
zdb, zdr = proc.step_local(wires, labels=labels)
res["wire_zdb"], res["wire_zdr"] = zdb.numpy(), zdr.numpy()
# data-parallel: each rank its own sectors, no collective
own = MultiHostProcessor.build(cfg, per_host_batch=B, method="pallas", device="cpu")
assert own.mesh.shape == {"data": nproc, "seq": 1}
zdb, zdr = own.step_local(planar(iq(100 + pid)))
res["dp_zdb"], res["dp_zdr"] = zdb.numpy(), zdr.numpy()
np.savez(out % pid, **res)
print(f"PARITY_OK rank={pid}", flush=True)
end_rank(0)
"""


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    # each rank writes rank<pid>.npz
    return d, _run_ranks(PARITY_WORKER, d / "rank%d.npz")


def _rank_results(parity_runs):
    d, outs = parity_runs
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0 and "PARITY_OK" in out, (pid, rc, out, err[-3000:])
    return [dict(np.load(str(d / "rank%d.npz") % pid)) for pid in range(2)]


@pytest.mark.parametrize("method,jmethod", [("pallas", "pallas"),
                                            ("fft", "fft"), ("mxu", "mxu"),
                                            ("wire", "pallas")])
def test_pulse_sharded_two_ranks_match_single_device(parity_runs, method,
                                                     jmethod):
    """Both ranks return the full products, equal to each other and to
    wrp_tpu's single-device SectorProcessor within 1e-5 (pallas: the
    A-stage slab, the gloo all_to_all, the row epilogue; wire: each rank
    decodes only its pulse-byte columns)."""
    ranks = _rank_results(parity_runs)
    jzdb, jzdr = (np.asarray(t) for t in jpipe.SectorProcessor(
        jtiny(m=M, n=N), method=jmethod)(jnp.asarray(_iq(7), jnp.complex64)))
    for r in ranks:
        assert r[f"{method}_zdb"].shape == (B, M // 2)
        assert oracle.relative_l2(jzdb, r[f"{method}_zdb"]) < 1e-5
        assert oracle.relative_l2(jzdr, r[f"{method}_zdr"]) < 1e-5
    if method == "wire":
        for r in ranks:
            assert oracle.relative_l2(r["pallas_zdb"], r["wire_zdb"]) <= 1e-6
            assert oracle.relative_l2(r["pallas_zdr"], r["wire_zdr"]) <= 1e-6
    np.testing.assert_array_equal(ranks[0][f"{method}_zdb"],
                                  ranks[1][f"{method}_zdb"])


def test_data_parallel_two_ranks_own_sectors(parity_runs):
    """MultiHostProcessor: each rank's products are those of its own
    sectors (wrp_tpu single-device pallas, <= 1e-5)."""
    ranks = _rank_results(parity_runs)
    for pid, r in enumerate(ranks):
        jzdb, jzdr = (np.asarray(t) for t in jpipe.SectorProcessor(
            jtiny(m=M, n=N), method="pallas")(
                jnp.asarray(_iq(100 + pid), jnp.complex64)))
        assert oracle.relative_l2(jzdb, r["dp_zdb"]) < 1e-5
        assert oracle.relative_l2(jzdr, r["dp_zdr"]) < 1e-5


MISALIGN_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.parallel.multihost import PulseShardedProcessor, init_distributed

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed(f"127.0.0.1:{port}", nproc, pid, "cpu")
cfg = tiny_config(m=64, n=32)
B = 4
planar = np.random.default_rng(7).integers(
    -2048, 2048, (B, cfg.num_channels, 2, 64, 32)).astype(np.int16)
proc = PulseShardedProcessor.build(cfg, batch=B, method="pallas", device="cpu")
labels = np.stack([np.arange(B), np.zeros(B)], 1).astype(np.int32)
zdb, _ = proc.step_local(planar, labels=labels)     # aligned: passes
assert zdb.shape == (B, 32)
# rank 1 shifts its labels by one (a dropped wire sector): EVERY rank
# must refuse the step instead of mixing pulse columns
try:
    proc.step_local(planar, labels=labels + (1 if pid == 1 else 0))
except RuntimeError as e:
    assert "misaligned" in str(e) and "slot 0" in str(e), e
    print(f"MISALIGN_CAUGHT rank={pid}", flush=True)
else:
    print(f"MISALIGN_MISSED rank={pid}", flush=True)
"""


def test_pulse_shard_misaligned_batch_refused():
    for pid, (rc, out, err) in enumerate(_run_ranks(MISALIGN_WORKER)):
        assert "MISALIGN_CAUGHT" in out, (pid, rc, out, err[-3000:])


def _stream_rank(pid, coord, ing, tmp_path, extra, ckpt=None):
    ready = tmp_path / f"ready{pid}"
    cmd = [sys.executable, "-m", "wrp_tpu_torch.cli", "stream",
           "--device", "cpu", "--ingest-port", str(ing),
           "--zdb-port", str(_free_port(socket.SOCK_DGRAM)),
           "--zdr-port", str(_free_port(socket.SOCK_DGRAM)),
           "--batch", "2", "--ready-file", str(ready),
           "--checkpoint", str(ckpt or tmp_path / f"vol{pid}.npz"),
           "--coordinator", f"127.0.0.1:{coord}", "--num-hosts", "2",
           "--host-id", str(pid), *extra]
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), ready


def _await_ready(ranks, deadline_s=180):
    deadline = time.monotonic() + deadline_s
    while not all(r.exists() for _, r in ranks):
        for p, _ in ranks:
            assert p.poll() is None, p.communicate()
        assert time.monotonic() < deadline, "ranks never became ready"
        time.sleep(0.25)


def _kill_all(ranks):
    for p, _ in ranks:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=30)


@pytest.mark.parametrize("decode", [["--device-decode"], []],
                         ids=["device-decode", "host-decode"])
def test_cli_pulse_shard_one_broadcast_wire(tmp_path, decode):
    """ONE producer broadcasts on the loopback broadcast address; both
    ranks bind the same port (SO_REUSEPORT) and receive every sector.  Both
    produce the same full volume, within 1e-5 of wrp_tpu's single-device
    pallas products (DEFAULT_CONFIG, 3 x 1024 x 512)."""
    coord, ing = _free_port(), _free_port(socket.SOCK_DGRAM)
    ranks = [_stream_rank(pid, coord, ing, tmp_path,
                          ["--method", "pallas", "--pulse-shard",
                           "--max-sectors", "2", "--timeout", "60", *decode])
             for pid in range(2)]
    try:
        _await_ready(ranks)
        subprocess.run(
            [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
             "--host", "127.255.255.255", "--ingest-port", str(ing),
             "--sectors", "2", "--headers", "--per-sector-seed", "--seed",
             "5"], cwd=REPO, env=_env(), check=True, capture_output=True,
            timeout=120)
        vols = []
        for pid, (p, _) in enumerate(ranks):
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, (pid, out[-500:], err[-3000:])
            stats = json.loads(out[out.index("{"):])
            assert stats["processed_sectors"] == 2, (pid, stats)
            assert stats["batches"] == 1 and stats["stall_warnings"] == 0
            vols.append(VolumeScan.load(tmp_path / f"vol{pid}.npz"))
    finally:
        _kill_all(ranks)
    np.testing.assert_array_equal(vols[0].coverage, vols[1].coverage)
    np.testing.assert_array_equal(vols[0].data, vols[1].data)
    assert int(vols[0].coverage.sum()) == 2
    iq = np.stack([oracle.produce_sector_iq(JDEFAULT, 5, k) for k in range(2)])
    jzdb, jzdr = (np.asarray(t) for t in jpipe.SectorProcessor(
        JDEFAULT, method="pallas")(iq.astype(np.complex64)))
    for k in range(2):
        assert oracle.relative_l2(jzdb[k], vols[0].data[0, :, k, 0]) < 1e-5
        assert oracle.relative_l2(jzdr[k], vols[0].data[1, :, k, 0]) < 1e-5


def test_pulse_shard_stopped_peer_bounded_exit(tmp_path):
    """SIGSTOP freezes rank 1 with its sockets open (a silent peer: no
    error, no reset); rank 0 gets a full batch and blocks in the step's
    collective.  The watchdog must end it: exit 3, checkpoint saved, the
    stats as the last stderr line, within a bound."""
    coord = _free_port()
    ports = [_free_port(socket.SOCK_DGRAM) for _ in range(2)]
    ranks = [_stream_rank(pid, coord, ports[pid], tmp_path,
                          ["--method", "pallas", "--pulse-shard",
                           "--max-sectors", "4", "--timeout", "5",
                           "--collective-timeout", "12"])
             for pid in range(2)]
    try:
        _await_ready(ranks)
        ranks[1][0].send_signal(signal.SIGSTOP)
        subprocess.run(
            [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
             "--ingest-port", str(ports[0]), "--sectors", "2", "--headers"],
            cwd=REPO, env=_env(), check=True, capture_output=True,
            timeout=120)
        t0 = time.monotonic()
        out, err = ranks[0][0].communicate(timeout=120)
        waited = time.monotonic() - t0
    finally:
        _kill_all(ranks)
    assert ranks[0][0].returncode == 3, (out[-500:], err[-3000:])
    assert "collective dispatch blocked/failed" in err, err[-3000:]
    assert "collective timeout 12.0" in err, err[-3000:]
    assert (tmp_path / "vol0.npz").exists()
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["processed_sectors"] == 0 and stats["batches"] == 1
    assert waited < 60, waited


@pytest.mark.parametrize("decode", [[], ["--device-decode"]],
                         ids=["host-decode", "device-decode"])
def test_pulse_shard_ranks_tool_on_cpu(decode):
    """wrp_tpu_torch/tools/pulse_shard_ranks.py (the N-rank check the cards
    run over NCCL) on 2 gloo ranks at a small geometry: every rank's full
    products equal the single-device fused chain's and the oracle's; with
    host decode for each of its methods in one group (pallas-seq, mxu, fft,
    halo), with device decode for pallas-seq, its default."""
    methods = [] if decode else ["--method", "pallas-seq,mxu,fft,halo"]
    done = subprocess.run(
        [sys.executable, "wrp_tpu_torch/tools/pulse_shard_ranks.py",
         "--ranks", "2", "--device", "cpu", "--m", "128", "--n", "64",
         "--batch", "2", "--reps", "1", "--timeout", "200", *decode,
         *methods],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-3000:])
    rows = [json.loads(ln) for ln in done.stdout.splitlines()
            if ln.startswith("{")]
    want = ["pallas-seq"] if decode else ["pallas-seq", "mxu", "fft", "halo"]
    assert sorted((r["rank"], r["method"]) for r in rows) == sorted(
        (k, m) for k in (0, 1) for m in want)
    for r in rows:
        assert r["ok"] and r["backend"] == "gloo" and r["ranks"] == 2
        assert r["zdb_rel_vs_single"] <= 1e-5 and r["zdr_rel_vs_single"] <= 1e-5
        assert r["device_decode"] == bool(decode)


# a stand-in rank: fails like a store that could not bind its port until
# the file it is given exists, then succeeds
BIND_ONCE = r"""
import os, sys
marker, rank = sys.argv[1], sys.argv[2]
with open(marker + ".log", "a") as f:
    f.write(rank + "\n")
if not os.path.exists(marker):
    if rank == "1":
        open(marker, "w").close()
    sys.stderr.write("The server socket has failed to listen on any local "
                     "network address. code: -98, name: EADDRINUSE\n")
    sys.exit(1)
print("ran", rank)
"""


@pytest.mark.parametrize("message,retried", [
    ("EADDRINUSE", True), ("address already in use", True),
    ("some other failure", False)])
def test_rank_runner_reruns_once_on_a_bind_failure(tmp_path, message,
                                                   retried):
    """parallel/launch.run_ranks reruns the whole rank set once, on a
    fresh port, when a rank reports that the rendezvous store could not
    bind; any other failure is returned as it is, without a rerun."""
    marker = tmp_path / "bound"
    script = BIND_ONCE.replace("code: -98, name: EADDRINUSE", message)
    results = run_ranks(
        lambda rank, port: [sys.executable, "-c", script, str(marker),
                            str(rank)], 2, 60, env=_env())
    starts = (tmp_path / "bound.log").read_text().split()
    if retried:
        assert [r.rc for r in results] == [0, 0]
        assert [r.out.split() for r in results] == [["ran", "0"],
                                                    ["ran", "1"]]
        assert sorted(starts) == ["0", "0", "1", "1"]
    else:
        # rank 1 always fails; rank 0 fails too unless rank 1 already
        # left the file
        assert results[1].rc == 1 and message in results[1].err
        assert sorted(starts) == ["0", "1"]


def test_rank_runner_stops_peers_of_a_failed_rank():
    """A rank that fails leaves its peers `grace_s` before they are killed
    (a peer blocked in a collective would otherwise hold the run to its
    time limit); a killed rank reports 124."""
    t0 = time.monotonic()
    results = run_ranks(
        lambda rank, port: [sys.executable, "-c",
                            "import sys, time; rank = int(sys.argv[1]); "
                            "time.sleep(60 if rank else 0); sys.exit(2)",
                            str(rank)], 2, 120, env=_env(), grace_s=1.0)
    assert [r.rc for r in results] == [2, 124]
    assert time.monotonic() - t0 < 30
