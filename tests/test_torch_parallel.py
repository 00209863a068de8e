"""The port's pulse-sharded pieces on the CPU, in one process: the A-stage
and row-epilogue plain versions against wrp_tpu's kernels (Pallas in
interpret mode), the pallas-seq composition at N = 1, 2 and 4 done locally,
build_sharded_processor at world size 1 against wrp_tpu's single-device
processors, the pulse-sliced wire decode, SO_REUSEPORT, and the lock-step
executor's batching and watchdog.  The CUDA kernels themselves are checked
on the card by chip_smoke.py; the multi-rank runs are in
test_torch_multihost.py."""

import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wire import _sector, _wires

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops import device_codec as jdc
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.io.udp import UdpIngest, UdpProducer
from wrp_tpu_torch.ops import device_codec as tdc
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.parallel import build_sharded_processor, make_mesh
from wrp_tpu_torch.parallel.multihost import PulseShardedProcessor
from wrp_tpu_torch.parallel.sharded import join_pulses, split_rows
from wrp_tpu_torch.runtime import StreamingExecutor
from wrp_tpu_torch.runtime.executor import SectorTask, _StallWatchdog

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

M, N = 128, 64


def _planar_batch(cfg, kinds=("noise", "clip-bin", "noise"), seed=11):
    iqs = [_sector(cfg, k, seed=seed + i) for i, k in enumerate(kinds)]
    planar = np.stack([np.stack([iq.real, iq.imag], 1) for iq in iqs])
    return iqs, planar.astype(np.int16)       # [B, C, 2, m, n]


def _plan(cfg):
    return tfull.build_plan(PipelineConstants.build(cfg), "cpu")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_astage_reference_vs_jax_kernel(shards):
    """The A-stage plain version on each rank's natural-order pulse slab
    vs wrp_tpu's A-stage kernel on the same slab in radix row order:
    Y rel-L2 <= 1e-5 (w = n, n/2, n/4)."""
    cfg = tiny_config(m=M, n=N)
    _, planar = _planar_batch(cfg)
    x = planar.reshape(-1, 2, M, N)
    plan = _plan(cfg)
    consts = JConsts.build(jtiny(m=M, n=N))
    radix = jfull.radix_for(M)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(M, radix)
    w = N // shards
    for k in range(shards):
        slab = np.ascontiguousarray(x[..., k * w:(k + 1) * w])
        got = tfull.fused_chain_astage(torch.from_numpy(slab), plan).numpy()
        assert got.shape == (x.shape[0], 2, M // 2, w)
        want = np.asarray(jfull.fused_chain_astage(
            jnp.asarray(slab[:, :, order, :]), jnp.asarray(a_np), fac,
            interpret=True))
        assert oracle.relative_l2(want, got) <= 1e-5, k


@pytest.mark.parametrize("rows", [M // 2, M // 8])
def test_parseval_rows_reference_vs_jax_kernel(rows):
    """The row-epilogue plain version vs wrp_tpu's row-epilogue kernel on
    the same Y, at full rows and at a row shard: <= 1e-5; the wrapper on a
    CPU tensor is the plain version and launches nothing."""
    cfg = tiny_config(m=M, n=N)
    _, planar = _planar_batch(cfg)
    plan = _plan(cfg)
    y = tfull.fused_chain_astage_reference(
        torch.from_numpy(planar.reshape(-1, 2, M, N)), plan)
    y = y[:, :, rows:2 * rows].contiguous() if rows < M // 2 else y
    before = tfull.PARSEVAL_ROWS_LAUNCHES
    got = tfull.parseval_rows_power(y, plan)
    assert tfull.PARSEVAL_ROWS_LAUNCHES == before
    assert torch.equal(got, tfull.parseval_rows_power_reference(y, plan))
    consts = JConsts.build(jtiny(m=M, n=N))
    want = np.asarray(jfull.parseval_rows_power(
        jnp.asarray(y.numpy()), jnp.asarray(consts.wd),
        jnp.asarray(consts.clip_phasors), interpret=True))
    assert got.shape == (y.shape[0], rows)
    assert oracle.relative_l2(want, got.numpy()) <= 1e-5


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_local_composition_matches_fused_and_oracle(shards):
    """The pallas-seq composition done in one process: the A-stage on each
    pulse slab, the all_to_all's split/join done locally, the row epilogue
    on each row shard == the fused chain (<= 1e-5) and the fp64 oracle
    (power <= 1e-5), clip-bin sector included."""
    cfg = tiny_config(m=M, n=N)
    iqs, planar = _planar_batch(cfg)
    x = torch.from_numpy(planar.reshape(-1, 2, M, N))
    plan = _plan(cfg)
    w = N // shards
    sends = [split_rows(tfull.fused_chain_astage(
        x[..., k * w:(k + 1) * w].contiguous(), plan), shards)
        for k in range(shards)]
    pows = [tfull.parseval_rows_power(
        join_pulses(torch.stack([sends[k][d] for k in range(shards)])), plan)
        for d in range(shards)]
    got = torch.cat(pows, dim=-1).numpy()
    fused = tfull.fused_chain_power_radix(x, plan).numpy()
    assert oracle.relative_l2(fused, got) <= 1e-5
    got = got.reshape(len(iqs), cfg.num_channels, M // 2)
    for b, iq in enumerate(iqs):
        pow64 = oracle.channel_power(iq, jtiny(m=M, n=N))
        for c in range(cfg.num_channels):
            assert oracle.relative_l2(pow64[c], got[b, c]) <= 1e-5, (b, c)


@pytest.mark.parametrize("method,jmethod,tol", [
    ("pallas-seq", "pallas", 1e-5), ("pallas", "pallas", 1e-5),
    ("mxu", "mxu", 1e-5), ("fft", "fft", 1e-5)])
def test_sharded_world_one_matches_jax_single_device(method, jmethod, tol):
    """build_sharded_processor at world size 1 (no process group) vs
    wrp_tpu's SectorProcessor: zdb/zdr <= 1e-5, the bound of
    tests/test_sharding.py for the sharded-vs-single comparison."""
    cfg = tiny_config(m=M, n=N)
    iqs, planar = _planar_batch(cfg, kinds=("noise",) * 4)
    step = build_sharded_processor(cfg, make_mesh(device="cpu"), method=method,
                                   device="cpu")
    zdb, zdr = (t.numpy() for t in step(planar))
    jproc = jpipe.SectorProcessor(jtiny(m=M, n=N), method=jmethod)
    jzdb, jzdr = (np.asarray(t) for t in jproc(
        jnp.asarray(np.stack(iqs), jnp.complex64)))
    assert zdb.shape == (4, M // 2)
    assert oracle.relative_l2(jzdb, zdb) < tol
    assert oracle.relative_l2(jzdr, zdr) < tol


def test_pallas_seq_wire_input_matches_planar():
    """pallas-seq with wire_input (the rank's pulse-byte columns decoded on
    its device) == the planar pallas-seq step: <= 1e-6; and the
    pulse-shard processor at world size 1 slices nothing away."""
    cfg = tiny_config(m=M, n=N)
    iqs, planar = _planar_batch(cfg, kinds=("noise", "clip-bin"))
    wires = _wires(cfg, iqs)
    mesh = make_mesh(device="cpu")
    step_p = build_sharded_processor(cfg, mesh, "pallas-seq", device="cpu")
    step_w = build_sharded_processor(cfg, mesh, "pallas-seq", wire_input=True,
                                     device="cpu")
    zdb_p, zdr_p = step_p(planar)
    zdb_w, zdr_w = step_w(wires.reshape(2, M, -1))
    assert oracle.relative_l2(zdb_p.numpy(), zdb_w.numpy()) <= 1e-6
    assert oracle.relative_l2(zdr_p.numpy(), zdr_w.numpy()) <= 1e-6
    proc = PulseShardedProcessor.build(cfg, batch=2, method="pallas",
                                       device_decode=True, device="cpu")
    assert proc.wire_input and proc.mesh.shape == {"data": 1, "seq": 1}
    zdb, _ = proc.step_local(wires,
                             labels=np.array([[0, 0], [1, 0]], np.int32))
    assert oracle.relative_l2(zdb_p.numpy(), zdb.numpy()) <= 1e-6


def test_sharded_validation_errors():
    cfg = tiny_config(m=M, n=N)
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="wire_input"):
        build_sharded_processor(cfg, mesh, method="mxu", wire_input=True,
                                device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        build_sharded_processor(cfg, mesh, method="radix", device="cpu")
    with pytest.raises(ValueError, match="radix kernel plan"):
        build_sharded_processor(tiny_config(m=40, n=32), mesh, "pallas-seq",
                                device="cpu")
    with pytest.raises(ValueError, match="needs an initialised"):
        make_mesh(seq=2, device="cpu")
    with pytest.raises(ValueError, match="requires method='pallas'"):
        PulseShardedProcessor.build(cfg, method="mxu", device_decode=True,
                                    device="cpu")
    proc = PulseShardedProcessor.build(cfg, batch=2, method="fft",
                                       device="cpu")
    with pytest.raises(ValueError, match="expected"):
        proc.step_local(np.zeros((3, 3, 2, M, N), np.int16))
    with pytest.raises(ValueError, match="labels must be"):
        proc.step_local(np.zeros((2, 3, 2, M, N), np.int16),
                        labels=np.zeros((3, 2), np.int32))


def test_astage_and_rows_wrappers_refuse():
    """CPU tensors take the plain versions and launch nothing; a radix-1
    plan, a wrong shape or dtype, or another device raises."""
    cfg = tiny_config(m=M, n=N)
    plan = _plan(cfg)
    x = torch.zeros(2, 2, M, 16, dtype=torch.int16)
    before = (tfull.ASTAGE_LAUNCHES, tfull.PARSEVAL_ROWS_LAUNCHES)
    assert torch.equal(tfull.fused_chain_astage(x, plan),
                       tfull.fused_chain_astage_reference(x, plan))
    with pytest.raises(ValueError, match="unsupported device"):
        tfull.fused_chain_astage(x.to("meta"), plan)
    with pytest.raises(TypeError, match="int16 or float32"):
        tfull.fused_chain_astage(x.to(torch.int32), plan)
    with pytest.raises(ValueError, match=r"\[bc, 2, 128, w\]"):
        tfull.fused_chain_astage(torch.zeros(2, 2, 64, 16), plan)
    with pytest.raises(ValueError, match="radix plan"):
        tfull.fused_chain_astage(torch.zeros(1, 2, 40, 8),
                                 _plan(tiny_config(m=40, n=32)))
    y = torch.zeros(2, 2, 8, N)
    with pytest.raises(ValueError, match="unsupported device"):
        tfull.parseval_rows_power(y.to("meta"), plan)
    with pytest.raises(TypeError, match="float32"):
        tfull.parseval_rows_power(y.double(), plan)
    with pytest.raises(ValueError, match=rf"\[bc, 2, rows, {N}\]"):
        tfull.parseval_rows_power(torch.zeros(2, 2, 8, N // 2), plan)
    assert (tfull.ASTAGE_LAUNCHES, tfull.PARSEVAL_ROWS_LAUNCHES) == before
    assert tfull.astage_tile(plan) == 8
    assert tfull.astage_tile(_plan(tiny_config(m=32, n=16))) == 8


@pytest.mark.parametrize("shards", [2, 4])
def test_decode_wire_pulse_slice_matches_jax(shards):
    """decode_wire_i16(num_pulses=n/N) on one rank's pulse-byte columns ==
    wrp_tpu's, bit-exact, and == that slice of the full decode."""
    cfg = tiny_config(m=32, n=16)
    iq = _sector(cfg, "noise", seed=2)
    rows = _wires(cfg, [iq]).reshape(1, 32, -1)
    bps, w = cfg.bytes_per_sample, 16 // shards
    full = tdc.decode_wire_i16(torch.from_numpy(_wires(cfg, [iq])), cfg)
    for k in range(shards):
        cols = np.ascontiguousarray(rows[:, :, k * w * bps:(k + 1) * w * bps])
        got = tdc.decode_wire_i16(torch.from_numpy(cols.reshape(1, -1)), cfg,
                                  num_pulses=w).numpy()
        want = np.asarray(jdc.decode_wire_i16(
            jnp.asarray(cols.reshape(1, -1)), jtiny(m=32, n=16),
            num_pulses=w))
        np.testing.assert_array_equal(want, got)
        np.testing.assert_array_equal(full[..., k * w:(k + 1) * w].numpy(), got)


def test_udp_reuse_port_two_readers_one_broadcast_wire():
    """Two ingests bound to ONE port with reuse_port both receive every
    sector a producer broadcasts on the loopback broadcast address."""
    cfg = tiny_config(m=16, n=8)
    a = UdpIngest(cfg, port=0, timeout_s=2.0, reuse_port=True)
    b = UdpIngest(cfg, port=a.local_port, timeout_s=2.0, reuse_port=True)
    wire = codec.encode_iq(_sector(cfg, "noise", seed=3), cfg)
    prod = UdpProducer(cfg, host="127.255.255.255", port=a.local_port,
                       extended_headers=True)
    try:
        prod.send_sector(wire, sector=5, elevation=1)
        for ing in (a, b):
            got, header = ing.recv_sector()
            assert bytes(got) == wire and (header.sector, header.elevation) == (5, 1)
    finally:
        prod.close()
        a.close()
        b.close()


def test_lockstep_drain_waits_for_full_batches():
    """Lock-step drains full batches while ingest lives, a partial batch
    only at end of stream; a stall on the batch fill counts a warning."""
    cfg = tiny_config(m=16, n=8)
    ex = StreamingExecutor(cfg, batch=3, processor=lambda p: (p, p),
                           lockstep=True, stall_warning_s=0.5)
    alive = threading.Event()
    t = threading.Thread(target=alive.wait, daemon=True)
    t.start()
    ex._ingest_threads = [t]
    task = SectorTask(np.zeros((3, 2, 16, 8), np.int16), 0, 0)
    for _ in range(2):
        ex._queue.put(task)
    threading.Timer(1.2, lambda: ex._queue.put(task)).start()
    t0 = time.monotonic()
    assert len(ex._drain_batch()) == 3          # waited for the third
    assert time.monotonic() - t0 >= 1.0 and ex.stall_warnings >= 1
    ex._queue.put(task)
    ex._queue.put(None)                         # end of stream
    assert len(ex._drain_batch()) == 1
    assert ex._drain_batch() is None
    alive.set()


def test_stall_watchdog_warns_then_times_out():
    warned, fired = [], []
    with _StallWatchdog("collective dispatch", 0.2,
                        on_warn=lambda: warned.append(1), timeout_s=0.7,
                        on_timeout=lambda what, s: fired.append((what, s))):
        time.sleep(1.2)
    assert len(warned) >= 2
    assert fired and fired[0][0] == "collective dispatch" and fired[0][1] >= 0.7
    with _StallWatchdog("fetch", None) as wd:     # disarmed: no thread
        assert wd._thread is None


def test_cli_pulse_shard_refusals(capsys):
    """Refusals exit 2 before any socket is bound or group joined."""
    from wrp_tpu_torch import cli

    port = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    port.bind(("127.0.0.1", 0))
    busy = port.getsockname()[1]      # bound: binding it would raise
    try:
        cases = [
            (["--pulse-shard", "--method", "pallas"], "needs the lock-step"),
            (["--pulse-shard", "--method", "parseval", "--coordinator",
              "127.0.0.1:1"], "supports --method mxu, fft, or pallas"),
            (["--device-decode", "--method", "pallas", "--coordinator",
              "127.0.0.1:1"], "needs --pulse-shard"),
        ]
        for extra, msg in cases:
            assert cli.main(["stream", "--device", "cpu", "--ingest-port",
                             str(busy), *extra]) == 2
            assert msg in capsys.readouterr().err
    finally:
        port.close()
