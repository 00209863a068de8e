"""The port's on-device decode path on the CPU: the wire and dense kernels'
plain versions against wrp_tpu's kernels (Pallas interpret mode) and the
fp64 oracle, SectorProcessor(wire_input=True), the executor's
device_decode and `cli stream --device-decode`.  The CUDA kernels
themselves are checked on the card by chip_smoke.py."""

import dataclasses
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fullchain import _adversarial
from test_torch_stream import _free_port

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops import device_codec as jdc
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch import cli
from wrp_tpu_torch import config as tconfig
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec, frames
from wrp_tpu_torch.ops import device_codec as tdc
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.pipeline import SectorProcessor
from wrp_tpu_torch.runtime import StreamingExecutor, VolumeScan

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)


def _sector(cfg, kind, seed):
    """One integer-valued sector [C, m, n] complex: noise or clip-bin."""
    if kind == "noise":
        rng = np.random.default_rng(seed)
        shape = cfg.sector_shape
        return (rng.integers(-8192, 8192, shape)
                + 1j * rng.integers(-8192, 8192, shape))
    return _adversarial(cfg, seed=seed)


def _wires(cfg, iqs):
    return np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                     for iq in iqs])


def _jcfg(cfg):
    return jtiny(m=cfg.m, n=cfg.n, channels=cfg.num_channels)


@pytest.mark.parametrize("channels", [3, 2])
@pytest.mark.parametrize("kind", ["noise", "clip-bin"])
def test_wire_reference_vs_jax_kernel_and_oracle(channels, kind):
    """Natural-order wire words through the port's plain version vs radix-
    ordered words (wire_words_i32(radix=R), wrp_tpu's production form)
    through wrp_tpu's wire kernel: < 2e-5 (JAX drops the bf16 lo*lo term);
    the port vs the fp64 oracle < 1e-5."""
    cfg = tiny_config(m=128, n=64, channels=channels)
    jcfg = _jcfg(cfg)
    iqs = [_sector(cfg, kind, seed=s) for s in (4, 5)]
    wires = _wires(cfg, iqs)
    plan = tfull.build_plan(PipelineConstants.build(cfg), "cpu")
    w32 = tdc.wire_words_i32(torch.from_numpy(wires), cfg)
    got = tfull.fused_chain_power_wire(w32, plan, channels).numpy()
    assert got.shape == (2, channels, 64)

    consts = JConsts.build(jcfg)
    radix = jfull.radix_for(cfg.m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    wd_il, ph_il = jfull.wire_lane_consts(consts, channels)
    want = np.asarray(jfull.fused_chain_power_wire(
        jdc.wire_words_i32(jnp.asarray(wires), jcfg, radix=radix),
        jnp.asarray(a_np), fac, jnp.asarray(wd_il), jnp.asarray(ph_il),
        channels, interpret=True))
    for b, iq in enumerate(iqs):
        pow64 = oracle.channel_power(iq, jcfg)
        for c in range(channels):
            assert oracle.relative_l2(want[b, c], got[b, c]) < 2e-5, (b, c)
            assert oracle.relative_l2(pow64[c], got[b, c]) < 1e-5, (b, c)


@pytest.mark.parametrize("kind", ["noise", "clip-bin"])
def test_dense_reference_vs_jax_kernel_and_oracle(kind):
    """m = 40 does not split into radix branches: the dense plain version
    vs wrp_tpu's dense kernel < 2e-5 and vs the fp64 oracle < 1e-5."""
    cfg = tiny_config(m=40, n=32)
    assert tfull.radix_for(40) == 1
    iq = _sector(cfg, kind, seed=6)
    planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    plan = tfull.build_plan(PipelineConstants.build(cfg), "cpu")
    got = tfull.fused_chain_power_dense(torch.from_numpy(planar), plan).numpy()
    consts = JConsts.build(_jcfg(cfg))
    want = np.asarray(jfull.fused_chain_power(
        jnp.asarray(planar),
        jnp.asarray(jfull.split_operator_host(consts.op_a_half)),
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True))
    pow64 = oracle.channel_power(iq, _jcfg(cfg))
    for c in range(cfg.num_channels):
        assert oracle.relative_l2(want[c], got[c]) < 2e-5, c
        assert oracle.relative_l2(pow64[c], got[c]) < 1e-5, c


@pytest.mark.parametrize("m,n,mode", [(128, 64, "fused"), (40, 32, "xla")])
def test_wire_processor_matches_jax_and_oracle(m, n, mode):
    cfg = tiny_config(m=m, n=n)
    iqs = [_sector(cfg, "noise", seed=s) for s in (7, 8, 9)]
    wires = _wires(cfg, iqs)
    proc = SectorProcessor(cfg, method="pallas", wire_input=True,
                           device="cpu")
    assert proc.wire_input and proc.wire_decode == mode
    assert proc.wire_dtype == (np.int32 if mode == "fused" else np.uint8)
    jproc = jpipe.SectorProcessor(_jcfg(cfg), method="pallas",
                                  layout="radix", wire_input=True)
    assert jproc.wire_decode == mode
    zdb, zdr = (t.numpy() for t in proc(wires))
    jzdb, jzdr = (np.asarray(t) for t in jproc(wires))
    assert zdb.shape == (3, m // 2)
    for k, iq in enumerate(iqs):
        zdb64, zdr64 = oracle.process_sector(iq, _jcfg(cfg))
        assert oracle.relative_l2(jzdb[k], zdb[k]) < 2e-4
        assert oracle.relative_l2(jzdr[k], zdr[k]) < 2e-4
        assert oracle.relative_l2(zdb64, zdb[k]) < 2e-4
        assert oracle.relative_l2(zdr64, zdr[k]) < 2e-4
        assert zdb[k][0] == -np.inf
    # one sector, unbatched, and (fused) the int32 word view of the bytes
    one_db, _ = proc(wires[0])
    assert torch.equal(one_db, torch.from_numpy(zdb[0]))
    if mode == "fused":
        w_db, w_dr = proc(wires.view("<i4"))
        assert np.array_equal(w_db.numpy(), zdb)
        assert np.array_equal(w_dr.numpy(), zdr)
    else:
        with pytest.raises(ValueError, match="wire_input processor expects"):
            proc(wires.view("<i4"))


def test_wire_processor_options_and_input_contract():
    cfg = tiny_config(m=128, n=64)
    with pytest.raises(ValueError, match="requires method='pallas'"):
        SectorProcessor(cfg, method="mxu", wire_input=True, device="cpu")
    with pytest.raises(ValueError, match="wire_decode applies"):
        SectorProcessor(cfg, method="pallas", wire_decode="fused",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown wire_decode"):
        SectorProcessor(cfg, method="pallas", wire_input=True,
                        wire_decode="bogus", device="cpu")
    with pytest.raises(ValueError, match="radix branches"):
        SectorProcessor(tiny_config(m=40, n=32), method="pallas",
                        wire_input=True, wire_decode="fused", device="cpu")
    proc = SectorProcessor(cfg, method="pallas", wire_input=True,
                           device="cpu")
    with pytest.raises(ValueError, match="wire_input processor expects"):
        proc(np.zeros((2, 7), np.int32))
    with pytest.raises(ValueError, match="wire_input processor expects"):
        proc(np.zeros((2, cfg.sector_nbytes_wire // 2), np.int16))
    # wire_decode="xla" on a radix geometry: decode pass + radix kernel,
    # the same products as the fused decode
    wires = _wires(cfg, [_sector(cfg, "noise", seed=1)])
    xla = SectorProcessor(cfg, method="pallas", wire_input=True,
                          wire_decode="xla", device="cpu")
    for a, b in zip(xla(wires), proc(wires)):
        assert oracle.relative_l2(a.numpy(), b.numpy()) < 1e-6


def test_wire_and_dense_wrappers_on_cpu():
    """CPU tensors take the plain versions and launch nothing; other
    devices and mismatched plans raise; the fused processor takes the
    dense form for a radix-1 geometry instead of raising."""
    cfg = tiny_config(m=64, n=32)
    plan = tfull.build_plan(PipelineConstants.build(cfg), "cpu")
    w32 = tdc.wire_words_i32(_wires(cfg, [_sector(cfg, "noise", 2)]), cfg)
    before = (tfull.LAUNCHES, tfull.WIRE_LAUNCHES, tfull.DENSE_LAUNCHES)
    assert torch.equal(tfull.fused_chain_power_wire(w32, plan, 3),
                       tfull.fused_chain_power_wire_reference(w32, plan, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        tfull.fused_chain_power_wire(w32.to("meta"), plan, 3)
    with pytest.raises(TypeError, match="int32"):
        tfull.fused_chain_power_wire(w32.to(torch.int64), plan, 3)
    with pytest.raises(ValueError, match="radix-1 plan"):
        tfull.fused_chain_power_dense(torch.zeros(1, 2, 64, 32), plan)

    dcfg = tiny_config(m=40, n=32)
    dplan = tfull.build_plan(PipelineConstants.build(dcfg), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -8192, 8192, (2, 3, 2, 40, 32)).astype(np.int16))
    assert torch.equal(tfull.fused_chain_power_dense(x[0], dplan),
                       tfull.fused_chain_power_reference(x[0], dplan))
    with pytest.raises(ValueError, match="unsupported device"):
        tfull.fused_chain_power_dense(x[0].to("meta"), dplan)
    fn = tfull.build_fused_processor(PipelineConstants.build(dcfg), "cpu")
    assert torch.equal(fn(x)[1], tfull.fused_chain_power_reference(x[1], dplan))
    assert (tfull.LAUNCHES, tfull.WIRE_LAUNCHES,
            tfull.DENSE_LAUNCHES) == before
    assert tfull.dense_tile(dplan) == 10
    assert tfull.dense_tile(dataclasses.replace(dplan, m=1000, n=512)) == 10
    assert tfull.dense_tile(dataclasses.replace(dplan, m=8, n=512)) == 4
    prod = dataclasses.replace(plan, radix=8, m=1024, n=512)
    assert tfull.kernel_tile(prod) == 8
    assert tfull.kernel_tile(dataclasses.replace(prod, m=32)) == 4


class _MemoryFeed:
    """Hands out wire sectors with headers as fast as the executor asks."""

    def __init__(self, wires, num_sectors):
        self.wires, self.num_sectors, self.k = wires, num_sectors, 0

    def recv_sector(self):
        if self.k >= len(self.wires):
            return None, None
        k, self.k = self.k, self.k + 1
        return (bytearray(self.wires[k].tobytes()),
                frames.IngestHeader(k % self.num_sectors, k // self.num_sectors,
                                    0))


@pytest.mark.parametrize("m", [32, 40])
def test_executor_device_decode_equals_host_decode(m):
    """The same memory feed through device_decode=True and False gives
    the same products and volume coverage (m = 32: the fused wire decode;
    m = 40: the decode pass and the dense form)."""
    cfg = tiny_config(m=m, n=16)
    wires = _wires(cfg, [_sector(cfg, "noise", seed=s) for s in range(11)])
    runs = {}
    for dd in (True, False):
        vol = VolumeScan(cfg)
        ex = StreamingExecutor(cfg, transport=_MemoryFeed(wires, 8), batch=4,
                               method="pallas", volume=vol, idle_limit=1,
                               device="cpu", device_decode=dd)
        if dd:
            assert ex._wire_dtype == ex.processor.wire_dtype
            assert ex._host[0].shape[1] * ex._wire_dtype.itemsize == \
                cfg.sector_nbytes_wire
        stats = ex.run()
        assert stats["processed_sectors"] == 11
        runs[dd] = vol
    a, b = runs[True], runs[False]
    np.testing.assert_array_equal(a.coverage, b.coverage)
    assert a.coverage.sum() == 11
    for p in (0, 1):
        got, want = a.data[p][:, a.coverage], b.data[p][:, b.coverage]
        assert oracle.relative_l2(want, got) <= 1e-6


def test_executor_device_decode_refusals():
    cfg = tiny_config(m=32, n=16)
    with pytest.raises(ValueError, match="requires method='pallas'"):
        StreamingExecutor(cfg, method="mxu", device="cpu", device_decode=True)

    def step(planar):
        return planar, planar

    with pytest.raises(ValueError, match="wire_input=True"):
        StreamingExecutor(cfg, processor=step, device_decode=True)
    proc = SectorProcessor(cfg, method="pallas", wire_input=True, device="cpu")
    ex = StreamingExecutor(cfg, processor=proc, batch=2, device_decode=True)
    assert ex._wire_dtype == np.int32
    assert tuple(ex._host[0].shape) == (2, cfg.sector_nbytes_wire // 4)


def test_cli_stream_device_decode(tmp_path, monkeypatch, capsys):
    """`cli stream --device-decode` fed by `cli produce` over loopback
    (ephemeral ports); products vs the fp64 oracle < 2e-4."""
    cfg = tiny_config(m=64, n=32)
    monkeypatch.setattr(tconfig, "DEFAULT_CONFIG", cfg)
    port = _free_port()
    ready = tmp_path / "ready"
    ckpt = tmp_path / "vol.npz"
    rc = {}
    args = ["stream", "--device", "cpu", "--method", "pallas",
            "--device-decode", "--ingest-port", str(port), "--batch", "2",
            "--timeout", "1", "--idle-limit", "4", "--max-sectors", "3",
            "--ready-file", str(ready), "--checkpoint", str(ckpt),
            "--zdb-port", str(_free_port()), "--zdr-port", str(_free_port())]
    runner = threading.Thread(target=lambda: rc.update(s=cli.main(args)),
                              daemon=True)
    runner.start()
    deadline = time.monotonic() + 60
    while not ready.exists():
        assert time.monotonic() < deadline, "stream never became ready"
        time.sleep(0.05)
    assert cli.main(["produce", "--sectors", "3", "--ingest-port", str(port),
                     "--per-sector-seed", "--seed", "5", "--headers"]) == 0
    runner.join(timeout=60)
    assert not runner.is_alive() and rc["s"] == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["processed_sectors"] == 3
    vol = VolumeScan.load(ckpt, cfg)
    for k in range(3):
        zdb64, zdr64 = oracle.process_sector(
            oracle.produce_sector_iq(_jcfg(cfg), 5, k), _jcfg(cfg))
        assert oracle.relative_l2(zdb64, vol.data[0, :, k, 0]) < 2e-4
        assert oracle.relative_l2(zdr64, vol.data[1, :, k, 0]) < 2e-4
        assert vol.data[0, 0, k, 0] == -np.inf


def test_cli_device_decode_needs_pallas(capsys):
    assert cli.main(["stream", "--device", "cpu", "--method", "mxu",
                     "--device-decode", "--ingest-port", str(_free_port())]) == 2
    assert "--device-decode requires --method pallas" in capsys.readouterr().err
