"""The routes above FFT_MAX_M = 4096 range cells on the CPU, and the refusal
of one channel.

Above 4096 the radix entries (#3/#4), the A-stage (#5) and the wire
entries (#7, #8) take the cluster body (csrc/cluster_chain.cuh) up to 8192
and the matrix forms above it (csrc/fused_chain_dense.cu's matrix kernel
for the radix entries; csrc/fused_chain_astage_matrix.cu, the matrix form
of csrc/radix_chain.cuh; the matrix kernel's wire source in
csrc/fused_chain_dense.cu), each chosen
from m alone.  Here, at m = 4160 (radix 8), 4128 (radix 4) and 4112 (radix
2), n = 16, against wrp_tpu (Pallas in interpret mode) and the fp64
oracle: the A-stage's matrix-form plain version on natural rows vs
wrp_tpu's on radix rows (the form the A-stage runs above 8192), the tile
the matrix A-stage picks, a `pallas-seq` step at world 1 and over a 2-rank
gloo group (int16, f32 and wire input), `MultiHostProcessor` with
`pallas-seq`, the fused wire decode of `SectorProcessor`, and #8's plain
version with offset and salt.  The CUDA kernels themselves are checked on
the card by chip_smoke.py.  Last, every processor refuses a config of one
channel at construction."""

import dataclasses
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_subprocess_env

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu.parallel import mesh as jmesh
from wrp_tpu.parallel import sharded as jsharded
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.parallel import (build_halo_processor,
                                    build_sharded_processor, make_mesh)
from wrp_tpu_torch.parallel.launch import run_ranks
from wrp_tpu_torch.parallel.multihost import MultiHostProcessor
from wrp_tpu_torch.pipeline import SectorProcessor, stage09_10_products

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N = 16
M = 4160              # radix 8, M = 520: the slice's geometry
SAME_TOL = 1e-5       # two forms of the same chain (fp32 reassociation)
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle
ASTAGE_TOL = 1e-5     # Y vs wrp_tpu's A-stage (bf16 hi/lo splits there)
RANK_TIMEOUT_S = 240


def _cfg(m=M):
    return tiny_config(m=m, n=N)


def _plan(m=M):
    return tfull.build_plan(PipelineConstants.build(_cfg(m)), "cpu")


def _planar(iq):
    return np.stack([iq.real, iq.imag], 1).astype(np.int16)


@pytest.fixture(scope="module")
def batch():
    """Two noise sectors at M: complex iq, planar int16, the wire words
    and rows [B, m, n bps] uint8, the oracle's products."""
    jcfg = jtiny(m=M, n=N)
    iqs = [oracle.synthetic_iq(jcfg, kind="noise", seed=s) for s in (40, 41)]
    iq = np.stack(iqs).astype(np.complex64)
    planar = np.stack([_planar(s) for s in iqs])
    wires = np.stack([np.frombuffer(codec.encode_iq(s, _cfg()), np.uint8)
                      for s in iqs])
    return types.SimpleNamespace(
        iq=iq, planar=planar, wires=wires,
        wire3=wires.reshape(len(iqs), M, -1),
        oracle=[oracle.process_sector(s, jcfg) for s in iqs],
        pallas=SectorProcessor(_cfg(), method="pallas", device="cpu")(planar))


@pytest.fixture(scope="module")
def jax_products(batch):
    """wrp_tpu's products on the batch: its pallas processor, and its
    pallas-seq step on a 1 x 1 mesh from planar and from wire input."""
    jcfg = jtiny(m=M, n=N)
    pallas = jpipe.SectorProcessor(jcfg, method="pallas")(batch.iq)
    jm = jmesh.make_mesh(data=1, seq=1, devices=jax.devices()[:1])
    step, shd = jsharded.build_sharded_processor(jcfg, jm, "pallas-seq")
    seq = step(jsharded.shard_batch(batch.iq, jm, shd))
    step_w, shd_w = jsharded.build_sharded_processor(jcfg, jm, "pallas-seq",
                                                     wire_input=True)
    seq_w = step_w(jax.device_put(batch.wire3, shd_w))
    return {k: tuple(np.asarray(t) for t in v) for k, v in
            (("pallas", pallas), ("seq", seq), ("seq_wire", seq_w))}


def _hold(got, want, tol, what):
    for name, g, w in zip(("zdb", "zdr"), got, want):
        g = g.numpy() if torch.is_tensor(g) else g
        e = oracle.relative_l2(np.asarray(w), g)
        assert e <= tol, (what, name, e)


def _hold_oracle(got, batch, what):
    for b, (zdb64, zdr64) in enumerate(batch.oracle):
        _hold((got[0][b], got[1][b]), (zdb64, zdr64), PRODUCT_TOL,
              (what, b))


@pytest.mark.parametrize("m,radix", [(4160, 8), (4128, 4), (4112, 2)])
def test_astage_matrix_plain_vs_jax(m, radix):
    """The matrix form's plain version of the A-stage (`_contract_reference`,
    the route above 8192), called directly at each radix: Y on natural rows
    within 1e-5 of wrp_tpu's A-stage on the same slab in radix row order,
    at w = n and n/2; no FFT tables.  The A-stage itself takes the cluster
    body at these m (its plain version, no launch counted)."""
    plan = _plan(m)
    assert plan.radix == radix and plan.fft_t is None
    assert tfull.chain_route(m) == "cluster"
    x = _planar(oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=m))
    a_np, fac = jfull.radix_plan_host(JConsts.build(jtiny(m=m, n=N)), radix)
    order = jfull.radix_row_order(m, radix)
    before = (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_MATRIX_LAUNCHES,
              tfull.ASTAGE_CLUSTER_LAUNCHES)
    for w in (N, N // 2):
        slab = torch.from_numpy(np.ascontiguousarray(x[..., :w]))
        got = torch.stack(tfull._contract_reference(slab, plan), dim=1)
        assert got.shape == (x.shape[0], 2, m // 2, w)
        assert torch.equal(tfull.fused_chain_astage(slab, plan), torch.stack(
            tfull.cluster_stage_reference(slab, plan), dim=1))
        want = np.asarray(jfull.fused_chain_astage(
            jnp.asarray(slab.numpy()[:, :, order, :]), jnp.asarray(a_np), fac,
            interpret=True))
        assert oracle.relative_l2(want, got.numpy()) <= ASTAGE_TOL, w
    assert before == (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_MATRIX_LAUNCHES,
                      tfull.ASTAGE_CLUSTER_LAUNCHES)


@pytest.mark.parametrize("m,tile,smem", [
    (4160, 8, 33_280),      # radix 8, M = 520
    (4128, 8, 66_048),      # radix 4, M = 1032
    (4112, 8, 131_584),     # radix 2, M = 2056
    (7280, 4, 116_480),     # radix 2, M = 3640: T = 8 would need 232,960
])
def test_astage_tile(m, tile, smem):
    """The matrix A-stage's tile: the tallest of 8, 4, 2 that divides M and
    whose operator slice 2 T M 4 bytes fits 232,448 bytes."""
    plan = types.SimpleNamespace(m=m, radix=tfull.radix_for(m))
    assert tfull.astage_tile(plan) == tile
    assert 2 * tile * (m // plan.radix) * 4 == smem <= tfull.MAX_SMEM_BYTES


def test_astage_tile_refuses_where_none_fits():
    """m = 29072 (radix 2, M = 14536): T = 2 would need 232,576 bytes."""
    plan = types.SimpleNamespace(m=29072, radix=tfull.radix_for(29072))
    assert plan.radix == 2
    with pytest.raises(ValueError, match="m=29072"):
        tfull.astage_tile(plan)


@pytest.mark.parametrize("form", ["i16", "f32", "wire"])
def test_pallas_seq_world_one(form, batch, jax_products):
    """A pallas-seq step at world 1, m = 4160 (the matrix A-stage, then the
    row epilogue on 2080 rows): within 1e-5 of the port's pallas processor
    and of wrp_tpu's pallas-seq step on a 1 x 1 mesh, within 2e-4 of the
    oracle."""
    cfg = _cfg()
    mesh = make_mesh(device="cpu")
    step = build_sharded_processor(cfg, mesh, "pallas-seq",
                                   wire_input=form == "wire", device="cpu")
    x = {"i16": batch.planar, "f32": batch.planar.astype(np.float32),
         "wire": batch.wire3}[form]
    got = step(x)
    assert got[0].shape == (2, M // 2)
    _hold(got, batch.pallas, SAME_TOL, "pallas")
    _hold(got, jax_products["seq_wire" if form == "wire" else "seq"],
          SAME_TOL, "wrp_tpu pallas-seq")
    _hold_oracle(got, batch, form)


def test_multihost_pallas_seq_step_local(batch, jax_products):
    """MultiHostProcessor with pallas-seq at m = 4160 (world 1): its
    step_local gives wrp_tpu's pallas products within 1e-5."""
    proc = MultiHostProcessor.build(_cfg(), per_host_batch=2,
                                    method="pallas-seq", device="cpu")
    got = proc.step_local(torch.from_numpy(batch.planar))
    _hold(got, jax_products["pallas"], SAME_TOL, "multihost")


# One rank of a 2-rank pallas-seq group at m = 4160 (a 1 x 2 mesh: each rank
# holds n/2 pulses): the step on int16, f32 and wire input, every rank's
# full products into out % rank; the rank ends through end_rank.
SEQ_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.parallel import build_sharded_processor, shard_batch
from wrp_tpu_torch.parallel.launch import end_rank
from wrp_tpu_torch.parallel.mesh import init_distributed, make_mesh

rank, port, timeout, m, n, inp, out = (
    int(sys.argv[1]), sys.argv[2], float(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]), sys.argv[6], sys.argv[7])
dev = init_distributed(f"127.0.0.1:{port}", 2, rank, "cpu", timeout_s=timeout)
mesh = make_mesh(data=1, seq=2, device=dev)
cfg = tiny_config(m=m, n=n)
d = np.load(inp)
res = {}
step = build_sharded_processor(cfg, mesh, "pallas-seq")
for form, x in (("i16", d["planar"]), ("f32", d["iq"])):
    zdb, zdr = step(shard_batch(x, mesh, step.layout))
    res[form + "_zdb"], res[form + "_zdr"] = zdb.numpy(), zdr.numpy()
step = build_sharded_processor(cfg, mesh, "pallas-seq", wire_input=True)
cols = d["wire3"].shape[2] // 2
k = mesh.seq_index
zdb, zdr = step(np.ascontiguousarray(d["wire3"][:, :, k * cols:(k + 1) * cols]))
res["wire_zdb"], res["wire_zdr"] = zdb.numpy(), zdr.numpy()
np.savez(out % rank, **res)
end_rank(0, timeout)
"""


@pytest.fixture(scope="module")
def two_ranks(batch, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq2")
    inp, out = str(tmp / "in.npz"), str(tmp / "rank%d.npz")
    np.savez(inp, planar=batch.planar, iq=batch.iq, wire3=batch.wire3)
    results = run_ranks(
        lambda rank, port: [sys.executable, "-c", SEQ_WORKER, str(rank),
                            str(port), str(RANK_TIMEOUT_S), str(M), str(N),
                            inp, out],
        2, RANK_TIMEOUT_S, env=cpu_subprocess_env(OMP_NUM_THREADS="1"),
        cwd=str(REPO))
    for r in results:
        assert r.rc == 0, (r.rank, r.rc, r.out[-1000:], r.err[-3000:])
    return [dict(np.load(out % k)) for k in range(2)]


@pytest.mark.parametrize("form", ["i16", "f32", "wire"])
def test_pallas_seq_two_ranks(form, two_ranks, batch, jax_products):
    """pallas-seq over a 2-rank gloo group at m = 4160 (the matrix A-stage
    on 8 pulses a rank, the all_to_all onto 1040 rows, the row epilogue,
    the all_gather): both ranks hold the whole batch's products, equal to
    each other, within 1e-5 of wrp_tpu's pallas processor and 2e-4 of the
    oracle."""
    got = [(r[form + "_zdb"], r[form + "_zdr"]) for r in two_ranks]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert got[0][0].shape == (2, M // 2)
    _hold(got[0], jax_products["pallas"], SAME_TOL, "wrp_tpu pallas")
    _hold_oracle(got[0], batch, form)


def test_fused_wire_above_4096(batch):
    """SectorProcessor(wire_input=True, wire_decode="fused") builds at
    m = 4160 and takes int32 words: within 1e-5 of wrp_tpu's radix-layout
    processor, which picks its fused wire kernel there, equal to the
    products of the cluster body's plain version on the planar samples and
    within 1e-5 of the port's planar products (the radix entry's matrix
    route).  The default decode there stays "xla"."""
    cfg = _cfg()
    proc = SectorProcessor(cfg, method="pallas", device="cpu",
                           wire_input=True, wire_decode="fused")
    assert proc.wire_decode == "fused" and proc.wire_dtype == np.int32
    assert SectorProcessor(cfg, method="pallas", device="cpu",
                           wire_input=True).wire_decode == "xla"
    got = proc(batch.wires.view("<i4"))
    jproc = jpipe.SectorProcessor(jtiny(m=M, n=N), method="pallas",
                                  layout="radix", wire_input=True)
    assert jproc.wire_decode == "fused"
    _hold(got, tuple(np.asarray(t) for t in jproc(batch.wires)), SAME_TOL,
          "wrp_tpu fused wire")
    pw = tfull.cluster_chain_power_reference(
        torch.from_numpy(batch.planar.reshape(-1, 2, M, N)).float(),
        _plan()).reshape(2, 3, -1)
    want = stage09_10_products(pw[:, 0], pw[:, 1], torch.from_numpy(
        PipelineConstants.build(cfg).gain))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _hold(got, batch.pallas, SAME_TOL, "planar")
    _hold_oracle(got, batch, "fused wire")


def test_wire_offset_salt_plain_above_4096(batch):
    """#8's plain version at m = 4160: offset 1, salt 7 on a 2-sector slab
    equals the decoded words through cluster_chain_power_reference (the
    route up to 8192) with the salt; no launch counted."""
    plan = _plan()
    w32 = torch.from_numpy(batch.wires.view("<i4").reshape(2, M, -1).copy())
    counts = (tfull.WIRE_LAUNCHES, tfull.WIRE_OFFSET_LAUNCHES,
              tfull.DENSE_MATRIX_LAUNCHES, tfull.WIRE_CLUSTER_LAUNCHES)
    got = tfull.fused_chain_power_wire(w32, plan, 3, offset=1, bs=1, salt=7)
    i_, q_ = tfull.decode_words_iq(w32[1:])
    planar = torch.stack([i_, q_], 1).reshape(1, 2, M, N, 3)
    planar = planar.permute(0, 4, 1, 2, 3).reshape(3, 2, M, N).contiguous()
    want = tfull.cluster_chain_power_reference(planar.float(), plan, 7)
    assert got.shape == (1, 3, M // 2)
    assert torch.equal(got.reshape(3, -1), want)
    assert counts == (tfull.WIRE_LAUNCHES, tfull.WIRE_OFFSET_LAUNCHES,
                      tfull.DENSE_MATRIX_LAUNCHES, tfull.WIRE_CLUSTER_LAUNCHES)


ONE_CHANNEL = dataclasses.replace(tiny_config(m=64, n=16), num_channels=1)


@pytest.mark.parametrize("build", [
    lambda: tiny_config(m=64, n=16, channels=1),
    lambda: ONE_CHANNEL.validate(),
    lambda: SectorProcessor(ONE_CHANNEL, method="pallas", device="cpu"),
    lambda: build_sharded_processor(ONE_CHANNEL, make_mesh(device="cpu"),
                                    "pallas-seq", device="cpu"),
    lambda: build_halo_processor(ONE_CHANNEL, make_mesh(device="cpu")),
    lambda: MultiHostProcessor.build(ONE_CHANNEL, per_host_batch=1,
                                     method="pallas", device="cpu"),
], ids=["tiny_config", "validate", "SectorProcessor",
        "build_sharded_processor", "build_halo_processor",
        "MultiHostProcessor"])
def test_one_channel_refused_at_construction(build):
    """zdr is the ratio of hh (channel 0) and vv (channel 1): a config of
    one channel is refused with ValueError before any kernel runs
    (wrp_tpu returns zdr = 0 dB there; the port does not copy that)."""
    with pytest.raises(ValueError, match="zdr needs two channels"):
        build()
