"""Rays longer than 1024 range cells on the CPU: the `pallas` method at
m = 1536 (512 x 3), 1832 (8 x 229, radix 1), 1840 (16 x 115), 2048, 4096
and 4160 (above the FFT-form kernels' 4096) against wrp_tpu's `pallas`
processor (Pallas in interpret mode) and the fp64 oracle, each through the
plain version of its route (the cluster body for the radix m and for the
dense entries' 1832 = 8 x 229); the wire input at m = 2048; the A-stage
and a world-size-1 `pallas-seq` step at m = 2048; the dense entries'
long-ray cut at m = 4094 = 2 x 2047, the one m it keeps, worked out by
hand; the routes above 4096 (the cluster body of the radix and wire
entries, the A-stage and pallas-seq; the radix entry's matrix route above
8192).  The CUDA kernels themselves (csrc/fft_chain.cuh's long-ray body,
csrc/cluster_chain.cuh) are checked on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.parallel import build_sharded_processor, make_mesh
from wrp_tpu_torch.pipeline import SectorProcessor, stage09_10_products

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

N = 16
POWER_TOL = 1e-5      # power vs the fp64 oracle
PRODUCT_TOL = 2e-4    # zdb, zdr vs wrp_tpu's and the fp64 oracle
ASTAGE_TOL = 1e-5     # Y vs wrp_tpu's A-stage (bf16 hi/lo splits there)
LONG_MS = (1536, 1832, 1840, 2048, 4096, 4160)


def _sector(m, seed):
    return oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=seed)


def _planar(iq):
    return np.stack([iq.real, iq.imag], 1).astype(np.int16)


def _consts(m):
    return PipelineConstants.build(tiny_config(m=m, n=N))


@pytest.mark.parametrize("m", LONG_MS)
def test_pallas_long_rays_match_jax_and_oracle(m):
    """The port's pallas processor on one noise sector: zdb/zdr within 2e-4
    of wrp_tpu's pallas processor and of the oracle; the fused entry's
    per-channel power within 1e-5 of the oracle."""
    iq = _sector(m, seed=m)
    zdb, zdr = SectorProcessor(tiny_config(m=m, n=N), method="pallas",
                               device="cpu")(_planar(iq))
    assert zdb.shape == zdr.shape == (m // 2,)
    jzdb, jzdr = jpipe.SectorProcessor(jtiny(m=m, n=N), method="pallas")(
        iq[None])
    zdb64, zdr64 = oracle.process_sector(iq, jtiny(m=m, n=N))
    for want in (np.asarray(jzdb[0]), zdb64):
        assert oracle.relative_l2(want, zdb.numpy()) < PRODUCT_TOL
    for want in (np.asarray(jzdr[0]), zdr64):
        assert oracle.relative_l2(want, zdr.numpy()) < PRODUCT_TOL

    plan = tfull.build_plan(_consts(m), "cpu")
    x = torch.from_numpy(_planar(iq))
    power = (tfull.fused_chain_power_radix if plan.radix > 1
             else tfull.fused_chain_power_dense)
    got = power(x, plan).numpy()
    pow64 = oracle.channel_power(iq, jtiny(m=m, n=N))
    for c in range(got.shape[0]):
        assert oracle.relative_l2(pow64[c], got[c]) < POWER_TOL, c
    # every m here on the cluster body, the radix-1 1832 = 8 x 229 too
    assert tfull.chain_route(m) == "cluster"
    assert torch.equal(torch.from_numpy(got),
                       tfull.cluster_chain_power_reference(x, plan))


@pytest.mark.parametrize("decode", [None, "fused"])
def test_wire_input_at_2048_equals_planar(decode):
    """Wire bytes at m = 2048 (the default decode picks the fused wire
    kernel there) give the planar input's products."""
    m = 2048
    cfg = tiny_config(m=m, n=N)
    iqs = [_sector(m, seed=s) for s in (1, 2)]
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    proc = SectorProcessor(cfg, method="pallas", device="cpu",
                           wire_input=True, wire_decode=decode)
    assert proc.wire_decode == "fused"
    wire = wires.view("<i4") if proc.wire_dtype == np.int32 else wires
    zdb, zdr = proc(wire)
    pzdb, pzdr = SectorProcessor(cfg, method="pallas", device="cpu")(
        np.stack([_planar(iq) for iq in iqs]))
    assert oracle.relative_l2(pzdb.numpy(), zdb.numpy()) < 1e-6
    assert oracle.relative_l2(pzdr.numpy(), zdr.numpy()) < 1e-6


def test_astage_at_2048_vs_jax_kernel():
    """The A-stage's plain version at m = 2048 (the cluster body: eight
    256-point sub-DFTs, 32 x 8) on natural rows vs wrp_tpu's A-stage on
    the same slab in radix row order, Y rel-L2 <= 1e-5, at the full width
    and half of it."""
    m = 2048
    x = np.stack([_planar(_sector(m, seed=s)) for s in (3, 4)]).reshape(
        -1, 2, m, N)
    plan = tfull.build_plan(_consts(m), "cpu")
    assert plan.fft_t is None
    assert (plan.cluster.ms, plan.cluster.P1, plan.cluster.P2) == (256, 32, 8)
    consts = JConsts.build(jtiny(m=m, n=N))
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(m, radix)
    for w in (N, N // 2):
        slab = np.ascontiguousarray(x[..., :w])
        got = tfull.fused_chain_astage(torch.from_numpy(slab), plan).numpy()
        assert got.shape == (x.shape[0], 2, m // 2, w)
        want = np.asarray(jfull.fused_chain_astage(
            jnp.asarray(slab[:, :, order, :]), jnp.asarray(a_np), fac,
            interpret=True))
        assert oracle.relative_l2(want, got) <= ASTAGE_TOL, w


def test_pallas_seq_world_one_at_2048():
    """A pallas-seq step at world size 1, m = 2048 (the A-stage, then the
    row epilogue on all m/2 rows): the pallas processor's products within
    1e-5, the oracle's within 2e-4."""
    m = 2048
    cfg = tiny_config(m=m, n=N)
    iqs = [_sector(m, seed=s) for s in (5, 6)]
    planar = np.stack([_planar(iq) for iq in iqs])
    step = build_sharded_processor(cfg, make_mesh(device="cpu"),
                                   method="pallas-seq", device="cpu")
    zdb, zdr = step(planar)
    pzdb, pzdr = SectorProcessor(cfg, method="pallas", device="cpu")(planar)
    assert oracle.relative_l2(pzdb.numpy(), zdb.numpy()) < 1e-5
    assert oracle.relative_l2(pzdr.numpy(), zdr.numpy()) < 1e-5
    for b, iq in enumerate(iqs):
        zdb64, zdr64 = oracle.process_sector(iq, jtiny(m=m, n=N))
        assert oracle.relative_l2(zdb64, zdb[b].numpy()) < PRODUCT_TOL
        assert oracle.relative_l2(zdr64, zdr[b].numpy()) < PRODUCT_TOL


@pytest.mark.parametrize("m,cut,leaf,smem", [
    # radix 1, m = 2 x 2047 (23 x 89): P = 2 in one register pass, the
    # leaf's one pass of 2047 points (no factor 3, 5, 7); a round of 1
    # column (2 x 2047 = 4094 complex values is already past the 4096 of a
    # half round): two leaf buffers of 2 x 4096 words (4094 rounded to 16
    # bytes), 8188 staged (f32), 5 of round constants, 13 x 2047 + 8 of
    # partials (every other radix-1 m above 1024 that the cluster body
    # splits takes it: tests/test_torch_cluster_leaf.py)
    (4094, (2, 2047, 2, 1, 1, 8), [2047], 4 * (2 * (4096 + 4096) + 8188
                                               + 5 + 13 * 2047 + 8)),
])
def test_fft_geometry_long_rays(m, cut, leaf, smem):
    """The dense entries' long-ray cut at n = 512: (P, L, P1, P2, cols,
    blocks), the leaf's radices and the fused block's shared memory with
    f32 staged (the larger staging), all within one block's 227 KB; a
    radix m above 1024, and a radix-1 m the cluster body splits, has no
    FFT-form cut."""
    g = tfull.fft_geometry(m, 512)
    assert (g.P, g.L, g.P1, g.P2, g.cols, g.blocks) == cut
    assert g.P * g.L == m and g.P1 * g.P2 == g.P
    radices, rem = [], g.L
    while rem > 1:
        radices.append(tfull.leaf_radix(rem))
        rem //= radices[-1]
    assert radices == leaf
    assert tfull.fft_smem_bytes(m, g.cols, fused=True, elem=4) == smem
    assert smem <= tfull.MAX_SMEM_BYTES
    for other in (1536, 2048, 4096, 4160, 1832, 2002):
        with pytest.raises(ValueError, match="FFT_MAX_M = 4096"):
            tfull.fft_geometry(other, 512)


def test_above_4096_routes_and_refusals():
    """m = 4160 (radix 8, above FFT_MAX_M): no FFT tables and no A_half on
    the host (the matrix kernel's operator is refused, naming the m it
    serves); the radix entry takes the cluster body's plain version
    (salted too, on a slab), as "fused", the wire entry, the A-stage and
    pallas-seq do up to m = 16384: the wire entry and the A-stage equal
    their plain versions, "fused" and pallas-seq the products of those
    plain versions, within 1e-5 of the planar products; the default wire
    decode picks "xla" and equals the planar products
    (tests/test_torch_cluster.py holds the cluster body against wrp_tpu).
    Above 8192, where the cluster body refuses m (m = 8336 = 16 x 521,
    radix 2: the leaf prime 521 needs a Bluestein length of 2048), the
    radix entry's matrix route: the matrix kernel's operator
    (A_half as [m, m/2, 2], C order, built once) and the plain version
    with offset and salt (tests/test_torch_cluster_routes.py holds the
    other matrix routes there)."""
    m = 4160
    cfg = tiny_config(m=m, n=N)
    plan = tfull.build_plan(_consts(m), "cpu")
    assert plan.radix == 8 and plan.fft_t is None and plan.host_a_half is None
    assert tfull.chain_route(m) == "cluster"
    with pytest.raises(ValueError, match="an m the cluster body refuses"):
        plan.dense_operator()
    iq = _sector(m, seed=7)
    x = torch.from_numpy(np.stack([_planar(iq)] * 2).reshape(-1, 2, m, N))
    before = (tfull.LAUNCHES, tfull.RADIX_OFFSET_LAUNCHES,
              tfull.RADIX_CLUSTER_LAUNCHES, tfull.DENSE_MATRIX_LAUNCHES)
    got = tfull.fused_chain_power_radix(x, plan, offset=3, bc=3, salt=7)
    assert torch.equal(got, tfull.cluster_chain_power_reference(x[3:], plan,
                                                                7))
    assert before == (tfull.LAUNCHES, tfull.RADIX_OFFSET_LAUNCHES,
                      tfull.RADIX_CLUSTER_LAUNCHES,
                      tfull.DENSE_MATRIX_LAUNCHES)

    wire = np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)[None].copy()
    proc = SectorProcessor(cfg, method="pallas", device="cpu", wire_input=True)
    assert proc.wire_decode == "xla"
    zdb, zdr = proc(wire)
    pzdb, pzdr = SectorProcessor(cfg, method="pallas", device="cpu")(
        _planar(iq)[None])
    assert torch.equal(zdb, pzdb) and torch.equal(zdr, pzdr)
    gain = torch.from_numpy(_consts(m).gain)
    fused = SectorProcessor(cfg, method="pallas", device="cpu",
                            wire_input=True, wire_decode="fused")
    fzdb, fzdr = fused(wire.view("<i4"))
    pw = tfull.cluster_chain_power_reference(x[:3].float(), plan)
    want = stage09_10_products(pw[0][None], pw[1][None], gain)
    assert torch.equal(fzdb, want[0]) and torch.equal(fzdr, want[1])
    w32 = torch.from_numpy(wire.view("<i4").reshape(1, m, 3 * N))
    assert torch.equal(tfull.fused_chain_power_wire(w32, plan, 3)[0], pw)
    y = tfull.fused_chain_astage(x, plan)
    assert torch.equal(y, torch.stack(tfull.cluster_stage_reference(x, plan), 1))
    step = build_sharded_processor(cfg, make_mesh(device="cpu"),
                                   method="pallas-seq", device="cpu")
    szdb, szdr = step(_planar(iq)[None])
    pw = tfull.parseval_rows_power_reference(y[:3], plan)
    want_seq = stage09_10_products(pw[0][None], pw[1][None], gain)
    assert torch.equal(szdb, want_seq[0]) and torch.equal(szdr, want_seq[1])
    for got in ((fzdb, fzdr), (szdb, szdr)):
        for g, w in zip(got, (pzdb, pzdr)):
            assert oracle.relative_l2(w.numpy(), g.numpy()) < 1e-5

    m = 8336
    consts = _consts(m)
    plan = tfull.build_plan(consts, "cpu")
    assert (tfull.chain_route(m) == "matrix" and plan.cluster_t is None
            and plan.radix == 2 and plan.host_a_half is not None)
    # the matrix kernel's operator, in the C order its pointer is read in
    op = plan.dense_operator()
    assert op.shape == (m, m // 2, 2) and op.is_contiguous()
    assert torch.equal(op[..., 0],
                       torch.from_numpy(consts.op_a_half.real.T.copy()))
    assert torch.equal(op[..., 1],
                       torch.from_numpy(consts.op_a_half.imag.T.copy()))
    assert plan.dense_operator() is op
    x = torch.from_numpy(np.stack([_planar(_sector(m, seed=8))] * 2)
                         .reshape(-1, 2, m, N))
    got = tfull.fused_chain_power_radix(x, plan, offset=3, bc=3, salt=7)
    assert torch.equal(got, tfull.fused_chain_power_reference(x[3:], plan, 7))
