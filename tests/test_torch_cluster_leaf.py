"""The cluster body's odd leaf and the dense entries' cluster route, on the
CPU.

csrc/cluster_chain.cuh runs the odd L-point DFT of each block's rows in
place, one decimation-in-frequency pass a prime factor (a register DFT for
every odd prime up to 31, Bluestein's form above), and splits a radix-1
m = S x odd (S = 2, 4, 8) across a cluster of S blocks, the dense entries'
route up to 8192 cells.  Here: the leaf's plain steps
(`cluster_leaf_reference` on the plan's float32 tables) against a float64
DFT for every register radix, the Bluestein primes 37, 89, 229, 257 and
composite leaves; the cuts at 1536, 1840, 4112 and 4160, worked out by
hand; `chain_route` by m; the `pallas` processor at m = 1832 (8 x 229),
1836 (4 x 459), 1840 and 4112 (a 257-point Bluestein leaf) against
wrp_tpu's (Pallas in interpret mode) and the fp64 oracle; the dense
entries at 2002 (2 x 1001) against wrp_tpu's dense kernel; the A-stage at
1840 against wrp_tpu's.  The CUDA kernels themselves are checked on the
card by chip_smoke.py."""

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
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.pipeline import SectorProcessor

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

N = 16
LEAF_TOL = 1e-6       # the leaf on float32 tables, in float64, vs the DFT (rel-L2)
POWER_TOL = 1e-5      # power vs the fp64 oracle and wrp_tpu's kernel
PRODUCT_TOL = 2e-4    # zdb, zdr vs wrp_tpu's and the fp64 oracle
ASTAGE_TOL = 1e-5     # Y vs wrp_tpu's A-stage (bf16 hi/lo splits there)


def _planar(iq):
    return np.stack([iq.real, iq.imag], 1).astype(np.int16)


def _plan(m, n=N):
    return tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")


@pytest.mark.parametrize("L", [3, 5, 7, 11, 13, 17, 19, 23, 29, 31,
                               37, 89, 229, 257,
                               105, 459, 1001, 129, 115])
def test_leaf_vs_float64_dft(L):
    """The leaf's passes (`leaf_plan`: its primes ascending, a Bluestein
    prime last) on its float32 tables, computed in float64 on [2, L, 3]
    complex noise, then read through perm: within LEAF_TOL of the L x L
    DFT in float64.  A prime above 31 takes Bluestein's form with N the
    power of two >= 2p - 1."""
    lp = tfull.leaf_plan(L)
    assert int(np.prod(lp.radices)) == L
    assert list(lp.radices) == sorted(lp.radices)
    assert all(r <= tfull.LEAF_MAX_RADIX for r in lp.radices[:-1])
    big = lp.radices[-1] > tfull.LEAF_MAX_RADIX
    assert lp.bluestein == (tfull.bluestein_n(lp.radices[-1]) if big else 0)
    assert not big or lp.bluestein // 2 < 2 * lp.radices[-1] - 1 <= lp.bluestein
    tables = tfull.parse_leaf_tables(torch.from_numpy(tfull.leaf_tables(L)),
                                     L, lp.bluestein)
    rng = np.random.default_rng(L)
    z = rng.standard_normal((2, L, 3)) + 1j * rng.standard_normal((2, L, 3))
    got = tfull.cluster_leaf_reference(torch.from_numpy(z), tables).numpy()
    dft = np.exp(-2j * np.pi * np.outer(np.arange(L), np.arange(L)) / L)
    want = np.einsum("kr,brc->bkc", dft, z)
    assert np.linalg.norm(got - want) <= LEAF_TOL * np.linalg.norm(want)


@pytest.mark.parametrize("m,cut,cols,smem", [
    # (S, ms, P, L, P1, P2, span, bluestein, the fused chains' batch);
    # words at n = 512 for the fused chains, the int16 and the f32 A-stage:
    # A in place (no second leaf buffer), as at L = 1, so 64 columns at
    # 1536 and 1840 as at 2048
    (1536, (8, 192, 64, 3, 32, 2, 24, 0, 0), (64, 64, 64),
     (4 * (2 * 12288 + 2 * 6240 + 320), 4 * (2 * 12288 + 12288),
      4 * (2 * 12288 + 24576))),
    (1840, (8, 230, 2, 115, 2, 1, 29, 0, 0), (64, 64, 32),
     (4 * (2 * 14720 + 2 * 7540 + 320), 4 * (2 * 14720 + 14720),
      4 * (2 * 7360 + 14720))),
    # 32 columns, as at 4096; the 257-point Bluestein leaf's convolutions
    # (N = 1024) in the owned rows' region, 8 at a time
    (4112, (8, 514, 2, 257, 2, 1, 65, 1024, 8), (32, 32, 16),
     (4 * (2 * 16448 + 2 * 8580 + 160), 4 * (3 * 16448 + 2 * 4 * 1024),
      4 * (2 * 8224 + 16448 + 2 * 8 * 1024))),
    (4160, (8, 520, 8, 65, 8, 1, 65, 0, 0), (32, 32, 16),
     (4 * (2 * 16640 + 2 * 8580 + 160), 4 * (3 * 16640),
      4 * (2 * 8320 + 16640))),
])
def test_cluster_cuts_at_odd_leaves(m, cut, cols, smem):
    """The cut at n = 512 of the m whose m/8 has an odd factor: L > 1 takes
    the columns a round that L = 1 takes at the same block budget (the
    block fits at those columns and not at twice them)."""
    g = tfull.cluster_geometry(m, 512)
    assert (g.S, g.ms, g.P, g.L, g.P1, g.P2, g.span, g.bluestein,
            g.batch) == cut
    for (fused, elem), want_cols, want_smem in zip(
            ((True, 0), (False, 2), (False, 4)), cols, smem):
        c = tfull.cluster_geometry(m, 512, fused, elem)
        assert c.cols == want_cols, (fused, elem)
        assert tfull.cluster_smem_bytes(m, c.cols, fused, elem) == want_smem
        assert want_smem <= tfull.MAX_SMEM_BYTES
        assert (c.cols == tfull.CLUSTER_MAX_COLS or tfull.cluster_smem_bytes(
            m, 2 * c.cols, fused, elem) > tfull.MAX_SMEM_BYTES)


def test_chain_route_by_m():
    """The route of every chain from m alone: radix-1 m = S x odd on the
    cluster body up to 1024 S (1832 = 8 x 229, 1836 = 4 x 459, 2002 = 2 x
    1001, 8184 = 8 x 1023), m = 2 x odd above 2048 on the long-ray body
    (4094), the matrix kernel where the cluster body refuses and says why
    (4100 = 4 x 1025: a block's 1025-point sub-DFT; 1042 = 2 x 521: a
    Bluestein length of 2048; 16416: above CLUSTER_MAX_M); the radix m as
    before, 8320 on a cluster of 16."""
    for m, route, split in ((1832, "cluster", 8), (1836, "cluster", 4),
                            (2002, "cluster", 2), (8184, "cluster", 8),
                            (1840, "cluster", 8), (4112, "cluster", 8),
                            (4094, "long", 2), (2050, "long", 2),
                            (4100, "matrix", 4), (1042, "matrix", 2),
                            (8320, "cluster", 16), (1001, "matrix", 1),
                            (1000, "register", 8)):
        assert tfull.chain_route(m) == route, m
        assert tfull.cluster_split(m) == split, m
        assert (tfull.cluster_refusal(m) is None) == (route == "cluster"), m
    assert "CLUSTER_MAX_MS" in tfull.cluster_refusal(4100)
    assert "2048 > BLUESTEIN_MAX_N" in tfull.cluster_refusal(1042)
    assert "CLUSTER_MAX_M = 16384" in tfull.cluster_refusal(16416)
    assert tfull.cluster_geometry(1832, 512).S == 8
    assert tfull.cluster_geometry(2002, 512).span == 501


@pytest.mark.parametrize("m", [1832, 1836, 1840, 4112])
def test_pallas_vs_jax_and_oracle(m):
    """The port's pallas processor on one noise sector through the cluster
    body's plain version (the dense entries' at 1832 and 1836, the radix
    entry's at 1840 and 4112): zdb/zdr within PRODUCT_TOL of wrp_tpu's
    pallas processor and of the oracle, each channel's power within
    POWER_TOL of the oracle and equal to the route's plain version; no
    launch counted."""
    iq = oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=m)
    before = (tfull.DENSE_LAUNCHES, tfull.DENSE_CLUSTER_LAUNCHES,
              tfull.LAUNCHES, tfull.RADIX_CLUSTER_LAUNCHES)
    zdb, zdr = SectorProcessor(tiny_config(m=m, n=N), method="pallas",
                               device="cpu")(_planar(iq))
    jzdb, jzdr = jpipe.SectorProcessor(jtiny(m=m, n=N), method="pallas")(
        iq[None])
    zdb64, zdr64 = oracle.process_sector(iq, jtiny(m=m, n=N))
    for want, got in ((np.asarray(jzdb[0]), zdb), (zdb64, zdb),
                      (np.asarray(jzdr[0]), zdr), (zdr64, zdr)):
        assert oracle.relative_l2(want, got.numpy()) < PRODUCT_TOL
    plan = _plan(m)
    x = torch.from_numpy(_planar(iq))
    power = (tfull.fused_chain_power_radix if plan.radix > 1
             else tfull.fused_chain_power_dense)
    got = power(x, plan)
    assert tfull.chain_route(m) == "cluster"
    assert torch.equal(got, tfull.cluster_chain_power_reference(x, plan))
    pow64 = oracle.channel_power(iq, jtiny(m=m, n=N))
    for c in range(3):
        assert oracle.relative_l2(pow64[c], got[c].numpy()) < POWER_TOL, c
    assert before == (tfull.DENSE_LAUNCHES, tfull.DENSE_CLUSTER_LAUNCHES,
                      tfull.LAUNCHES, tfull.RADIX_CLUSTER_LAUNCHES)


def test_dense_entries_at_2002_vs_jax():
    """m = 2002 = 2 x 7 x 11 x 13 (a cluster of 2 blocks, three register
    passes): both dense entries' CPU results (the second at offset 3 of a
    staged 6) vs wrp_tpu's dense kernel (interpret mode) within
    POWER_TOL and the oracle's power within POWER_TOL."""
    m = 2002
    plan = _plan(m)
    assert plan.radix == 1 and plan.cluster.S == 2
    iqs = [oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=s)
           for s in (20, 21)]
    x = np.concatenate([_planar(iq) for iq in iqs]).astype(np.float32)
    consts = JConsts.build(jtiny(m=m, n=N))
    want = np.asarray(jfull.fused_chain_power(
        jnp.asarray(x), jnp.asarray(jfull.split_operator_host(consts.op_a_half)),
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True))
    got = tfull.fused_chain_power_dense(torch.from_numpy(x), plan).numpy()
    at = tfull.fused_chain_power_at(torch.from_numpy(x), 3, 3, plan).numpy()
    assert np.array_equal(at, got[3:])
    for s, iq in enumerate(iqs):
        pow64 = oracle.channel_power(iq, jtiny(m=m, n=N))
        for c in range(3):
            k = 3 * s + c
            assert oracle.relative_l2(want[k], got[k]) < POWER_TOL, k
            assert oracle.relative_l2(pow64[c], got[k]) < POWER_TOL, k


def test_astage_at_1840_vs_jax():
    """m = 1840 (a 5 x 23 leaf): the A-stage's CPU result, the cluster
    body's plain version, within ASTAGE_TOL of wrp_tpu's fused_chain_astage
    on the same slab in radix row order, at w = n and n/2; no launch
    counted."""
    m = 1840
    plan = _plan(m)
    x = _planar(oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=m))
    a_np, fac = jfull.radix_plan_host(JConsts.build(jtiny(m=m, n=N)), 8)
    order = jfull.radix_row_order(m, 8)
    before = (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_CLUSTER_LAUNCHES)
    for w in (N, N // 2):
        slab = torch.from_numpy(np.ascontiguousarray(x[..., :w]))
        got = tfull.fused_chain_astage(slab, plan)
        assert torch.equal(got, torch.stack(
            tfull.cluster_stage_reference(slab, plan), dim=1))
        want = np.asarray(jfull.fused_chain_astage(
            jnp.asarray(slab.numpy()[:, :, order, :]), jnp.asarray(a_np), fac,
            interpret=True))
        assert oracle.relative_l2(want, got.numpy()) <= ASTAGE_TOL, w
    assert before == (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_CLUSTER_LAUNCHES)
