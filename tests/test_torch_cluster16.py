"""The cluster body at a cluster of 16 blocks (csrc/cluster_chain.cuh, S =
16) on the CPU: the route the planar chain (#3, and #4 with offset and
salt), the wire chain (#7/#8) and the A-stage (#5) take for 8192 < m <=
16384, each ray split across 16 blocks, block b the m/16-point DFT of
rows 16 t + b and the 8-of-16 combine (two 8-point DFTs joined by W_16)
over distributed shared memory (the wire chain on it in
tests/test_torch_cluster16_wire.py).

Here: `chain_route` and `cluster_refusal` by m; the cut at m =
8320 and 16384, worked out by hand; the range stage's plain version
(`cluster_stage_reference`) against a float64 FFT at m = 8224 (a 257-point
Bluestein leaf) and 8320 (a 5 x 13 leaf); the A-stage's and #3's plain
versions at m = 8320 against wrp_tpu's kernels in interpret mode and the
fp64 oracle, #4 at an offset with salt 7; the `pallas` and `pallas-seq`
processors' products at m = 8320 and 16384 against the oracle and each
other.  The CUDA kernels themselves are checked on the card by
chip_smoke.py."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.parallel import build_sharded_processor, make_mesh
from wrp_tpu_torch.pipeline import SectorProcessor

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

N = 16
CH = 3
SALT = 7
FFT_TOL = 1e-6        # the plain range stage vs the float64 FFT
JAX_TOL = 1e-5        # Y and power vs wrp_tpu's kernels
POWER_TOL = 1e-5      # power vs the fp64 oracle; two forms of one chain
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle


@functools.lru_cache(maxsize=1)
def _case(m):
    """m's constants and plan (the one geometry in memory at a time: the
    constants hold A_half, 1 GB at m = 16384) and two noise sectors as
    complex iq and planar int16."""
    jcfg = jtiny(m=m, n=N)
    consts = PipelineConstants.build(tiny_config(m=m, n=N))
    iqs = [oracle.synthetic_iq(jcfg, kind="noise", seed=m + s) for s in (0, 1)]
    return types.SimpleNamespace(
        m=m, jcfg=jcfg, consts=consts, plan=tfull.build_plan(consts, "cpu"),
        iqs=iqs, planar=np.stack([np.stack([iq.real, iq.imag], 1)
                                  .astype(np.int16) for iq in iqs]))


def _rel(want, got):
    want = np.asarray(want).reshape(-1, got.shape[-1])
    got = np.asarray(got).reshape(-1, got.shape[-1])
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _counts():
    return (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_CLUSTER_LAUNCHES,
            tfull.ASTAGE_MATRIX_LAUNCHES, tfull.LAUNCHES,
            tfull.RADIX_OFFSET_LAUNCHES, tfull.RADIX_CLUSTER_LAUNCHES,
            tfull.DENSE_MATRIX_LAUNCHES)


@pytest.mark.parametrize("m,cut", [
    (8224, (514, 2, 257)), (8320, (520, 8, 65)), (9216, (576, 64, 9)),
    (12288, (768, 256, 3)), (16384, (1024, 1024, 1))])
def test_route_by_chain(m, cut):
    """A radix m % 32 == 0 in (8192, 16384] takes the cluster of 16 (ms =
    m / 16 = P L, P >= 2) for every chain: `chain_route` names one route
    for the planar chain, the wire chain and the A-stage (m = 16 x odd,
    P = 1, in tests/test_torch_cluster16_p1.py)."""
    assert tfull.radix_for(m) > 1 and tfull.cluster_split(m) == 16
    assert tfull.cluster_refusal(m) is None
    assert tfull.chain_route(m) == "cluster"
    g = tfull.cluster_geometry(m, 512)
    assert (g.S, (g.ms, g.P, g.L)) == (tfull.CLUSTER_SPLIT_LONG, cut)


@pytest.mark.parametrize("m,split,why", [
    (8336, 16, "m=8336: the leaf prime 521 needs a Bluestein length 2048"),
    (16416, 16, "CLUSTER_MAX_M = 16384, got m=16416"),
    (8200, 8, "m=8200 = 8 x 1025: a block's 1025-point sub-DFT passes "
              "CLUSTER_MAX_MS = 1024")])
def test_refusals_above_8192(m, split, why):
    """m = 16 x p above 8192, p a prime in (512, 1023] (its leaf's
    Bluestein length passes BLUESTEIN_MAX_N), m above CLUSTER_MAX_M and m
    = 8 x odd above 8192 (S = 8, a sub-DFT over CLUSTER_MAX_MS) are
    refused, saying why, and every chain takes the matrix kernel."""
    assert tfull.cluster_split(m) == split
    assert why in tfull.cluster_refusal(m)
    with pytest.raises(ValueError, match=why):
        tfull.cluster_geometry(m, 512)
    assert tfull.chain_route(m) == "matrix"


# words of one block (4 bytes each) at n = 512, worked out by hand as in
# tests/test_torch_cluster_routes.py: A (L P1 slot rows of P2 cols + pad,
# the pad cols where pass 2 reads at cols < 32), the staged samples (2 ms
# cols of 2 or 4 bytes), the fused chains' owned rows (S/2 = 8 k2 of span
# = ceil(ms / 16) k1, pitch cols + 1) and round constants (5 cols)
@pytest.mark.parametrize("m,cut,cols,smem", [
    # ms = 520 = 8 x 65: P2 = 1, no pad; span 33, so 8 x 33 owned rows
    (8320, (520, 8, 65, 8, 1, 33), (32, 32, 16),
     (4 * (2 * 16640 + 2 * 8 * 33 * 33 + 5 * 32),
      4 * (2 * 16640 + 16640), 4 * (2 * 8320 + 16640))),
    # ms = 1024, L = 1: the slots 32 x (32 x 16 + 16); span 64
    (16384, (1024, 1024, 1, 32, 32, 64), (16, 16, 8),
     (4 * (2 * 16896 + 2 * 8 * 64 * 17 + 5 * 16),
      4 * (2 * 16896 + 16384), 4 * (2 * 32 * (32 * 8 + 8) + 16384))),
])
def test_cluster16_geometry(m, cut, cols, smem):
    """The cut at a cluster of 16, n = 512: (ms, P, L, P1, P2, span), and
    for the fused chains, the int16 and the f32 A-stage the columns a
    round and a block's shared memory, each within one block's 227 KB with
    twice the columns over it; 8 m/32 owned rows a block, at most 512."""
    bodies = ((True, 0), (False, 2), (False, 4))
    for body, want_cols, want_smem in zip(bodies, cols, smem):
        g = tfull.cluster_geometry(m, 512, *body)
        assert (g.ms, g.P, g.L, g.P1, g.P2, g.span) == cut
        assert g.S == 16 and g.S * g.ms == m
        assert g.cols == want_cols, body
        assert tfull.cluster_smem_bytes(m, g.cols, *body) == want_smem, body
        assert want_smem <= tfull.MAX_SMEM_BYTES
        assert tfull.cluster_smem_bytes(m, 2 * g.cols, *body) > tfull.MAX_SMEM_BYTES
    assert 8 * g.span <= 2 * 256


@pytest.mark.parametrize("m", [8224, 8320])
def test_stage_vs_float64_fft(m):
    """cluster_stage_reference at S = 16 within 1e-6 of the float64 FFT of
    the windowed, salted rows, cropped to k < m/2, at w = n and 3 (8224:
    16 x 2 x 257, a Bluestein leaf of N = 1024; 8320: 16 x 8 x 5 x 13)."""
    c = _case(m)
    assert c.plan.cluster.S == 16
    win = np.asarray(c.consts.op_a_half[0]).astype(np.complex128).real
    x = c.planar.reshape(-1, 2, m, N)
    for w in (N, 3):
        slab = np.ascontiguousarray(x[..., :w])
        yr, yi = tfull.cluster_stage_reference(torch.from_numpy(slab),
                                               c.plan, SALT)
        xf = slab.astype(np.float64) + SALT
        z = (xf[:, 0] + 1j * xf[:, 1]) * win[None, :, None]
        want = np.fft.fft(z, axis=1)[:, : m // 2]
        got = yr.double().numpy() + 1j * yi.double().numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= FFT_TOL, w


@functools.lru_cache(maxsize=1)
def _jax(m):
    """wrp_tpu's radix-8 operators at m and its row order."""
    jconsts = JConsts.build(jtiny(m=m, n=N))
    a_np, fac = jfull.radix_plan_host(jconsts, 8)
    return types.SimpleNamespace(
        jconsts=jconsts, order=jfull.radix_row_order(m, 8),
        ops=(jnp.asarray(a_np), fac))


def test_astage_vs_jax():
    """m = 8320: the A-stage's CPU result is the cluster form's plain
    version, within 1e-5 of wrp_tpu's A-stage on the same slab in radix
    row order at w = n and n/4; no launch counted."""
    c, j = _case(8320), _jax(8320)
    assert tfull.chain_route(c.m) == "cluster" and c.plan.radix == 8
    x = c.planar.reshape(-1, 2, c.m, N)
    before = _counts()
    for w in (N, N // 4):
        slab = torch.from_numpy(np.ascontiguousarray(x[..., :w]))
        got = tfull.fused_chain_astage(slab, c.plan)
        assert got.shape == (2 * CH, 2, c.m // 2, w)
        assert torch.equal(got, torch.stack(
            tfull.cluster_stage_reference(slab, c.plan), 1))
        want = np.asarray(jfull.fused_chain_astage(
            jnp.asarray(slab.numpy()[:, :, j.order, :]), *j.ops,
            interpret=True))
        assert oracle.relative_l2(want, got.numpy()) <= JAX_TOL, w
    assert _counts() == before


def test_radix_and_offset_salt_vs_jax():
    """m = 8320: #3 on both sectors (int16 and f32) equal to
    cluster_chain_power_reference, within 1e-5 of wrp_tpu's radix kernel
    (interpret mode, radix row order) and of the oracle; #4 on the second
    sector at salt 7 equal to the plain version on the salted slab and
    within 1e-5 of wrp_tpu's radix kernel on the salted samples; no
    launch counted."""
    c, j = _case(8320), _jax(8320)
    x = torch.from_numpy(c.planar.reshape(-1, 2, c.m, N))
    ops = (*j.ops, jnp.asarray(j.jconsts.wd),
           jnp.asarray(j.jconsts.clip_phasors))
    before = _counts()
    for xs in (x, x.float()):
        got = tfull.fused_chain_power_radix(xs, c.plan)
        assert torch.equal(got, tfull.cluster_chain_power_reference(xs, c.plan))
        want = np.asarray(jfull.fused_chain_power_radix(
            jnp.asarray(xs.numpy()[:, :, j.order, :]), *ops, interpret=True))
        assert _rel(want, got.numpy()) <= JAX_TOL, xs.dtype
        for s, iq in enumerate(c.iqs):
            assert _rel(oracle.channel_power(iq, c.jcfg),
                        got[s * CH:(s + 1) * CH].numpy()) <= POWER_TOL
    got = tfull.fused_chain_power_radix(x, c.plan, offset=CH, bc=CH, salt=SALT)
    assert torch.equal(got, tfull.cluster_chain_power_reference(
        x[CH:].float() + SALT, c.plan))
    salted = c.planar[1].astype(np.float32) + np.float32(SALT)
    want = np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(salted[:, :, j.order, :]), *ops, interpret=True))
    assert _rel(want, got.numpy()) <= JAX_TOL
    assert _counts() == before


@pytest.mark.parametrize("m", [8320, 16384])
def test_pallas_and_seq_products(m):
    """The `pallas` processor (#3) and a world-size-1 `pallas-seq` step
    (#5 then #6), both on the cluster of 16: products within 2e-4 of the
    fp64 oracle and within 1e-5 of each other (two forms of the chain)."""
    c = _case(m)
    cfg = tiny_config(m=m, n=N)
    pallas = SectorProcessor(cfg, method="pallas", device="cpu",
                             consts=c.consts)(c.planar)
    step = build_sharded_processor(cfg, make_mesh(device="cpu"),
                                   method="pallas-seq", device="cpu",
                                   consts=c.consts)
    seq = step(c.planar)
    for name, a, b in zip(("zdb", "zdr"), pallas, seq):
        assert oracle.relative_l2(a.numpy(), b.numpy()) <= POWER_TOL, name
    for s, iq in enumerate(c.iqs):
        want = oracle.process_sector(iq, c.jcfg)
        for got in (pallas, seq):
            for name, w, g in zip(("zdb", "zdr"), want, got):
                e = oracle.relative_l2(np.asarray(w), g[s].numpy())
                assert e <= PRODUCT_TOL, (name, s, e)
