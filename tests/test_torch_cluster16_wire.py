"""The wire chain (#7, and #8 with offset and salt) on the cluster of 16
(csrc/cluster_chain.cuh with the wire source, S = 16) on the CPU: the
route the wire chain takes for a radix m in (8192, 16384] that the cluster
body takes, as the planar chain and the A-stage do, each channel's ray
split across 16 blocks that read its words at stride ch and decode them
in registers; the m = 16 x p, p a prime in (512, 1023], keep the matrix
kernel's wire source.

Here: the one route of every radix m in (8192, 16384], for all three
chains; the cut at m = 16384 and 16368 (no plan); at m = 8320 (radix 8,
16 x 8 x 65) and 8208 (radix 2, 16 x 513, P = 1) the plan's tables, #7
equal to cluster_chain_power_reference on the decoded planar samples, #8
at offset 1 with salt 7; at 8320 both within 1e-5 of wrp_tpu's wire and
radix kernels in interpret mode, at 8208 within 1e-5 of the matrix form's
plain version (wrp_tpu's radix-2 operator there would be a 540 MB
interpret-mode contraction, so the oracle stands in for it); both within
1e-5 of the fp64 oracle; the fused wire processor's products against the
oracle and the planar `pallas` processor.  No launch counted.  The CUDA
kernels themselves are checked on the card by chip_smoke.py."""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops import device_codec as jdc
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.ops import device_codec as tdc
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.pipeline import SectorProcessor

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

N = 16
CH = 3
SALT = 7
JAX_TOL = 1e-5        # power vs wrp_tpu's kernels
SAME_TOL = 1e-5       # the cluster form vs the matrix form, the oracle
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle

#: the radix m in (8192, 16384] (every one a multiple of 16)
RADIX_ABOVE = [m for m in range(8194, 16385, 2) if tfull.radix_for(m) > 1]


def _is_prime(v):
    return v > 1 and all(v % q for q in range(2, int(v ** 0.5) + 1))


@pytest.fixture(scope="module", params=[8320, 8208])
def case(request):
    """m's constants and plan (one m in memory at a time: the constants
    hold A_half, 0.55 GB at these m), at 8320 wrp_tpu's (`_jax`), and two
    noise sectors as complex iq, planar int16 and wire words."""
    m = request.param
    jcfg = jtiny(m=m, n=N)
    cfg = tiny_config(m=m, n=N)
    consts = PipelineConstants.build(cfg)
    iqs = [oracle.synthetic_iq(jcfg, kind="noise", seed=m + s) for s in (0, 1)]
    planar = np.stack([np.stack([iq.real, iq.imag], 1).astype(np.int16)
                       for iq in iqs])
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    yield types.SimpleNamespace(
        m=m, jcfg=jcfg, cfg=cfg, consts=consts, iqs=iqs, planar=planar,
        wires=wires, plan=tfull.build_plan(consts, "cpu"),
        x=torch.from_numpy(planar.reshape(-1, 2, m, N)),
        w32=tdc.wire_words_i32(torch.from_numpy(wires), cfg),
        jax=_jax(m) if m == 8320 else None)


def _jax(m):
    """wrp_tpu's radix-8 operators at m (8320 alone), its row order and
    its wire lanes' window and phasors."""
    jconsts = JConsts.build(jtiny(m=m, n=N))
    a_np, fac = jfull.radix_plan_host(jconsts, 8)
    wd_il, ph_il = jfull.wire_lane_consts(jconsts, CH)
    return types.SimpleNamespace(
        jconsts=jconsts, order=jfull.radix_row_order(m, 8), a=jnp.asarray(a_np),
        fac=fac, wd_il=jnp.asarray(wd_il), ph_il=jnp.asarray(ph_il))


def _rel(want, got):
    want = np.asarray(want).reshape(-1, got.shape[-1])
    got = np.asarray(got).reshape(-1, got.shape[-1])
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _counts():
    return (tfull.WIRE_LAUNCHES, tfull.WIRE_OFFSET_LAUNCHES,
            tfull.WIRE_CLUSTER_LAUNCHES, tfull.LAUNCHES,
            tfull.RADIX_OFFSET_LAUNCHES, tfull.RADIX_CLUSTER_LAUNCHES,
            tfull.DENSE_MATRIX_LAUNCHES)


def test_one_route_for_every_chain_above_8192():
    """`chain_route` takes m alone, one route for the planar chain, the
    wire chain and the A-stage.  Of the 512 radix m in (8192, 16384], the
    437 the cluster body takes go to the cluster of 16 for all three; the
    75 m = 16 x p (p a prime in (512, 1023], a Bluestein length of 2048)
    go to the matrix kernels, saying why."""
    assert list(inspect.signature(tfull.chain_route).parameters) == ["m"]
    taken, refused = [], []
    for m in RADIX_ABOVE:
        assert m % 16 == 0 and tfull.cluster_split(m) == 16, m
        (taken if tfull.cluster_takes(m) else refused).append(m)
    assert (len(RADIX_ABOVE), len(taken), len(refused)) == (512, 437, 75)
    for m in taken:
        assert tfull.chain_route(m) == "cluster", m
    for m in refused:
        assert _is_prime(m // 16), m
        assert tfull.chain_route(m) == "matrix", m
        assert "needs a Bluestein length 2048" in tfull.cluster_refusal(m), m


@pytest.mark.parametrize("m,cut,cols", [
    # L = 1 at P = 1024; span 64
    (16384, (1024, 1024, 1, 32, 32, 64), 16),
    # P = 1, 1023 = 3 x 11 x 31; span 64
    (16368, (1023, 1, 1023, 1, 1, 64), 16)])
def test_cut_at_the_top(m, cut, cols):
    """At m = 16384 and 16368, without a plan: the wire chain's route is
    the cluster of 16 at the fused chains' cut (the planar chain's: the
    wire stages nothing), its columns a round within one block's shared
    memory and twice them over it."""
    assert tfull.chain_route(m) == "cluster"
    g = tfull.cluster_geometry(m, 512)
    assert g.S == 16 and (g.ms, g.P, g.L, g.P1, g.P2, g.span) == cut
    assert g.cols == cols
    assert tfull.cluster_smem_bytes(m, g.cols, True, 0) <= tfull.MAX_SMEM_BYTES
    assert tfull.cluster_smem_bytes(m, 2 * g.cols, True, 0) > tfull.MAX_SMEM_BYTES


def test_plan_tables(case):
    """The plan holds the cluster tables its chains read and no A_half on
    the host: no chain of a radix m the cluster body takes reads the
    matrix kernel's operator, which is refused, naming the m it serves."""
    plan = case.plan
    assert plan.cluster.S == 16 and plan.cluster_t is not None
    assert plan.fft_t is None and plan.host_a_half is None
    with pytest.raises(ValueError, match="an m the cluster body refuses"):
        plan.dense_operator()


def test_wire(case):
    """#7 on both sectors: equal to cluster_chain_power_reference on the
    decoded planar samples; within 1e-5 of wrp_tpu's wire kernel in
    interpret mode at 8320 (radix 8), of the matrix form's plain version
    at 8208 (radix 2), and of the fp64 oracle; no launch counted."""
    before = _counts()
    got = tfull.fused_chain_power_wire(case.w32, case.plan, CH)
    assert got.shape == (2, CH, case.m // 2)
    planar = case.x.float()
    assert torch.equal(got.reshape(-1, case.m // 2),
                       tfull.cluster_chain_power_reference(planar, case.plan))
    if case.jax is not None:
        j = case.jax
        want = np.asarray(jfull.fused_chain_power_wire(
            jdc.wire_words_i32(jnp.asarray(case.wires), case.jcfg, radix=8),
            j.a, j.fac, j.wd_il, j.ph_il, CH, interpret=True))
        assert _rel(want, got.numpy()) <= JAX_TOL
    else:
        assert _rel(tfull.fused_chain_power_reference(planar, case.plan)
                    .numpy(), got.numpy()) <= SAME_TOL
    for s, iq in enumerate(case.iqs):
        assert _rel(oracle.channel_power(iq, case.jcfg),
                    got[s].numpy()) <= SAME_TOL, s
    assert _counts() == before


def test_offset_salt(case):
    """#8: sector 1 of the two-sector staging at salt 7 equal to the
    cluster plain version on the slab with its salt; within 1e-5 of
    wrp_tpu's radix kernel on the salted samples at 8320, of the matrix
    form's plain version with the salt at 8208, and of the oracle on the
    salted samples; salt 0 equals the unsalted entry, which equals #7 on
    the slab alone; no launch counted."""
    w32, plan = case.w32, case.plan
    before = _counts()
    got = tfull.fused_chain_power_wire(w32, plan, CH, offset=1, bs=1,
                                       salt=SALT)
    assert got.shape == (1, CH, case.m // 2)
    slab = case.x[CH:].float()
    assert torch.equal(got[0], tfull.cluster_chain_power_reference(
        slab, plan, SALT))
    unsalted = tfull.fused_chain_power_wire(w32, plan, CH, offset=1, bs=1)
    assert torch.equal(unsalted, tfull.fused_chain_power_wire(
        w32, plan, CH, offset=1, bs=1, salt=0))
    assert torch.equal(unsalted, tfull.fused_chain_power_wire(
        w32[1:].contiguous(), plan, CH))
    if case.jax is not None:
        j = case.jax
        salted = case.planar[1].astype(np.float32) + np.float32(SALT)
        want = np.asarray(jfull.fused_chain_power_radix(
            jnp.asarray(salted[:, :, j.order, :]), j.a, j.fac,
            jnp.asarray(j.jconsts.wd), jnp.asarray(j.jconsts.clip_phasors),
            interpret=True))
        assert _rel(want, got[0].numpy()) <= JAX_TOL
    else:
        assert _rel(tfull.fused_chain_power_reference(slab, plan, SALT)
                    .numpy(), got[0].numpy()) <= SAME_TOL
    assert _rel(oracle.channel_power(case.iqs[1] + SALT * (1 + 1j),
                                     case.jcfg), got[0].numpy()) <= SAME_TOL
    assert _counts() == before


def test_fused_wire_processor(case):
    """The fused wire processor on the sectors' wire bytes viewed as int32
    words: products within 1e-5 of the planar `pallas` processor's (two
    forms of the chain) and within 2e-4 of the fp64 oracle; no launch
    counted."""
    before = _counts()
    fused = SectorProcessor(case.cfg, method="pallas", device="cpu",
                            consts=case.consts, wire_input=True,
                            wire_decode="fused")
    got = fused(case.wires.view("<i4"))
    pallas = SectorProcessor(case.cfg, method="pallas", device="cpu",
                             consts=case.consts)(case.planar)
    for name, a, b in zip(("zdb", "zdr"), pallas, got):
        assert oracle.relative_l2(a.numpy(), b.numpy()) <= SAME_TOL, name
    for s, iq in enumerate(case.iqs):
        want = oracle.process_sector(iq, case.jcfg)
        for name, w, g in zip(("zdb", "zdr"), want, got):
            e = oracle.relative_l2(np.asarray(w), g[s].numpy())
            assert e <= PRODUCT_TOL, (name, s, e)
    assert _counts() == before
