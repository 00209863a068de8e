"""The cluster of 16 at P = 1 (csrc/cluster_chain.cuh, kP1S16) on the CPU:
the route the planar chain (#3, and #4 with offset and salt) and the
A-stage (#5) take at a radix m = 16 x odd in (8192, 16384], each ray split
across 16 blocks, block b's m/16-point DFT of the rows 16 t + b the odd
leaf alone (P = P1 = P2 = 1), then the 8-of-16 combine.  The m = 16 x p,
p a prime in (512, 1023], stay refused (their leaf needs a Bluestein
length of 2048) and keep the matrix routes.

Here: the route and refusal of every such m; the leaf's plan kept per L
(every launch reads it); the cut at m = 8208 (16 x
513 = 16 x 3^3 x 19), 8240 (16 x 5 x 103, a Bluestein leaf of N = 256)
and 16368 (16 x 3 x 11 x 31, span 64: 512 owned rows, two a thread);
the range stage's plain version against a float64 FFT; #5 (w = n, n/4),
#3 (int16, f32) and #4 (offset, salt 7) equal to the cluster form's plain
versions, within 1e-5 of the matrix form's plain versions, the float64
FFT of the windowed slab and the fp64 oracle (wrp_tpu's radix-2 operator
at these m would be a 540 MB interpret-mode contraction, so its oracle
stands in for it); the `pallas` and `pallas-seq` products at 8208 and
8240 against the oracle.  The CUDA kernels themselves are checked on the
card by chip_smoke.py."""

import types

import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
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
SAME_TOL = 1e-5       # the cluster form vs the matrix form, the FFT, the oracle
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle

#: the radix m = 16 x o, o odd in [513, 1023]: above CLUSTER_MAX_M8, not
#: a multiple of 32
ODD16 = [16 * o for o in range(513, 1024, 2)]


def _is_prime(v):
    return v > 1 and all(v % q for q in range(2, int(v ** 0.5) + 1))


@pytest.fixture(scope="module", params=[8208, 8240, 16368])
def case(request):
    """m's constants and plan (one m in memory at a time: at 16368 the
    plan's radix-2 operators hold 1 GB) and two noise sectors as complex
    iq and planar int16."""
    m = request.param
    jcfg = jtiny(m=m, n=N)
    consts = PipelineConstants.build(tiny_config(m=m, n=N))
    iqs = [oracle.synthetic_iq(jcfg, kind="noise", seed=m + s) for s in (0, 1)]
    planar = np.stack([np.stack([iq.real, iq.imag], 1).astype(np.int16)
                       for iq in iqs])
    yield types.SimpleNamespace(
        m=m, jcfg=jcfg, consts=consts, plan=tfull.build_plan(consts, "cpu"),
        iqs=iqs, planar=planar,
        x=torch.from_numpy(planar.reshape(-1, 2, m, N)))


def _rel(want, got):
    want = np.asarray(want).reshape(-1, got.shape[-1])
    got = np.asarray(got).reshape(-1, got.shape[-1])
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _counts():
    return (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_CLUSTER_LAUNCHES,
            tfull.ASTAGE_MATRIX_LAUNCHES, tfull.LAUNCHES,
            tfull.RADIX_OFFSET_LAUNCHES, tfull.RADIX_CLUSTER_LAUNCHES,
            tfull.DENSE_MATRIX_LAUNCHES)


def test_routes_of_every_16_x_odd():
    """Of the 256 radix m = 16 x odd in (8192, 16384], the 181 whose leaf
    fits BLUESTEIN_MAX_N take the cluster of 16 at P = 1 for the planar
    chain and the A-stage; the 75 m = 16 x p (p a prime in (512, 1023])
    are refused by their Bluestein length of 2048 and every chain takes
    the matrix kernel there; the wire chain takes the route the others
    take (`chain_route` has one route for all three chains)."""
    taken, refused = [], []
    for m in ODD16:
        assert tfull.radix_for(m) == 2 and tfull.cluster_split(m) == 16, m
        (refused if _is_prime(m // 16) else taken).append(m)
    assert (len(ODD16), len(taken), len(refused)) == (256, 181, 75)
    for m in taken:
        assert tfull.cluster_refusal(m) is None, m
        assert tfull.chain_route(m) == "cluster", m
        g = tfull.cluster_geometry(m, 512)
        assert (g.S, g.ms, g.P, g.L, g.P1, g.P2) == (16, m // 16, 1, m // 16,
                                                     1, 1), m
        assert g.bluestein <= tfull.BLUESTEIN_MAX_N, m
    for m in refused:
        why = (f"m={m}: the leaf prime {m // 16} needs a Bluestein length "
               f"2048 > BLUESTEIN_MAX_N = 1024")
        assert tfull.cluster_refusal(m) == why, m
        assert tfull.chain_route(m) == "matrix", m
        with pytest.raises(ValueError, match="BLUESTEIN_MAX_N"):
            tfull.cluster_geometry(m, 512)


def test_leaf_plan_kept_per_l():
    """Every launch asks `chain_route` and the cut for its m, and both read
    the leaf's plan: it is worked out once per L and kept, its perm
    read-only so that no caller can change the kept plan."""
    lp = tfull.leaf_plan(1023)
    assert tfull.leaf_plan(1023) is lp
    assert not lp.perm.flags.writeable
    with pytest.raises(ValueError):
        lp.perm[0] = 1
    assert sorted(lp.perm.tolist()) == list(range(1023))


@pytest.mark.parametrize("m,leaf,bluestein,cols,batch,span", [
    # 513 = 3 x 3 x 3 x 19: four register passes
    (8208, (3, 3, 3, 19), 0, (32, 32, 16), (0, 0, 0), 33),
    # 515 = 5 x 103: the 103-point pass in Bluestein's form, N = 256; a
    # batch of 32 convolutions in the fused chains' 2 x 8712 words of
    # owned rows, 16 beside the int16 A-stage's staged samples
    (8240, (5, 103), 256, (32, 32, 16), (32, 16, 32), 33),
    # 1023 = 3 x 11 x 31; span 64: 8 x 64 = 512 owned rows, two a thread
    (16368, (3, 11, 31), 0, (16, 16, 8), (0, 0, 0), 64),
])
def test_cut(m, leaf, bluestein, cols, batch, span):
    """The cut at P = 1, n = 512, for the fused chains, the int16 and the
    f32 A-stage: the leaf's passes, Bluestein's N and batch, the columns
    a round (each within one block's 227 KB, twice them over it) and the
    span of k1 a block combines."""
    assert tfull.leaf_plan(m // 16).radices == leaf
    bodies = ((True, 0), (False, 2), (False, 4))
    for body, want_cols, want_batch in zip(bodies, cols, batch):
        g = tfull.cluster_geometry(m, 512, *body)
        assert (g.S, g.ms, g.P, g.L, g.span) == (16, m // 16, 1, m // 16,
                                                 span)
        assert (g.bluestein, g.cols, g.batch) == (bluestein, want_cols,
                                                  want_batch), body
        assert tfull.cluster_smem_bytes(m, g.cols, *body) <= tfull.MAX_SMEM_BYTES
        assert tfull.cluster_smem_bytes(m, 2 * g.cols, *body) > tfull.MAX_SMEM_BYTES
    assert 8 * span <= 2 * 256


def test_plan_tables(case):
    """The plan holds the cluster tables (the leaf's plan after the head,
    no W_P beyond W_1) and neither the FFT-form tables nor the host's
    A_half (the wire chain takes the cluster of 16 here too)."""
    g = case.plan.cluster
    assert case.plan.radix == 2 and case.plan.fft_t is None
    assert case.plan.host_a_half is None
    assert case.plan.cluster_t.numel() == (
        case.m + 2 + 2 * g.L + 2 * 16 * g.ms + 2 * 16
        + tfull.leaf_tables(g.L).size)
    assert case.plan.cluster_phi.shape == (-(-N // g.cols), 4)


def test_stage_vs_float64_fft(case):
    """cluster_stage_reference at P = 1 within 1e-6 of the float64 FFT of
    the windowed, salted rows, cropped to k < m/2, at w = n and 3."""
    win = np.asarray(case.consts.op_a_half[0]).astype(np.complex128).real
    x = case.planar.reshape(-1, 2, case.m, N)
    for w in (N, 3):
        slab = np.ascontiguousarray(x[..., :w])
        yr, yi = tfull.cluster_stage_reference(torch.from_numpy(slab),
                                               case.plan, SALT)
        xf = slab.astype(np.float64) + SALT
        z = (xf[:, 0] + 1j * xf[:, 1]) * win[None, :, None]
        want = np.fft.fft(z, axis=1)[:, : case.m // 2]
        got = yr.double().numpy() + 1j * yi.double().numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= FFT_TOL, w


def test_astage(case):
    """#5 at w = n and n/4: the CPU result is the cluster form's plain
    version, within 1e-5 of the matrix form's (`_contract_reference`) and
    of the float64 FFT of the windowed slab; no launch counted."""
    assert tfull.chain_route(case.m) == "cluster"
    win = np.asarray(case.consts.op_a_half[0]).astype(np.complex128).real
    before = _counts()
    for w in (N, N // 4):
        slab = case.x[..., :w].contiguous()
        got = tfull.fused_chain_astage(slab, case.plan)
        assert got.shape == (2 * CH, 2, case.m // 2, w)
        assert torch.equal(got, torch.stack(
            tfull.cluster_stage_reference(slab, case.plan), 1))
        matrix = torch.stack(tfull._contract_reference(slab, case.plan), 1)
        assert oracle.relative_l2(matrix.numpy(), got.numpy()) <= SAME_TOL, w
        z = (slab[:, 0].double().numpy() + 1j * slab[:, 1].double().numpy()
             ) * win[None, :, None]
        y = np.fft.fft(z, axis=1)[:, : case.m // 2]
        want = np.stack([y.real, y.imag], 1)
        assert oracle.relative_l2(want, got.numpy()) <= SAME_TOL, w
    assert _counts() == before


def test_radix_and_offset_salt(case):
    """#3 on both sectors (int16 and f32) equal to
    cluster_chain_power_reference, within 1e-5 of the matrix form's plain
    version and of the fp64 oracle; #4 on the second sector at offset 3,
    salt 7 equal to the cluster plain version with its salt, within 1e-5
    of the matrix form's with the salt and of the oracle on the salted
    samples; no launch counted."""
    x, plan = case.x, case.plan
    before = _counts()
    for xs in (x, x.float()):
        got = tfull.fused_chain_power_radix(xs, plan)
        assert torch.equal(got, tfull.cluster_chain_power_reference(xs, plan))
        assert _rel(tfull.fused_chain_power_reference(xs, plan).numpy(),
                    got.numpy()) <= SAME_TOL, xs.dtype
        for s, iq in enumerate(case.iqs):
            assert _rel(oracle.channel_power(iq, case.jcfg),
                        got[s * CH:(s + 1) * CH].numpy()) <= SAME_TOL
    got = tfull.fused_chain_power_radix(x, plan, offset=CH, bc=CH, salt=SALT)
    assert torch.equal(got, tfull.cluster_chain_power_reference(
        x[CH:], plan, SALT))
    assert _rel(tfull.fused_chain_power_reference(x[CH:], plan, SALT)
                .numpy(), got.numpy()) <= SAME_TOL
    assert _rel(oracle.channel_power(case.iqs[1] + SALT * (1 + 1j),
                                     case.jcfg), got.numpy()) <= SAME_TOL
    assert _counts() == before


@pytest.mark.parametrize("case", [8208, 8240], indirect=True)
def test_pallas_and_seq_products(case):
    """The `pallas` processor (#3) and a world-size-1 `pallas-seq` step
    (#5 then #6) on the cluster of 16 at P = 1: products within 2e-4 of
    the fp64 oracle and within 1e-5 of each other (two forms of the
    chain).  At 8208 and 8240: each processor builds its own plan, which
    at 16368 holds 1 GB of radix-2 operators more."""
    cfg = tiny_config(m=case.m, n=N)
    pallas = SectorProcessor(cfg, method="pallas", device="cpu",
                             consts=case.consts)(case.planar)
    step = build_sharded_processor(cfg, make_mesh(device="cpu"),
                                   method="pallas-seq", device="cpu",
                                   consts=case.consts)
    seq = step(case.planar)
    for name, a, b in zip(("zdb", "zdr"), pallas, seq):
        assert oracle.relative_l2(a.numpy(), b.numpy()) <= SAME_TOL, name
    for s, iq in enumerate(case.iqs):
        want = oracle.process_sector(iq, case.jcfg)
        for got in (pallas, seq):
            for name, w, g in zip(("zdb", "zdr"), want, got):
                e = oracle.relative_l2(np.asarray(w), g[s].numpy())
                assert e <= PRODUCT_TOL, (name, s, e)
