"""Which kernel the planar chain (#3/#4), the A-stage (#5) and the wire
chain (#7/#8) launch for each m, and the cluster body's cut, on the CPU.

`chain_route(m)` picks from m alone, one route for all three chains: the
register body of csrc/fft_chain.cuh up to 1024 range cells, the cluster
body of csrc/cluster_chain.cuh up to 16384 (each ray split across a
cluster of 8 blocks, 16 above 8192; the dense entries' radix-1 m = S x
odd across S), the matrix forms where the cluster body refuses m
(csrc/fused_chain_dense.cu's matrix kernel and its wire source,
csrc/fused_chain_astage_matrix.cu).  Here: the
route, the radix entry's
plain version and the plan's tables per m; the cluster geometry's cut and
shared memory at each m the slice names, worked out by hand, for the
A-stage, the wire chain and the planar chain (which reads its samples
straight from device memory, against the staged form it was measured
beside); the layout of
`cluster_tables`; the cluster stage against the fp64 DFT at its smallest m;
the `pallas-seq` and fused-wire processors' products against the oracle at
m = 1840 and 8192; and the matrix routes above 8192: the A-stage's matrix
plain version at m = 8336 (16 x 521, radix 2, which the cluster body
refuses: its leaf prime 521 needs a Bluestein length of 2048) against a
float64 FFT; at m = 8320 (radix 8) the fused wire decode and `pallas-seq`
on the cluster of 16, #8's plain version with offset and salt; at 8336
the wire's matrix route.  tests/test_torch_cluster16.py and
tests/test_torch_cluster16_wire.py hold the cluster of 16 itself."""

import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.parallel import build_sharded_processor, make_mesh
from wrp_tpu_torch.pipeline import SectorProcessor

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

N = 16
SAME_TOL = 1e-5       # two forms of the same chain (fp32 reassociation)
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle
ASTAGE_TOL = 1e-5     # Y vs wrp_tpu's A-stage (bf16 hi/lo splits there)
ABOVE = 8320          # radix 8 above 8192: every chain on the cluster of 16
REFUSED = 8336        # 16 x 521 (radix 2): the cluster body refuses it (Bluestein N = 2048)


def _planar(iq):
    return np.stack([iq.real, iq.imag], 1).astype(np.int16)


def _plan(m, n=N):
    return tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")


def _hold(got, want, tol, what):
    for name, g, w in zip(("zdb", "zdr"), got, want):
        g = g.numpy() if torch.is_tensor(g) else g
        e = oracle.relative_l2(np.asarray(w), np.asarray(g))
        assert e <= tol, (what, name, e)


def test_chain_route_by_m():
    """The register body up to 1024, the cluster body for radix m up to
    16384 (for every chain), the matrix forms above and where the
    cluster body refuses m; cluster_geometry refuses the m the body does
    not take, saying why (outside its range, naming CLUSTER_MAX_M = 16384;
    a block's sub-DFT over CLUSTER_MAX_MS; a Bluestein length over
    BLUESTEIN_MAX_N, at 1042 and at 8336 = 16 x 521).  The radix entry's CPU result is the
    plain version of the route the card launches, exactly (the cluster
    route's at m = 8320 in test_wire_and_seq_matrix_above_8192), and the
    FFT-form body takes a radix m only up to 1024."""
    rng = np.random.default_rng(7)
    for m in (64, 960, 1024):
        assert tfull.chain_route(m) == "register", m
    for m in (1040, 1536, 1840, 2048, 4096, 4160, 8192):
        assert tfull.cluster_takes(m) and tfull.chain_route(m) == "cluster", m
        assert not tfull.fft_takes(m) and not tfull.fft_long(m), m
    for m, plain in ((960, tfull.fft_chain_power_reference),
                     (1024, tfull.fft_chain_power_reference),
                     (1040, tfull.cluster_chain_power_reference),
                     (1840, tfull.cluster_chain_power_reference)):
        plan = _plan(m)
        x = torch.from_numpy(rng.integers(-8192, 8192, (4, 2, m, N),
                                          dtype=np.int16))
        assert torch.equal(tfull.fused_chain_power_radix(x, plan),
                           plain(x, plan)), m
        assert torch.equal(
            tfull.fused_chain_power_radix(x, plan, offset=1, bc=2, salt=7),
            plain(x[1:3], plan, 7)), m
    for m in (ABOVE, 16384):
        assert tfull.radix_for(m) > 1 and tfull.chain_route(m) == "cluster"
        assert tfull.cluster_split(m) == 16, m
    for m in (REFUSED, 16416):
        assert tfull.radix_for(m) > 1, m
        assert tfull.chain_route(m) == "matrix", m
    # m = 1832 = 8 x 229 does not split into radix branches: the dense
    # entries' route, on the cluster body too (its leaf in Bluestein's form)
    assert tfull.radix_for(1832) == 1 and tfull.cluster_takes(1832)
    for m, why in ((1024, "CLUSTER_MAX_M = 16384"),
                   (16416, "CLUSTER_MAX_M = 16384"),
                   (REFUSED, "the leaf prime 521 needs a Bluestein length 2048"),
                   (4100, "CLUSTER_MAX_MS = 1024"),
                   (1042, "BLUESTEIN_MAX_N = 1024")):
        assert tfull.cluster_refusal(m) is not None
        with pytest.raises(ValueError, match=why):
            tfull.cluster_geometry(m, 512)


def test_plan_tables_by_route():
    """A plan holds the tables its routes read: fft_t for the FFT-form body
    (m <= 1024, and the dense entries' long-ray m = 2 x odd above 2048),
    cluster_t and cluster_phi for the cluster body (every chain of a radix
    m up to 16384, and the dense entries' m = S x odd: 1832), A_half on
    the host only for a radix plan's matrix kernel (an m the cluster body
    refuses: 8336, not 8320)."""
    cases = {1024: (True, False, False), 1832: (False, True, False),
             4094: (True, False, False),
             2048: (False, True, False), 4096: (False, True, False),
             4160: (False, True, False), 8192: (False, True, False),
             ABOVE: (False, True, False), REFUSED: (False, False, True)}
    for m, (fft, cluster, host) in cases.items():
        plan = _plan(m)
        assert (plan.fft_t is not None, plan.cluster_t is not None,
                plan.host_a_half is not None) == (fft, cluster, host), m
        if cluster:
            g = plan.cluster
            assert plan.cluster_phi.shape == (-(-N // g.cols), 4)
            leaf = tfull.leaf_tables(g.L).size if g.L > 1 else 0
            assert plan.cluster_t.numel() == (m + 2 * g.P + 2 * g.L * g.P
                                              + 2 * g.S * g.ms + 2 * g.S
                                              + leaf)


# words of one block (4 bytes each) at n = 512, worked out by hand: A
# (complex, so twice its values: L P1 slot rows of P2 cols + pad, the pad
# cols where pass 2 reads at cols < 32; the leaf runs in place, so no
# second buffer), the staged samples (2 ms cols samples of 2 or 4 bytes),
# then one region: the fused chains' owned rows (complex, S/2 span rows of
# pitch cols + 1) or, where larger, a Bluestein leaf's convolutions
# (complex, batch x N: 64 down to 4 of them, the most that fit), and the
# fused chains' round constants (5 cols).
# the planar chain (#3/#4) at n = 512: (m, its cut: the fused chains' cols
# and shared memory with nothing staged; the staged form it was measured
# beside, int16 then f32: cols and shared memory).  Staging adds 2 ms cols
# samples of 2 or 4 bytes to the wire chain's words at the same cols, and
# halves the cols where that passes 227 KB (232,448 bytes).
@pytest.mark.parametrize("m,direct,staged16,staged32", [
    # ms = 192 = 64 x 3: A 3 x 32 x (2 x 64) = 12288, owned rows 4 x 24 x
    # 65, 5 x 64; staged 12288 int16 words more at 64 columns, f32 at 32
    (1536, (64, 4 * (2 * 12288 + 2 * 6240 + 320)),
     (64, 4 * (2 * 12288 + 2 * 6240 + 320 + 12288)),
     (32, 4 * (2 * 6144 + 2 * 3168 + 160 + 12288))),
    # ms = 230 = 2 x 115: A 115 x 2 x 64 = 14720 (P2 = 1: no pad)
    (1840, (64, 4 * (2 * 14720 + 2 * 7540 + 320)),
     (32, 4 * (2 * 7360 + 2 * 3828 + 160 + 7360)),
     (32, 4 * (2 * 7360 + 2 * 3828 + 160 + 14720))),
    # 64 columns direct; staged, 64 int16 columns would need 264,448 bytes
    (2048, (64, 4 * (2 * 16384 + 2 * 8320 + 320)),
     (32, 4 * (2 * 8192 + 2 * 4224 + 160 + 8192)),
     (32, 4 * (2 * 8192 + 2 * 4224 + 160 + 16384))),
    # 16 columns pad the slots: 32 x (16 x 16 + 16)
    (4096, (32, 4 * (2 * 16384 + 2 * 8448 + 160)),
     (16, 4 * (2 * 32 * 272 + 2 * 4352 + 80 + 8192)),
     (16, 4 * (2 * 32 * 272 + 2 * 4352 + 80 + 16384))),
    # a 257-point Bluestein leaf (N = 1024): 8 convolutions fit the owned
    # rows' 2 x 8580 words; staged int16 only at 16 columns, with 16
    # convolutions (32768 words); f32 with 8 (16384 words)
    (4112, (32, 4 * (2 * 16448 + 2 * 8580 + 160)),
     (16, 4 * (2 * 8224 + 80 + 8224 + 2 * 16 * 1024)),
     (16, 4 * (2 * 8224 + 80 + 16448 + 2 * 8 * 1024))),
    # 3 x 43 (N = 128): 64 convolutions, 16384 words, inside the owned
    # rows' 2 x 8580 at 32 columns, past their 2 x 4420 at 16
    (4128, (32, 4 * (2 * 16512 + 2 * 8580 + 160)),
     (16, 4 * (2 * 8256 + 80 + 8256 + 2 * 64 * 128)),
     (16, 4 * (2 * 8256 + 80 + 16512 + 2 * 64 * 128))),
    (4160, (32, 4 * (2 * 16640 + 2 * 8580 + 160)),
     (16, 4 * (2 * 8320 + 2 * 4420 + 80 + 8320)),
     (16, 4 * (2 * 8320 + 2 * 4420 + 80 + 16640))),
    (8192, (16, 4 * (2 * 16896 + 2 * 8704 + 80)),
     (8, 4 * (2 * 32 * 264 + 2 * 4608 + 40 + 8192)),
     (8, 4 * (2 * 32 * 264 + 2 * 4608 + 40 + 16384))),
])
def test_radix_cluster_cut(m, direct, staged16, staged32):
    """The planar chain's cut on the cluster body: the fused chains' (no
    staging buffer, so int16 and f32 alike, and the cut `cluster_phi` is
    summed at), at least the staged form's columns at every m, and twice
    them for int16 at every m but 1536 (where the cap, 64, fits both);
    each within one block's 227 KB with twice the columns over it."""
    for elem, (cols, smem) in ((0, direct), (2, staged16), (4, staged32)):
        g = tfull.cluster_geometry(m, 512, True, elem)
        assert g.cols == cols, elem
        assert tfull.cluster_smem_bytes(m, cols, True, elem) == smem, elem
        assert smem <= tfull.MAX_SMEM_BYTES
        assert (cols == tfull.CLUSTER_MAX_COLS or tfull.cluster_smem_bytes(
            m, 2 * cols, True, elem) > tfull.MAX_SMEM_BYTES), elem
    assert tfull.cluster_geometry(m, 512).cols == direct[0]
    assert direct[0] >= staged16[0] >= staged32[0]
    assert (direct[0] == 2 * staged16[0]) == (m != 1536)


@pytest.mark.parametrize("m,cut,leaf,cols,smem", [
    # ms = 192 = 64 x 3 at 64 columns: pass 1's slots 3 x 32 x (2 x 64) =
    # 12288 in A (no pad at 64 columns), the leaf's 3-point pass in place
    (1536, (192, 64, 3, 32, 2, 24), (3,), (64, 64, 64),
     (4 * (2 * 12288 + 2 * 4 * 24 * 65 + 5 * 64),
      4 * (2 * 12288 + 12288), 4 * (2 * 12288 + 24576))),
    # ms = 230 = 2 x 115: P2 = 1, so pass 1 writes the leaf's slots, its
    # passes 5 and 23 in place; 64 columns as at 2048 but for the f32
    # A-stage
    (1840, (230, 2, 115, 2, 1, 29), (5, 23), (64, 64, 32),
     (4 * (2 * 14720 + 2 * 7540 + 320),
      4 * (2 * 14720 + 14720), 4 * (2 * 7360 + 14720))),
    # ms = 256 = 32 x 8, L = 1: A's slots 32 x (8 cols), pass 2 in place;
    # 64 columns but for the f32 A-stage (64 would need 262,144 bytes)
    (2048, (256, 256, 1, 32, 8, 32), (), (64, 64, 32),
     (4 * (2 * 16384 + 2 * 4 * 32 * 65 + 5 * 64),
      4 * (2 * 16384 + 16384), 4 * (2 * 8192 + 16384))),
    (4096, (512, 512, 1, 32, 16, 64), (), (32, 32, 16),
     (4 * (2 * 16384 + 2 * 4 * 64 * 33 + 5 * 32),
      4 * (2 * 16384 + 16384), 4 * (2 * 32 * (16 * 16 + 16) + 16384))),
    # a prime leaf of 257 points in Bluestein's form (N = 1024): the fused
    # chains' 8 convolutions inside the owned rows, the int16 A-stage's 4
    # (8192 words) beside its staging, the f32 A-stage's 8 at 16 columns
    (4112, (514, 2, 257, 2, 1, 65), (257,), (32, 32, 16),
     (4 * (2 * 16448 + 2 * 8580 + 160),
      4 * (2 * 16448 + 16448 + 2 * 4 * 1024),
      4 * (2 * 8224 + 16448 + 2 * 8 * 1024))),
    # 3 x 43: a 3-point pass, then 43 in Bluestein's form (N = 128: the
    # fused chains' 64 convolutions inside the owned rows; the int16
    # A-stage's 32, 8192 words, beside its staging; the f32 A-stage's 64)
    (4128, (516, 4, 129, 4, 1, 65), (3, 43), (32, 32, 16),
     (4 * (2 * 16512 + 2 * 8580 + 160),
      4 * (2 * 16512 + 16512 + 2 * 32 * 128),
      4 * (2 * 8256 + 16512 + 2 * 64 * 128))),
    (4160, (520, 8, 65, 8, 1, 65), (5, 13), (32, 32, 16),
     (4 * (2 * 16640 + 2 * 8580 + 160),
      4 * (2 * 16640 + 16640), 4 * (2 * 8320 + 16640))),
    # slots 32 x (32 x 16 + 16); the f32 A-stage at 8 columns
    (8192, (1024, 1024, 1, 32, 32, 128), (), (16, 16, 8),
     (4 * (2 * 16896 + 2 * 4 * 128 * 17 + 80),
      4 * (2 * 16896 + 16384), 4 * (2 * 32 * (32 * 8 + 8) + 16384))),
])
def test_cluster_geometry(m, cut, leaf, cols, smem):
    """The cluster cut at n = 512: (ms, P, L, P1, P2, span), the leaf's
    passes, and for the wire chain, the int16 and the f32 A-stage the
    columns a round and a block's shared memory, each within one block's
    227 KB and with twice the columns over it."""
    bodies = ((True, 0), (False, 2), (False, 4))
    for body, want_cols, want_smem in zip(bodies, cols, smem):
        g = tfull.cluster_geometry(m, 512, *body)
        assert (g.ms, g.P, g.L, g.P1, g.P2, g.span) == cut
        assert g.cols == want_cols, body
        assert tfull.cluster_smem_bytes(m, g.cols, *body) == want_smem, body
        assert want_smem <= tfull.MAX_SMEM_BYTES
        assert (g.cols == tfull.CLUSTER_MAX_COLS or tfull.cluster_smem_bytes(
            m, 2 * g.cols, *body) > tfull.MAX_SMEM_BYTES), body
    assert g.S * g.ms == m and g.S == tfull.CLUSTER_SPLIT and g.P * g.L == g.ms
    assert g.P1 * g.P2 == g.P and g.span * tfull.CLUSTER_SPLIT >= g.ms
    assert tfull.leaf_plan(g.L).radices == leaf
    assert tfull.cluster_geometry(m, 512).cols == cols[0]     # the plan's cut
    # a narrow A-stage slab takes fewer columns a round
    assert tfull.cluster_geometry(m, 4, False, 2).cols == 4


def test_cluster_tables_layout():
    """m = 1040 (ms = 130 = 2 x 65): the window, W_P, the leaf's W_ms^(k
    r2), the cluster's W_m^(b k1) and W_8, each the fp64 value cast once;
    then the leaf's plan for 65 = 5 x 13: the header (two passes: R, Lc,
    nq, offset), perm (frequency t = s1 + 5 s2 at 13 s1 + s2), the 5-point
    pass's first points j < 13, its cos/sin of 2 pi t / 5 and twiddles
    W_65^(j s), the 13-point pass's first points 13 blk and cos/sin, no
    twiddle (the last pass)."""
    m = 1040
    consts = PipelineConstants.build(tiny_config(m=m, n=N))
    g = tfull.cluster_geometry(m, N)
    t32 = tfull.cluster_tables(consts)
    t = t32.astype(np.float64)
    assert g.P == 2 and g.L == 65 and g.S == 8
    win = np.asarray(consts.op_a_half[0]).real
    np.testing.assert_array_equal(t[:m], win.astype(np.float32))
    at = m

    def take(count):
        nonlocal at
        v = t[at:at + 2 * count].reshape(count, 2)
        at += 2 * count
        return v[:, 0] + 1j * v[:, 1]

    def w(period, e):
        return np.exp(-2j * np.pi * (np.asarray(e) % period) / period)

    k, r2 = np.meshgrid(np.arange(g.P), np.arange(g.L))
    b, k1 = np.meshgrid(np.arange(8), np.arange(g.ms), indexing="ij")
    for got, want in ((take(g.P), w(g.P, np.arange(g.P))),
                      (take(g.L * g.P), w(g.ms, k * r2).reshape(-1)),
                      (take(8 * g.ms), w(m, b * k1).reshape(-1)),
                      (take(8), w(8, np.arange(8)))):
        assert np.abs(got - want).max() < 1e-7
    plan = t32[at:].view(np.int32)
    assert plan[:2].tolist() == [2, 10]        # npass, perm at 2 + 4 npass
    (r0, lc0, nq0, off0), (r1, lc1, nq1, off1) = plan[2:6], plan[6:10]
    assert (r0, lc0, nq0, r1, lc1, nq1) == (5, 13, 13, 13, 1, 5)
    s1, s2 = np.meshgrid(np.arange(5), np.arange(13), indexing="ij")
    perm = np.zeros(65, np.int64)
    perm[(s1 + 5 * s2).reshape(-1)] = (13 * s1 + s2).reshape(-1)
    assert plan[10:75].tolist() == perm.tolist() and off0 == 76
    assert plan[off0:off0 + 13].tolist() == list(range(13))

    def floats(lo, count):
        return t[at + lo:at + lo + count]

    ang = 2 * np.pi * np.arange(1, 3) / 5
    cs = floats(off0 + 14, 4).reshape(2, 2)
    assert np.abs(cs - np.stack([np.cos(ang), np.sin(ang)], -1)).max() < 1e-7
    tw = floats(off0 + 18, 2 * 13 * 4).reshape(13, 4, 2)
    want = w(65, np.outer(np.arange(13), np.arange(1, 5)))
    assert np.abs(tw[..., 0] + 1j * tw[..., 1] - want).max() < 1e-7
    assert off1 == off0 + 18 + 2 * 13 * 4
    assert plan[off1:off1 + 5].tolist() == [0, 13, 26, 39, 52]
    ang = 2 * np.pi * np.arange(1, 7) / 13
    cs = floats(off1 + 6, 12).reshape(6, 2)
    assert np.abs(cs - np.stack([np.cos(ang), np.sin(ang)], -1)).max() < 1e-7
    assert at + off1 + 18 == t.size


def test_cluster_stage_vs_fp64_dft():
    """At m = 1040, the smallest m the cluster body takes (a 2-point pass and
    a 65-point leaf, 5 x 13): Y within 1e-6 of A_half @ x in float64, salt
    included, at w = 16 and 3."""
    m = 1040
    plan = _plan(m)
    a_half = JConsts.build(jtiny(m=m, n=N), dtype=np.float64).op_a_half
    rng = np.random.default_rng(1040)
    x = rng.integers(-8192, 8192, (3, 2, m, N), dtype=np.int16)
    for w, salt in ((N, None), (3, 5)):
        xs = np.ascontiguousarray(x[..., :w]).astype(np.float64) + (salt or 0)
        yr, yi = tfull.cluster_stage_reference(
            torch.from_numpy(np.ascontiguousarray(x[..., :w])), plan, salt)
        y64 = np.einsum("km,umj->ukj", a_half, xs[:, 0] + 1j * xs[:, 1])
        got = np.stack([yr.numpy(), yi.numpy()], 1)
        assert oracle.relative_l2(np.stack([y64.real, y64.imag], 1), got) < 1e-6


@pytest.mark.parametrize("m", [1840, 8192])
def test_cluster_processors_vs_oracle(m):
    """SectorProcessor(wire_decode="fused") (#7) and a world-size-1
    pallas-seq step (#5 then #6) on the cluster route: products within 2e-4
    of the fp64 oracle and 1e-5 of the planar pallas processor."""
    cfg = tiny_config(m=m, n=N)
    iqs = [oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=s)
           for s in (11, 12)]
    planar = np.stack([_planar(iq) for iq in iqs])
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    pallas = SectorProcessor(cfg, method="pallas", device="cpu")(planar)
    fused = SectorProcessor(cfg, method="pallas", device="cpu",
                            wire_input=True, wire_decode="fused")
    step = build_sharded_processor(cfg, make_mesh(device="cpu"),
                                   method="pallas-seq", device="cpu")
    for what, got in (("fused wire", fused(wires.view("<i4"))),
                      ("pallas-seq", step(planar))):
        _hold(got, pallas, SAME_TOL, (what, "pallas"))
        for b, iq in enumerate(iqs):
            _hold((got[0][b], got[1][b]), oracle.process_sector(
                iq, jtiny(m=m, n=N)), PRODUCT_TOL, (what, b))


def test_astage_matrix_above_8192_vs_jax():
    """m = 8336 (16 x 521, radix 2, M = 4168), which the cluster body
    refuses (its leaf prime 521 needs a Bluestein length of 2048 >
    BLUESTEIN_MAX_N): the A-stage takes the matrix form's plain
    version, within 1e-5 of the float64 FFT of the windowed slab at w = n
    and n/2 (wrp_tpu's radix-2 operator there would be a 540 MB
    interpret-mode contraction); no cluster tables; no launch counted.
    The A-stage's cluster of 16 is held against wrp_tpu at m = 8320 in
    tests/test_torch_cluster16.py."""
    m = REFUSED
    consts = PipelineConstants.build(tiny_config(m=m, n=N))
    plan = tfull.build_plan(consts, "cpu")
    assert (plan.radix == 2 and plan.cluster_t is None
            and tfull.chain_route(m) == "matrix")
    x = _planar(oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=m))
    win = np.asarray(consts.op_a_half[0]).astype(np.complex128).real
    before = (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_MATRIX_LAUNCHES)
    for w in (N, N // 2):
        slab = torch.from_numpy(np.ascontiguousarray(x[..., :w]))
        got = tfull.fused_chain_astage(slab, plan)
        assert torch.equal(got, torch.stack(
            tfull._contract_reference(slab, plan), dim=1))
        z = (slab[:, 0].double().numpy() + 1j * slab[:, 1].double().numpy()
             ) * win[None, :, None]
        y = np.fft.fft(z, axis=1)[:, : m // 2]
        want = np.stack([y.real, y.imag], 1)
        assert oracle.relative_l2(want, got.numpy()) <= ASTAGE_TOL, w
    assert before == (tfull.ASTAGE_LAUNCHES, tfull.ASTAGE_MATRIX_LAUNCHES)


def test_wire_and_seq_matrix_above_8192():
    """m = 8320: the fused wire decode and a world-size-1 pallas-seq step
    take the cluster of 16, as the planar products do (the radix and wire
    entries' CPU results equal cluster_chain_power_reference, the wire's on
    the decoded samples, exactly), so both are held to the two-form bound
    of 1e-5 of them and 2e-4 of the oracle; #8's plain version with offset
    1 and salt 7 equals cluster_chain_power_reference on the decoded,
    salted slab.  m = 8336, which the cluster body refuses: the wire's
    matrix route, #7 and #8 (offset 1, salt 7) equal to
    fused_chain_power_reference on the decoded samples, exactly."""
    m = ABOVE
    cfg = tiny_config(m=m, n=N)
    iqs = [oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=s)
           for s in (21, 22)]
    planar = np.stack([_planar(iq) for iq in iqs])
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    pzdb, pzdr = SectorProcessor(cfg, method="pallas", device="cpu")(planar)
    fused = SectorProcessor(cfg, method="pallas", device="cpu",
                            wire_input=True, wire_decode="fused")
    step = build_sharded_processor(cfg, make_mesh(device="cpu"),
                                   method="pallas-seq", device="cpu")
    for got in (fused(wires.view("<i4")), step(planar)):
        _hold(got, (pzdb, pzdr), SAME_TOL, "vs pallas")
        for b, iq in enumerate(iqs):
            _hold((got[0][b], got[1][b]), oracle.process_sector(
                iq, jtiny(m=m, n=N)), PRODUCT_TOL, b)
    plan = fused._wire_plan
    # the radix and wire entries' CPU results are the cluster route's
    # plain version, the wire's on the decoded samples
    x = torch.from_numpy(planar.reshape(-1, 2, m, N))
    assert torch.equal(tfull.fused_chain_power_radix(x, plan),
                       tfull.cluster_chain_power_reference(x, plan))
    w32 = torch.from_numpy(wires.view("<i4").reshape(2, m, -1).copy())
    assert torch.equal(tfull.fused_chain_power_wire(w32, plan, 3).reshape(6, -1),
                       tfull.cluster_chain_power_reference(x.float(), plan))
    got = tfull.fused_chain_power_wire(w32, plan, 3, offset=1, bs=1, salt=7)
    want = tfull.cluster_chain_power_reference(
        torch.from_numpy(planar[1]).float(), plan, 7)
    assert torch.equal(got.reshape(3, -1), want)

    m = REFUSED
    cfg = tiny_config(m=m, n=N)
    plan = _plan(m)
    assert tfull.chain_route(m) == "matrix" and plan.host_a_half is not None
    iqs = [oracle.synthetic_iq(jtiny(m=m, n=N), kind="noise", seed=s)
           for s in (23, 24)]
    planar = np.stack([_planar(iq) for iq in iqs])
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    x = torch.from_numpy(planar.reshape(-1, 2, m, N)).float()
    w32 = torch.from_numpy(wires.view("<i4").reshape(2, m, -1).copy())
    assert torch.equal(tfull.fused_chain_power_wire(w32, plan, 3).reshape(6, -1),
                       tfull.fused_chain_power_reference(x, plan))
    got = tfull.fused_chain_power_wire(w32, plan, 3, offset=1, bs=1, salt=7)
    assert torch.equal(got.reshape(3, -1),
                       tfull.fused_chain_power_reference(x[3:], plan, 7))
