"""The dense entries' FFT route on the CPU (ops/fullchain.py): for an m
that does not split into radix branches (`radix_for(m) == 1`, e.g. m =
1000 = 8 x 125) the dense entries run the route `chain_route` names (the
FFT-form body up to 1024 cells), whose plain version
`fft_chain_power_reference` they take on the CPU; its geometry and tables at P = 8; the leaf's mixed-radix
Stockham steps (`leaf_fft_reference`) against the L x L DFT in fp64; that
plain version against wrp_tpu's `fused_chain_power` (Pallas interpret
mode) and the fp64 oracle.  The CUDA kernels themselves
(csrc/fft_chain.cuh, csrc/fused_chain_dense.cu) are checked on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fullchain import _adversarial

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.pipeline import stage09_10_products

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

POWER_TOL = 1e-5      # power vs the fp64 oracle
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle
JAX_TOL = 2e-5        # vs wrp_tpu's dense kernel, which drops the bf16 lo*lo term
LEAF_TOL = 1e-12      # the leaf's fp64 steps vs the L x L DFT (max abs / max |X|)


def _plan(m, n):
    return tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")


def _planar(iq):
    return np.stack([iq.real, iq.imag], 1).astype(np.float32)


@pytest.mark.parametrize("m,n,want", [
    (1000, 512, (8, 125, 8, 1, 4, 8)),
    (40, 512, (8, 5, 8, 1, 64, 8)),
    (24, 32, (8, 3, 8, 1, 32, 1)),
    (8, 16, (8, 1, 8, 1, 16, 1)),
])
def test_geometry_at_radix_one(m, n, want):
    """P = 8 register stages (P1 = 8, P2 = 1) and the odd leaf L; for
    L > 1 a round holds half the L = 1 chain's columns (two leaf buffers),
    4 at m = 1000 (two blocks per SM on the card)."""
    assert tfull.radix_for(m) == 1
    g = tfull.fft_geometry(m, n)
    assert (g.P, g.L, g.P1, g.P2, g.cols, g.blocks) == want


@pytest.mark.parametrize("m", [1000, 40, 24])
def test_tables_at_radix_one(m):
    """fft_tables at P = 8: [w_r c (m) | W_8^t | W_m^(k r2) at (r2 P + k) |
    the leaf's L roots W_L^t], the roots in fp32 within 1 ulp of fp64 and
    the quarter turns exact."""
    plan = _plan(m, 16)
    g = plan.fft
    P, L = g.P, g.L
    t = plan.fft_t.numpy().astype(np.float64)
    assert t.shape == (m + 2 * P + 2 * L * P + 2 * L,)
    tw = t[m:m + 2 * P].reshape(P, 2)
    assert tw[0].tolist() == [1.0, 0.0] and tw[2].tolist() == [0.0, -1.0]
    leaf_tw = t[m + 2 * P:m + 2 * P + 2 * L * P].reshape(L, P, 2)
    k, r2 = np.meshgrid(np.arange(P), np.arange(L))
    want = np.exp(-2j * np.pi * k * r2 / m)
    assert np.abs(leaf_tw[..., 0] + 1j * leaf_tw[..., 1] - want).max() < 1e-7
    roots = t[m + 2 * P + 2 * L * P:].reshape(L, 2)
    want = np.exp(-2j * np.pi * np.arange(L) / L)
    assert np.abs(roots[:, 0] + 1j * roots[:, 1] - want).max() < 1e-7
    assert roots[0].tolist() == [1.0, 0.0]


@pytest.mark.parametrize("L", [1, 3, 5, 7, 9, 15, 21, 25, 33, 45, 121, 125])
def test_leaf_steps_equal_the_dft(L):
    """The kernel's leaf as plain torch steps (a Stockham pass per factor:
    5, 3 and 7 first, any other factor whole) in fp64, with fp64 roots,
    against the L x L DFT matrix: max abs error <= LEAF_TOL of max |X|."""
    rem, factors = L, []
    while rem > 1:
        factors.append(tfull.leaf_radix(rem))
        rem //= factors[-1]
    assert int(np.prod(factors)) == L
    assert all(f in (3, 5, 7) for f in factors[:-1])
    rng = np.random.default_rng(L)
    z = rng.standard_normal((2, L, 3)) + 1j * rng.standard_normal((2, L, 3))
    roots = torch.from_numpy(np.exp(-2j * np.pi * np.arange(L) / L))
    got = tfull.leaf_fft_reference(torch.from_numpy(z), roots).numpy()
    dft = np.exp(-2j * np.pi * np.outer(np.arange(L), np.arange(L)) / L)
    want = np.einsum("kr,brc->bkc", dft, z)
    assert np.abs(got - want).max() <= LEAF_TOL * np.abs(want).max()


@pytest.mark.parametrize("m,body", [
    (1000, "register"), (40, "register"), (24, "register"), (8, "register"),
    (2, "register"), (6, "register"), (1024, "register"),
    # 4 x 275 and 2 x 513: split across 4 and 2 blocks; 4096 is a radix m
    (1100, "cluster"), (4096, "cluster"), (1026, "cluster"),
    (999, "matrix"), (7, "matrix"), (4100, "matrix"),
    # 2 x 1025: over CLUSTER_MAX_MS a block, the long-ray body's one form;
    # 2 x 521: a leaf prime whose Bluestein length would be 2048
    (2050, "long"), (4094, "long"), (1042, "matrix"),
])
def test_dense_body_from_m_alone(m, body):
    """The dense entries' route, m's alone (`chain_route`): the register
    body for every even m <= 1024, the cluster body for m = S x odd up to
    1024 S (S = 2, 4, 8), the long-ray form for m = 2 x odd in (2048,
    4096], the matrix kernel otherwise; a plan builds the FFT tables
    exactly for the m that take the FFT form and the cluster tables for
    those the cluster body takes."""
    fft = body in ("register", "long")
    assert tfull.chain_route(m) == body
    assert tfull.fft_takes(m) == fft
    assert tfull.fft_long(m) == (body == "long")
    if m % 2 == 0 and m <= 4100 and m >= 8:
        plan = _plan(m, 16)
        assert (plan.fft_t is not None) == fft
        assert (plan.cluster_t is not None) == (body == "cluster")


@pytest.mark.parametrize("m,n", [(1000, 32), (40, 32), (24, 16), (8, 16)])
@pytest.mark.parametrize("kind", ["noise", "clip-bin"])
def test_fft_route_vs_jax_dense_kernel_and_oracle(m, n, kind):
    """The dense entry's CPU path at radix-1 m, the FFT-form plain version,
    against wrp_tpu's dense kernel (interpret mode) < JAX_TOL and the fp64
    oracle: power < POWER_TOL, zdb and zdr < PRODUCT_TOL.  clip-bin: the
    Doppler energy in a clipped bin, where the Parseval subtraction
    cancels hard."""
    cfg = tiny_config(m=m, n=n)
    jcfg = jtiny(m=m, n=n)
    iq = (oracle.synthetic_iq(jcfg, kind="noise", seed=m) if kind == "noise"
          else _adversarial(cfg, seed=m))
    planar = _planar(iq)
    plan = _plan(m, n)
    before = (tfull.DENSE_LAUNCHES, tfull.DENSE_FFT_LAUNCHES,
              tfull.DENSE_MATRIX_LAUNCHES)
    got = tfull.fused_chain_power_dense(torch.from_numpy(planar), plan).numpy()
    assert before == (tfull.DENSE_LAUNCHES, tfull.DENSE_FFT_LAUNCHES,
                      tfull.DENSE_MATRIX_LAUNCHES)
    assert np.array_equal(got, tfull.fft_chain_power_reference(
        torch.from_numpy(planar), plan).numpy())
    consts = JConsts.build(jcfg)
    want = np.asarray(jfull.fused_chain_power(
        jnp.asarray(planar),
        jnp.asarray(jfull.split_operator_host(consts.op_a_half)),
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True))
    pow64 = oracle.channel_power(iq, jcfg)
    for c in range(3):
        assert oracle.relative_l2(want[c], got[c]) < JAX_TOL, c
        assert oracle.relative_l2(pow64[c], got[c]) < POWER_TOL, c
    gain = torch.from_numpy(PipelineConstants.build(cfg).gain)
    zdb, zdr = stage09_10_products(torch.from_numpy(got[0]),
                                   torch.from_numpy(got[1]), gain)
    zdb64, zdr64 = oracle.stage09_10_products(pow64[0], pow64[1], jcfg)
    assert oracle.relative_l2(zdb64, zdb.numpy()) < PRODUCT_TOL
    assert oracle.relative_l2(zdr64, zdr.numpy()) < PRODUCT_TOL


def test_offset_entry_takes_the_route():
    """fused_chain_power_at on the CPU: the FFT-form plain version of its
    slab at m = 40 (bit for bit), the matrix form's at m = 4100; no
    counter moves."""
    for m, plain in ((40, tfull.fft_chain_power_reference),
                     (4100, tfull.fused_chain_power_reference)):
        plan = _plan(m, 16)
        rng = np.random.default_rng(m)
        x = torch.from_numpy(rng.integers(-8192, 8192, (9, 2, m, 16))
                             .astype(np.int16))
        before = (tfull.DENSE_OFFSET_LAUNCHES, tfull.DENSE_FFT_LAUNCHES,
                  tfull.DENSE_MATRIX_LAUNCHES)
        got = tfull.fused_chain_power_at(x, 3, 6, plan)
        assert torch.equal(got, plain(x[3:9], plan)), m
        assert before == (tfull.DENSE_OFFSET_LAUNCHES, tfull.DENSE_FFT_LAUNCHES,
                          tfull.DENSE_MATRIX_LAUNCHES)


def test_matrix_route_at_m_over_1024_vs_oracle():
    """m = 4100 > 4096 (over 1024, and over the FFT-form body's 4096): the
    matrix form's plain version (the dense A_half), no FFT tables; vs the
    fp64 oracle < POWER_TOL."""
    m, n = 4100, 16
    plan = _plan(m, n)
    assert tfull.chain_route(m) == "matrix" and plan.fft_t is None
    iq = oracle.synthetic_iq(jtiny(m=m, n=n), kind="noise", seed=4)
    got = tfull.fused_chain_power_dense(torch.from_numpy(_planar(iq)),
                                        plan).numpy()
    pow64 = oracle.channel_power(iq, jtiny(m=m, n=n))
    for c in range(3):
        assert oracle.relative_l2(pow64[c], got[c]) < POWER_TOL, c
    with pytest.raises(ValueError, match="FFT_MAX_M = 4096"):
        tfull.fft_chain_power_reference(torch.zeros(1, 2, m, n), plan)
