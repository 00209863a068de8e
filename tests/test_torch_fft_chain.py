"""The FFT-form chain kernels' plain torch versions (ops/fullchain.py
`fft_stage_reference`, `merged_epilogue_reference`, through the wrappers'
CPU paths) against wrp_tpu's kernels in Pallas interpret mode and the fp64
oracle; the merged epilogue's exactness under a strong DC line; the radix
method through both CLIs.  The CUDA kernels themselves (csrc/fft_chain.cuh)
are checked on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import cli as jcli
from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops import device_codec as jdc
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch import cli
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants, hamming_factors
from wrp_tpu_torch.io import codec
from wrp_tpu_torch.io.files import read_ascii_matrix
from wrp_tpu_torch.ops import device_codec as tdc
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.pipeline import stage09_10_products, stage_b_parseval

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

POWER_TOL = 1e-5      # power vs the fp64 oracle
PRODUCT_TOL = 2e-4    # zdb, zdr vs the fp64 oracle
JAX_TOL = 2e-5        # vs wrp_tpu's kernels, which drop the bf16 lo*lo term


def _plan(m, n):
    return tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")


def _planar(iq):
    return np.stack([iq.real, iq.imag], 1).astype(np.float32)


def _jax_radix(planar, m, n, **kw):
    """wrp_tpu's radix kernel (interpret mode) on radix-ordered rows."""
    consts = JConsts.build(jtiny(m=m, n=n))
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(m, radix)
    return np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(planar[:, :, order, :]), jnp.asarray(a_np), fac,
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True, **kw))


def _check_vs_oracle(got, iq, m, n):
    """Power [C, m/2] vs the fp64 oracle, then zdb/zdr."""
    cfg = jtiny(m=m, n=n)
    pow64 = oracle.channel_power(iq, cfg)
    for c in range(got.shape[0]):
        assert oracle.relative_l2(pow64[c], got[c]) < POWER_TOL, c
    gain = torch.from_numpy(PipelineConstants.build(tiny_config(m=m, n=n)).gain)
    zdb, zdr = stage09_10_products(torch.from_numpy(got[0]),
                                   torch.from_numpy(got[1]), gain)
    zdb64, zdr64 = oracle.stage09_10_products(pow64[0], pow64[1], cfg)
    assert oracle.relative_l2(zdb64, zdb.numpy()) < PRODUCT_TOL
    assert oracle.relative_l2(zdr64, zdr.numpy()) < PRODUCT_TOL


@pytest.mark.parametrize("m,n", [(32, 128), (64, 256), (128, 256), (96, 192)])
def test_fused_radix_matches_jax_kernel_and_oracle(m, n):
    """The radix entry's plain version at power-of-two m and at m = 96 =
    32 x 3 (an L = 3 leaf after the power-of-two stages), with several
    blocks of round-robin chunks to merge."""
    plan = _plan(m, n)
    g = plan.fft
    assert g.P * g.L == m and g.L == (3 if m == 96 else 1)
    assert g.blocks > 1
    iq = oracle.synthetic_iq(jtiny(m=m, n=n), kind="noise", seed=m + n)
    planar = _planar(iq)
    got = tfull.fused_chain_power_radix(torch.from_numpy(planar), plan).numpy()
    want = _jax_radix(planar, m, n)
    for c in range(3):
        assert oracle.relative_l2(want[c], got[c]) < JAX_TOL, c
    _check_vs_oracle(got, iq, m, n)


def test_salted_offset_entry_matches_jax_on_salted_samples():
    """The salted offset entry's plain version vs wrp_tpu's kernel on
    x + salt (wrp_tpu ignores the salt in interpret mode)."""
    m, n, bc, salt = 64, 256, 6, 7
    rng = np.random.default_rng(11)
    x = rng.integers(-8192, 8192, (3 * bc, 2, m, n), dtype=np.int16)
    plan = _plan(m, n)
    got = tfull.fused_chain_power_radix(torch.from_numpy(x), plan, offset=bc,
                                        bc=bc, salt=salt).numpy()
    want = _jax_radix(x[bc:2 * bc].astype(np.float32) + np.float32(salt), m, n)
    for w, g_ in zip(want, got):
        assert oracle.relative_l2(w, g_) < JAX_TOL
    # salt 0 adds nothing
    assert np.array_equal(
        tfull.fused_chain_power_radix(torch.from_numpy(x), plan, offset=bc,
                                      bc=bc, salt=0).numpy(),
        tfull.fused_chain_power_radix(torch.from_numpy(x[bc:2 * bc]),
                                      plan).numpy())


@pytest.mark.parametrize("channels", [2, 3])
def test_wire_chain_matches_jax_and_oracle(channels):
    m, n = 128, 256
    cfg = tiny_config(m=m, n=n, channels=channels)
    jcfg = jtiny(m=m, n=n, channels=channels)
    iqs = [oracle.synthetic_iq(jtiny(m=m, n=n), kind="noise", seed=40 + s)
           [:channels] for s in range(2)]
    wires = np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                      for iq in iqs])
    plan = tfull.build_plan(PipelineConstants.build(cfg), "cpu")
    got = tfull.fused_chain_power_wire(
        tdc.wire_words_i32(torch.from_numpy(wires), cfg), plan,
        channels).numpy()
    consts = JConsts.build(jcfg)
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    wd_il, ph_il = jfull.wire_lane_consts(consts, channels)
    want = np.asarray(jfull.fused_chain_power_wire(
        jdc.wire_words_i32(jnp.asarray(wires), jcfg, radix=radix),
        jnp.asarray(a_np), fac, jnp.asarray(wd_il), jnp.asarray(ph_il),
        channels, interpret=True))
    assert got.shape == want.shape == (2, channels, m // 2)
    for s in range(2):
        for c in range(channels):
            assert oracle.relative_l2(want[s, c], got[s, c]) < JAX_TOL
        pow64 = oracle.channel_power(iqs[s], jcfg)
        for c in range(channels):
            assert oracle.relative_l2(pow64[c], got[s, c]) < POWER_TOL


@pytest.mark.parametrize("ranks", [1, 2])
def test_astage_matches_jax_and_float64(ranks):
    """The A-stage's plain version on one rank's pulse slab (w = n / ranks)
    vs wrp_tpu's A-stage kernel and Y = A_half @ x in float64."""
    m, n = 128, 128
    w = n // ranks
    rng = np.random.default_rng(ranks)
    x = rng.integers(-8192, 8192, (3, 2, m, w), dtype=np.int16)
    y = tfull.fused_chain_astage(torch.from_numpy(x), _plan(m, n)).numpy()
    consts = JConsts.build(jtiny(m=m, n=n))
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(m, radix)
    want = np.asarray(jfull.fused_chain_astage(
        jnp.asarray(x.astype(np.float32)[:, :, order, :]), jnp.asarray(a_np),
        fac, interpret=True))
    a_half = JConsts.build(jtiny(m=m, n=n), dtype=np.float64).op_a_half
    y64 = np.einsum("km,umj->ukj", a_half, x[:, 0] + 1j * x[:, 1])
    assert y.shape == want.shape == (3, 2, m // 2, w)
    assert oracle.relative_l2(want, y) < JAX_TOL
    assert oracle.relative_l2(np.stack([y64.real, y64.imag], 1), y) < POWER_TOL


def _strong_dc(m, n, seed=5, amp=3.0e4, noise=8):
    """A zero-Doppler clutter line near int16 full scale (3e4 counts at its
    peak) at range bin m/8, shaped by 1/w_d so that q = Y w_d is nearly
    constant along the pulses, over uniform noise of a few counts."""
    cfg = tiny_config(m=m, n=n)
    _, wd, _ = hamming_factors(cfg)
    rng = np.random.default_rng(seed)
    r = np.arange(m)[:, None]
    ph = rng.uniform(0, 2 * np.pi, (3, 1, 1))
    line = amp * (wd.min() / wd)[None, :]
    xi = np.round(line * np.cos(2 * np.pi * r / 8 + ph))
    xq = np.round(line * np.sin(2 * np.pi * r / 8 + ph))
    xi = xi + rng.integers(-noise, noise + 1, (3, m, n))
    xq = xq + rng.integers(-noise, noise + 1, (3, m, n))
    assert np.abs(xi).max() < 2 ** 15
    return xi + 1j * xq


def _one_pass(yr, yi, plan):
    """The cancelling one-pass form n sum|q|^2 - |sum q|^2 - |q.f_k|^2."""
    q = torch.complex(yr * plan.wd, yi * plan.wd)
    pw = q.shape[-1] * (q.abs() ** 2).sum(-1) - q.sum(-1).abs() ** 2
    dr, di = q.real @ plan.phasors.T, q.imag @ plan.phasors.T
    for c, s in ((0, 1), (2, 3)):
        pw = pw - ((dr[..., c] - di[..., s]) ** 2 + (dr[..., s] + di[..., c]) ** 2)
    return pw


def test_strong_dc_merged_epilogue_matches_two_pass():
    """At the production geometry (8 blocks of 8 rounds of 8 columns): under
    a clutter line near int16 full scale the merged epilogue matches the
    explicit two-pass epilogue on the same Y within 1e-5, and the fp64
    oracle too, while the one-pass form misses that bound by far: the
    input is one the merge must get right."""
    m, n = 1024, 512
    plan = _plan(m, n)
    assert (plan.fft.cols, plan.fft.blocks) == (8, 8)
    iq = _strong_dc(m, n)
    x = torch.from_numpy(_planar(iq).astype(np.int16))
    yr, yi = tfull.fft_stage_reference(x, plan)
    two_pass = stage_b_parseval(yr.double(), yi.double(), plan.wd.double(),
                                plan.phasors.double()).numpy()
    merged = tfull.merged_epilogue_reference(yr, yi, plan).numpy()
    one_pass = _one_pass(yr, yi, plan).numpy()
    for c in range(3):
        assert oracle.relative_l2(two_pass[c], merged[c]) < POWER_TOL, c
        assert oracle.relative_l2(two_pass[c], one_pass[c]) > 100 * POWER_TOL, c
    assert np.array_equal(merged, tfull.fused_chain_power_radix(x, plan).numpy())
    _check_vs_oracle(merged, iq, m, n)


@pytest.mark.parametrize("kind,tol", [("noise", 1e-6), ("strong-dc", POWER_TOL)])
def test_merge_is_independent_of_chunking(kind, tol):
    """Chunks of 1, 8 and n columns (and 1 or 8 blocks) give the same
    power as the two-pass form in float64 on the same Y: the merge is
    exact algebra, not an approximation (under the clutter line, q = Y w_d
    rounded to float32 alone moves the power by ~1e-6)."""
    m, n = 128, 256
    plan = _plan(m, n)
    iq = (oracle.synthetic_iq(jtiny(m=m, n=n), kind="noise", seed=9)
          if kind == "noise" else _strong_dc(m, n))
    x = torch.from_numpy(_planar(iq))
    yr, yi = tfull.fft_stage_reference(x, plan)
    base = stage_b_parseval(yr.double(), yi.double(), plan.wd.double(),
                            plan.phasors.double()).numpy()
    for cols, blocks in ((1, 8), (8, 8), (8, 1), (n, 1)):
        got = tfull.merged_epilogue_reference(yr, yi, plan, cols, blocks).numpy()
        for c in range(3):
            assert oracle.relative_l2(base[c], got[c]) < tol, (cols, blocks, c)


def test_geometry_and_tables():
    """The kernels' cut of each geometry, and the table's exact roots."""
    g = tfull.fft_geometry(1024, 512)
    assert (g.P, g.L, g.P1, g.P2, g.cols, g.blocks) == (1024, 1, 32, 32, 8, 8)
    g = tfull.fft_geometry(960, 512)
    assert (g.P, g.L, g.P1, g.P2) == (64, 15, 32, 2)
    assert tfull.fft_geometry(1024, 20).blocks == 3
    with pytest.raises(ValueError, match="m <= 1024"):
        tfull.fft_geometry(2048, 512)
    plan = _plan(96, 64)
    tw = plan.fft_t[96:96 + 64].reshape(32, 2)
    assert tw[0].tolist() == [1.0, 0.0] and tw[8].tolist() == [0.0, -1.0]
    assert tfull.build_plan(PipelineConstants.build(tiny_config(m=40)),
                            "cpu").fft_t is None


def test_cli_radix_matches_jax_cli_and_oracle(tmp_path):
    """`process --method radix` is offered by the port's CLI, as by
    wrp_tpu's, and both agree with the fp64 oracle within 2e-4."""
    out, jout = tmp_path / "torch.out", tmp_path / "jax.out"
    assert cli.main(["process", "--input", "synthetic", "--device", "cpu",
                     "--method", "radix", "--output", str(out)]) == 0
    assert jcli.main(["process", "--input", "synthetic", "--method", "radix",
                      "--output", str(jout)]) == 0
    got, want = read_ascii_matrix(out), np.loadtxt(jout)
    zdb64, zdr64 = oracle.process_sector(oracle.synthetic_iq(kind="noise",
                                                             seed=0))
    # the ASCII outputs keep 6 significant digits (format "g")
    for col, ref in ((0, zdb64), (1, zdr64)):
        assert oracle.relative_l2(ref, got[:, col]) < PRODUCT_TOL + 1e-6
        assert oracle.relative_l2(ref, want[:, col]) < PRODUCT_TOL + 1e-6
        assert oracle.relative_l2(want[:, col], got[:, col]) < PRODUCT_TOL + 1e-6
    assert got[0, 0] == want[0, 0] == -np.inf
