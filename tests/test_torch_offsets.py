"""The benchmark's offset/salt entries of the fused-chain kernels on the
CPU: their plain versions against wrp_tpu's entries (Pallas interpret mode),
the slab arithmetic and the refusals.  wrp_tpu ignores the salt in
interpret mode, so a salted result is held against wrp_tpu's unsalted
kernel on the salted samples (x + salt in float32).  The CUDA kernels
themselves are checked on the card by chip_smoke.py (phase_offsets)."""

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

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

TOL = 2e-5          # wrp_tpu's kernels drop the bf16 lo*lo term (~2^-17)
SLABS, SECTORS = 3, 2


def _staged(m, n, seed=0):
    """SLABS slabs of SECTORS sectors as planar int16 [SLABS*SECTORS*C, 2,
    m, n] (the bench's staging, flattened to channel-sectors)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8192, 8192, (SLABS * SECTORS * 3, 2, m, n),
                        dtype=np.int16)


def _close(want, got):
    want = np.asarray(want).reshape(-1, got.shape[-1])
    got = got.reshape(-1, got.shape[-1])
    return max(oracle.relative_l2(w, g) for w, g in zip(want, got))


def _jax_radix(planar: np.ndarray, m, n, **kw) -> np.ndarray:
    """wrp_tpu's radix kernel (interpret mode) on radix-ordered rows."""
    consts = JConsts.build(jtiny(m=m, n=n))
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(m, radix)
    return np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(planar[:, :, order, :]), jnp.asarray(a_np), fac,
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True, **kw))


@pytest.mark.parametrize("slab", range(SLABS))
def test_radix_offset_matches_jax_offset_entry(slab):
    m, n = 64, 32
    x = _staged(m, n)
    bc = SECTORS * 3
    plan = tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")
    before = tfull.RADIX_OFFSET_LAUNCHES
    got = tfull.fused_chain_power_radix(torch.from_numpy(x), plan,
                                        offset=slab * bc, bc=bc).numpy()
    assert tfull.RADIX_OFFSET_LAUNCHES == before     # the CPU launches nothing
    assert got.shape == (bc, m // 2)
    want = _jax_radix(x, m, n, offset=slab * bc, bc=bc)
    assert _close(want, got) < TOL
    # the same as the plain entry on the slab, bit for bit
    assert np.array_equal(got, tfull.fused_chain_power_radix(
        torch.from_numpy(x[slab * bc:(slab + 1) * bc]), plan).numpy())


@pytest.mark.parametrize("salt", [0, 7, 95, -3])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_radix_salt_matches_jax_on_salted_samples(salt, dtype):
    m, n = 64, 32
    x = _staged(m, n, seed=1).astype(dtype)
    bc = SECTORS * 3
    plan = tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")
    got = tfull.fused_chain_power_radix(torch.from_numpy(x), plan, offset=bc,
                                        bc=bc, salt=salt).numpy()
    want = _jax_radix(x[bc:2 * bc].astype(np.float32) + np.float32(salt), m, n)
    assert _close(want, got) < TOL
    if salt == 0:
        assert np.array_equal(got, tfull.fused_chain_power_radix(
            torch.from_numpy(x), plan, offset=bc, bc=bc).numpy())


def _wire_staged(cfg, seed=2):
    rng = np.random.default_rng(seed)
    iqs = [rng.integers(-8192, 8192, cfg.sector_shape)
           + 1j * rng.integers(-8192, 8192, cfg.sector_shape)
           for _ in range(SLABS * SECTORS)]
    return np.stack([np.frombuffer(codec.encode_iq(iq, cfg), np.uint8)
                     for iq in iqs])


@pytest.mark.parametrize("salt", [None, 0, 7])
@pytest.mark.parametrize("channels", [3, 2])
def test_wire_offset_in_sectors_matches_jax(salt, channels):
    """The wire entry's offset counts SECTORS: slab k starts at sector
    k * SECTORS.  Unsalted vs wrp_tpu's wire offset entry; salted vs
    wrp_tpu's decode, + salt, then its radix kernel per channel."""
    cfg = tiny_config(m=128, n=64, channels=channels)
    jcfg = jtiny(m=128, n=64, channels=channels)
    wires = _wire_staged(cfg)
    plan = tfull.build_plan(PipelineConstants.build(cfg), "cpu")
    w32 = tdc.wire_words_i32(torch.from_numpy(wires), cfg)
    before = tfull.WIRE_OFFSET_LAUNCHES
    got = tfull.fused_chain_power_wire(w32, plan, channels, offset=SECTORS,
                                       bs=SECTORS, salt=salt).numpy()
    assert tfull.WIRE_OFFSET_LAUNCHES == before
    assert got.shape == (SECTORS, channels, 64)
    unsalted = tfull.fused_chain_power_wire(w32, plan, channels,
                                            offset=SECTORS, bs=SECTORS).numpy()
    assert np.array_equal(unsalted, tfull.fused_chain_power_wire(
        w32[SECTORS:2 * SECTORS].contiguous(), plan, channels).numpy())
    if salt == 0:
        assert np.array_equal(got, unsalted)
    consts = JConsts.build(jcfg)
    radix = jfull.radix_for(cfg.m)
    if salt is None:
        a_np, fac = jfull.radix_plan_host(consts, radix)
        wd_il, ph_il = jfull.wire_lane_consts(consts, channels)
        want = np.asarray(jfull.fused_chain_power_wire(
            jdc.wire_words_i32(jnp.asarray(wires), jcfg, radix=radix),
            jnp.asarray(a_np), fac, jnp.asarray(wd_il), jnp.asarray(ph_il),
            channels, interpret=True, offset=SECTORS, bs=SECTORS))
    else:
        jw = np.asarray(jdc.wire_words_i32(
            jnp.asarray(wires[SECTORS:2 * SECTORS]), jcfg))
        i_, q_ = (np.asarray(v) for v in jfull.decode_words_iq(jnp.asarray(jw)))
        planar = np.stack([i_, q_], 1).reshape(SECTORS, 2, 128, 64, channels)
        planar = planar.transpose(0, 4, 1, 2, 3).reshape(-1, 2, 128, 64)
        want = _jax_radix(planar.astype(np.float32) + np.float32(salt),
                          128, 64)
    assert _close(want, got) < TOL


@pytest.mark.parametrize("slab", [0, 2])
def test_dense_offset_matches_jax_fused_chain_power_at(slab):
    """m = 40 does not split into radix branches: fused_chain_power_at vs
    wrp_tpu's, offset in channel-sectors, no salt."""
    m, n = 40, 32
    assert tfull.radix_for(m) == 1
    x = _staged(m, n, seed=3)
    bc = SECTORS * 3
    plan = tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")
    before = tfull.DENSE_OFFSET_LAUNCHES
    got = tfull.fused_chain_power_at(torch.from_numpy(x), slab * bc, bc,
                                     plan).numpy()
    assert tfull.DENSE_OFFSET_LAUNCHES == before
    consts = JConsts.build(jtiny(m=m, n=n))
    want = np.asarray(jfull.fused_chain_power_at(
        jnp.asarray(x), jnp.int32(slab * bc), bc,
        jnp.asarray(jfull.split_operator_host(consts.op_a_half)),
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True))
    assert _close(want, got) < TOL
    assert np.array_equal(got, tfull.fused_chain_power_dense(
        torch.from_numpy(x[slab * bc:(slab + 1) * bc]), plan).numpy())


def test_offset_out_of_range_and_misuse_raise():
    """An offset whose slab leaves the staged array raises (wrp_tpu clamps
    it in interpret mode and would read past the buffer compiled); so do a
    salt or a count without an offset, an offset without a count, and a
    salt beyond int32."""
    m, n = 64, 32
    x = torch.from_numpy(_staged(m, n))
    units, bc = x.shape[0], SECTORS * 3
    plan = tfull.build_plan(PipelineConstants.build(tiny_config(m=m, n=n)),
                            "cpu")
    radix = tfull.fused_chain_power_radix
    for off in (units - bc + 1, -1, units):
        with pytest.raises(ValueError, match="outside"):
            radix(x, plan, offset=off, bc=bc)
    assert radix(x, plan, offset=units - bc, bc=bc).shape == (bc, m // 2)
    with pytest.raises(ValueError, match="apply with an offset"):
        radix(x, plan, salt=3)
    with pytest.raises(ValueError, match="apply with an offset"):
        radix(x, plan, bc=bc)
    with pytest.raises(ValueError, match="needs bc"):
        radix(x, plan, offset=0)
    with pytest.raises(ValueError, match="int32"):
        radix(x, plan, offset=0, bc=bc, salt=2 ** 31)

    cfg = tiny_config(m=128, n=64)
    wplan = tfull.build_plan(PipelineConstants.build(cfg), "cpu")
    w32 = tdc.wire_words_i32(torch.from_numpy(_wire_staged(cfg)), cfg)
    with pytest.raises(ValueError, match="outside"):
        tfull.fused_chain_power_wire(w32, wplan, 3, offset=SLABS * SECTORS - 1,
                                     bs=SECTORS)
    with pytest.raises(ValueError, match="needs bs"):
        tfull.fused_chain_power_wire(w32, wplan, 3, offset=0)

    dcfg = tiny_config(m=40, n=32)
    dplan = tfull.build_plan(PipelineConstants.build(dcfg), "cpu")
    xd = torch.from_numpy(_staged(40, 32))
    with pytest.raises(ValueError, match="outside"):
        tfull.fused_chain_power_at(xd, xd.shape[0] - bc + 1, bc, dplan)
    with pytest.raises(ValueError, match="radix-1 plan"):
        tfull.fused_chain_power_at(x, 0, bc, plan)
