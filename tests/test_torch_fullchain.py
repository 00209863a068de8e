"""The fused chain's plain torch version (ops/fullchain.py) against
wrp_tpu's radix kernel in Pallas interpret mode and the fp64 oracle, and
the wrapper's device contract.  The CUDA kernel itself is checked on the
card by chip_smoke.py (phase 3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch import constants as tconst
from wrp_tpu_torch.config import DEFAULT_CONFIG, tiny_config
from wrp_tpu_torch.ops import fullchain as tfull
from wrp_tpu_torch.pipeline import SectorProcessor

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)


def _jax_radix_power(planar: np.ndarray, m: int, n: int) -> np.ndarray:
    """wrp_tpu's flagship kernel (interpret mode) on radix-ordered rows."""
    consts = JConsts.build(jtiny(m=m, n=n))
    radix = jfull.radix_for(m)
    a_np, fac = jfull.radix_plan_host(consts, radix)
    order = jfull.radix_row_order(m, radix)
    return np.asarray(jfull.fused_chain_power_radix(
        jnp.asarray(planar[:, :, order, :]), jnp.asarray(a_np), fac,
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True))


def _torch_power(planar: np.ndarray, cfg) -> np.ndarray:
    plan = tfull.build_plan(tconst.PipelineConstants.build(cfg), "cpu")
    return tfull.fused_chain_power_reference(torch.from_numpy(planar),
                                             plan).numpy()


def _adversarial(cfg, seed=3):
    """Doppler energy in a clipped bin (tests/test_pallas.py:186-197)."""
    m, n = cfg.m, cfg.n
    _, wd, _ = tconst.hamming_factors(cfg)
    rng = np.random.default_rng(seed)
    j = np.arange(n)
    k = n // 2 - 2
    ph0 = rng.uniform(0, 2 * np.pi, (cfg.num_channels, m, 1))
    base = np.cos(2 * np.pi * k * j / n + ph0) / wd[None, None, :]
    adv = (6000 * base / np.abs(base).max()
           + 1j * rng.integers(-50, 50, (cfg.num_channels, m, n)))
    return np.round(adv.real) + 1j * np.round(adv.imag)


@pytest.mark.parametrize("m,n,radix", [(128, 64, 8), (32, 16, 4), (16, 16, 2)])
@pytest.mark.parametrize("kind", ["noise", "clip-bin"])
def test_reference_vs_jax_kernel_and_oracle(m, n, radix, kind):
    """Natural-order rows through the port's plain version vs radix-
    ordered rows through wrp_tpu's kernel: < 2e-5 (JAX drops the bf16
    lo*lo term, ~2^-17 relative); the port vs the fp64 oracle < 1e-5."""
    cfg = tiny_config(m=m, n=n)
    assert tfull.radix_for(m) == radix
    iq = (oracle.synthetic_iq(jtiny(m=m, n=n), kind="noise", seed=m)
          if kind == "noise" else _adversarial(cfg))
    planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    pow64 = oracle.channel_power(iq, jtiny(m=m, n=n))
    got = _torch_power(planar, cfg)
    want = _jax_radix_power(planar, m, n)
    assert got.shape == want.shape == (cfg.num_channels, m // 2)
    for c in range(cfg.num_channels):
        assert oracle.relative_l2(want[c], got[c]) < 2e-5, c
        assert oracle.relative_l2(pow64[c], got[c]) < 1e-5, c
        # the JAX suite's own oracle bounds for this kernel
        # (tests/test_pallas.py:117, :208)
        assert oracle.relative_l2(pow64[c], want[c]) < (
            1e-5 if kind == "noise" else 2e-5), c


def test_dense_reference_when_radix_is_one():
    """m with radix_for(m) == 1 takes the dense A_half in the plain
    version; it matches wrp_tpu's dense kernel and the oracle."""
    m, n = 8, 16
    cfg = tiny_config(m=m, n=n)
    assert tfull.radix_for(m) == 1
    iq = oracle.synthetic_iq(jtiny(m=m, n=n), kind="noise", seed=2)
    planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    got = _torch_power(planar, cfg)
    consts = JConsts.build(jtiny(m=m, n=n))
    want = np.asarray(jfull.fused_chain_power(
        jnp.asarray(planar), jnp.asarray(jfull.split_operator_host(
            consts.op_a_half)),
        jnp.asarray(consts.wd), jnp.asarray(consts.clip_phasors),
        interpret=True))
    pow64 = oracle.channel_power(iq, jtiny(m=m, n=n))
    assert oracle.relative_l2(want, got) < 2e-5
    assert oracle.relative_l2(pow64, got) < 1e-5


def test_int16_input_equals_f32_input():
    cfg = tiny_config(m=64, n=32)
    plan = tfull.build_plan(tconst.PipelineConstants.build(cfg), "cpu")
    x = np.random.default_rng(0).integers(-8192, 8192, (6, 2, 64, 32))
    a = tfull.fused_chain_power_radix(torch.from_numpy(x.astype(np.int16)),
                                      plan)
    b = tfull.fused_chain_power_radix(torch.from_numpy(x.astype(np.float32)),
                                      plan)
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a, b)


def test_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor goes to the plain version and launches nothing; any
    other non-CUDA device raises."""
    cfg = tiny_config(m=64, n=32)
    plan = tfull.build_plan(tconst.PipelineConstants.build(cfg), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -8192, 8192, (3, 2, 64, 32)).astype(np.int16))
    before = tfull.LAUNCHES
    assert torch.equal(tfull.fused_chain_power_radix(x, plan),
                       tfull.fft_chain_power_reference(x, plan))
    assert tfull.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        tfull.fused_chain_power_radix(x.to("meta"), plan)


def test_plan_layouts_and_tiles():
    cfg = tiny_config(m=128, n=64)
    plan = tfull.build_plan(tconst.PipelineConstants.build(cfg), "cpu")
    R, M = 8, 16
    assert tuple(plan.a.shape) == (R, 2, M, M)
    assert tuple(plan.a_kernel.shape) == (R, M, M, 2)
    assert tuple(plan.fac_t.shape) == (R // 2, R, 2)
    # a_kernel[p, q, t] = (re, im) of A_p[t, q]
    assert torch.equal(plan.a_kernel[:, :, :, 0], plan.a[:, 0].transpose(1, 2))
    assert torch.equal(plan.a_kernel[:, :, :, 1], plan.a[:, 1].transpose(1, 2))
    # combine factors: exact 4th roots stay exact
    assert plan.fac[0] == (1,) * R and plan.fac[2][1] == -1j
    prod = dataclasses.replace(plan, radix=8, m=1024, n=512)
    assert tfull.kernel_tile(prod) == 8
    assert tfull.kernel_tile(dataclasses.replace(prod, n=2048)) == 2
    with pytest.raises(ValueError, match="shared memory"):
        tfull.kernel_tile(dataclasses.replace(prod, n=8192))


def test_plan_matches_jax_operators():
    """The port's branch operators equal wrp_tpu's (both fold window and
    twiddles the same way), to the precision of wrp_tpu's bf16 hi + lo
    pair: 16 significant bits, so within 2^-16 of the operator's scale."""
    cfg = tiny_config(m=64, n=32)
    a, fac = tfull.radix_plan(tconst.PipelineConstants.build(cfg), 8)
    jconsts = JConsts.build(jtiny(m=64, n=32))
    ja, jfac = jfull.radix_plan_host(jconsts, 8, layout="split")
    hi_lo = (np.asarray(ja[:, 0::2], np.float32)
             + np.asarray(ja[:, 1::2], np.float32))      # re, im, re+im
    tol = 2.0 ** -16 * abs(a).max()
    np.testing.assert_allclose(hi_lo[:, 0], a.real, rtol=0, atol=tol)
    np.testing.assert_allclose(hi_lo[:, 1], a.imag, rtol=0, atol=tol)
    assert [list(r) for r in fac] == [list(r) for r in jfac]


def test_cuda_request_without_cuda_raises(monkeypatch):
    """No silent CPU path: asking for CUDA on a host without it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in ("pallas", "mxu"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SectorProcessor(DEFAULT_CONFIG, method=method, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SectorProcessor(DEFAULT_CONFIG, method="pallas")  # default device
