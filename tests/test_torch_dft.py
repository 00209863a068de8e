"""ops/dft.py and SectorProcessor(method="radix") on the CPU, against
wrp_tpu's ops/dft.py and radix method and the fp64 oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.ops import dft as jdft
from wrp_tpu_torch import pipeline as tpipe
from wrp_tpu_torch.config import DEFAULT_CONFIG, tiny_config
from wrp_tpu_torch.constants import PipelineConstants
from wrp_tpu_torch.ops import dft as tdft

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

M, N = 256, 256        # the smallest geometry both split (2 x 128 each)
FACTORS = ("f1r", "f1i", "f2r", "f2i", "twr", "twi")


@pytest.mark.parametrize("n,sign,half", [(256, -1.0, True), (512, 1.0, False),
                                         (1024, -1.0, True), (384, 1.0, False)])
def test_plan_factors_equal_jax(n, sign, half):
    got = tdft.RadixPlan.build(n, 128, sign=sign, half=half)
    want = jdft.RadixPlan.build(n, 128, sign=sign, half=half)
    assert (got.n, got.n1, got.n2) == (want.n, want.n1, want.n2)
    for f in FACTORS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    on = got.to("cpu")
    for f in FACTORS:
        assert torch.equal(getattr(on, f), torch.from_numpy(getattr(want, f)))


def test_stage_operators_and_supports_equal_jax():
    for m, n in ((1024, 512), (256, 256), (64, 32), (384, 256), (256, 128)):
        assert tdft.RadixStageOperators.supports(tiny_config(m=m, n=n)) == \
            jdft.RadixStageOperators.supports(jtiny(m=m, n=n)), (m, n)
    got = tdft.RadixStageOperators.build(DEFAULT_CONFIG)
    want = jdft.RadixStageOperators.build(jtiny(m=1024, n=512))
    assert np.array_equal(got.w_range, want.w_range)
    assert np.array_equal(got.w_doppler, want.w_doppler)
    for f in FACTORS:
        assert np.array_equal(getattr(got.range_plan, f),
                              getattr(want.range_plan, f))
        assert np.array_equal(getattr(got.doppler_plan, f),
                              getattr(want.doppler_plan, f))
    with pytest.raises(ValueError, match="cannot split"):
        tdft.RadixPlan.build(200, 128)


def test_split_dfts_match_numpy_fft():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 256, 128)) + 1j * rng.standard_normal((2, 256, 128))
    xr, xi = (torch.from_numpy(v.astype(np.float32)) for v in (x.real, x.imag))
    rows = tdft.RadixPlan.build(256, 128, sign=-1.0, half=True)
    vr, vi = tdft.radix_dft_rows(xr, xi, rows)
    want = np.fft.fft(x, axis=-2)[:, :128]
    assert oracle.relative_l2(np.abs(want), np.abs(vr.numpy() + 1j * vi.numpy())) < 1e-6
    cols = tdft.RadixPlan.build(128 * 2, 128, sign=+1.0)
    y = x.transpose(0, 2, 1)[:, :, :256]                     # [2, 128, 256]
    yr, yi = (torch.from_numpy(np.ascontiguousarray(v).astype(np.float32))
              for v in (y.real, y.imag))
    vr, vi = tdft.radix_dft_cols(yr, yi, cols)
    want = np.fft.ifft(y, axis=-1) * 256                     # the sign=+1 DFT
    got = vr.numpy() + 1j * vi.numpy()
    assert oracle.relative_l2(want.real, got.real) < 1e-6
    assert oracle.relative_l2(want.imag, got.imag) < 1e-6


@pytest.fixture(scope="module")
def sectors():
    return np.stack([oracle.synthetic_iq(jtiny(m=M, n=N), kind="noise", seed=s)
                     for s in (21, 22)])


@pytest.mark.parametrize("mf", ["direct", "fold"])
def test_radix_method_matches_jax_and_oracle(sectors, mf):
    jproc = jpipe.SectorProcessor(jtiny(m=M, n=N), method="radix",
                                  matched_filter=mf)
    tproc = tpipe.SectorProcessor(tiny_config(m=M, n=N), method="radix",
                                  matched_filter=mf, device="cpu")
    assert tproc.method == jproc.method == "radix"
    jzdb, jzdr = (np.asarray(a) for a in jproc(jnp.asarray(sectors,
                                                           jnp.complex64)))
    tzdb, tzdr = (a.numpy() for a in tproc(sectors.astype(np.complex64)))
    assert tzdb.shape == (2, M // 2)
    for b in range(2):
        zdb64, zdr64 = oracle.process_sector(sectors[b], jtiny(m=M, n=N))
        assert oracle.relative_l2(jzdb[b], tzdb[b]) < 1e-5
        assert oracle.relative_l2(jzdr[b], tzdr[b]) < 1e-5
        assert oracle.relative_l2(zdb64, tzdb[b]) < 1e-5
        assert oracle.relative_l2(zdr64, tzdr[b]) < 1e-5
        assert tzdb[b][0] == -np.inf


def test_radix_power_matches_mxu_stage(sectors):
    """stage01_04_radix is stage01_04_mxu_planar with factored operators."""
    cfg = tiny_config(m=M, n=N)
    consts = PipelineConstants.build(cfg)
    dc = tpipe._DeviceConstants(consts, torch.device("cpu"))
    x = tpipe.to_planar(sectors[0])
    p_radix = tdft.stage01_04_radix(x[:, 0], x[:, 1],
                                    tdft.RadixStageOperators.build(cfg))
    p_mxu = tpipe.stage01_04_mxu_planar(x[:, 0], x[:, 1], (dc.ar, dc.ai),
                                        (dc.br, dc.bi))
    assert oracle.relative_l2(p_mxu.numpy(), p_radix.numpy()) < 1e-5


def test_radix_refuses_the_spectral_filter():
    with pytest.raises(ValueError, match="spectral"):
        tpipe.SectorProcessor(tiny_config(m=M, n=N), method="radix",
                              matched_filter="spectral", device="cpu")


def test_radix_falls_back_to_mxu_where_it_does_not_split(sectors):
    """m = 64, n = 32 does not split with radix 128: the processor runs mxu
    and says so, as wrp_tpu's does."""
    cfg = tiny_config(m=64, n=32)
    proc = tpipe.SectorProcessor(cfg, method="radix", device="cpu")
    assert proc.method == "mxu"
    assert jpipe.SectorProcessor(jtiny(m=64, n=32), method="radix").method \
        == "mxu"
    iq = oracle.synthetic_iq(jtiny(m=64, n=32), kind="noise", seed=3)
    mxu = tpipe.SectorProcessor(cfg, method="mxu", device="cpu")
    for a, b in zip(proc(iq), mxu(iq)):
        assert torch.equal(a, b)
