"""The port's SectorProcessor against wrp_tpu's, method by method, and
against the fp64 oracle; the input contract and the edge semantics."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrp_tpu import oracle
from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu.constants import PipelineConstants as JConsts
from wrp_tpu_torch import pipeline as tpipe
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.constants import PipelineConstants

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

M, N = 64, 32


@pytest.fixture(scope="module")
def sectors():
    """Two noise sectors [2, C, m, n] complex128 (integer-valued)."""
    return np.stack([oracle.synthetic_iq(jtiny(m=M, n=N), kind="noise",
                                         seed=s) for s in (11, 12)])


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("method,tol", [("pallas", 2e-4), ("mxu", 1e-5),
                                        ("parseval", 1e-5), ("fft", 1e-5)])
def test_processor_matches_jax_and_oracle(sectors, method, tol):
    jproc = jpipe.SectorProcessor(jtiny(m=M, n=N), method=method)
    tproc = tpipe.SectorProcessor(tiny_config(m=M, n=N), method=method,
                                  device="cpu")
    jzdb, jzdr = (np.asarray(a) for a in jproc(
        jnp.asarray(sectors, jnp.complex64)))
    tzdb, tzdr = (_np(a) for a in tproc(sectors.astype(np.complex64)))
    assert tzdb.shape == jzdb.shape == (2, M // 2)
    for b in range(2):
        zdb64, zdr64 = oracle.process_sector(sectors[b], jtiny(m=M, n=N))
        assert oracle.relative_l2(jzdb[b], tzdb[b]) < tol
        assert oracle.relative_l2(jzdr[b], tzdr[b]) < tol
        assert oracle.relative_l2(zdb64, tzdb[b]) < tol
        assert oracle.relative_l2(zdr64, tzdr[b]) < tol
        assert tzdb[b][0] == -np.inf


@pytest.mark.parametrize("method", ["pallas", "mxu"])
def test_input_contract(sectors, method):
    """Complex, planar f32, planar int16 and unbatched inputs give the same
    products; a wrong shape raises."""
    proc = tpipe.SectorProcessor(tiny_config(m=M, n=N), method=method,
                                 device="cpu")
    planar = np.stack([sectors.real, sectors.imag], axis=2)
    zdb, zdr = proc(sectors)
    for x in (planar.astype(np.float32), planar.astype(np.int16),
              torch.from_numpy(planar.astype(np.int16))):
        a, b = proc(x)
        assert torch.equal(a, zdb) and torch.equal(b, zdr)
    one_db, one_dr = proc(planar[0].astype(np.int16))
    assert one_db.shape == (M // 2,)
    assert torch.equal(one_db, zdb[0]) and torch.equal(one_dr, zdr[0])
    assert torch.equal(proc(sectors[0])[0], zdb[0])
    with pytest.raises(ValueError, match="planar IQ"):
        proc(planar[:, :2].astype(np.float32))
    with pytest.raises(TypeError, match="int16 or float32"):
        proc(planar.astype(np.float64))


def test_method_option_errors():
    cfg = tiny_config(m=M, n=N)
    with pytest.raises(ValueError, match="spectral"):
        tpipe.SectorProcessor(cfg, method="pallas", matched_filter="spectral",
                              device="cpu")
    with pytest.raises(ValueError, match="spectral"):
        tpipe.SectorProcessor(cfg, method="radix", matched_filter="spectral",
                              device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tpipe.SectorProcessor(cfg, method="bogus", device="cpu")
    with pytest.raises(ValueError, match="matched_filter"):
        tpipe.SectorProcessor(cfg, matched_filter="bogus", device="cpu")


@pytest.mark.parametrize("method", ["pallas", "mxu", "parseval", "fft"])
def test_zero_iq_edge_semantics(method):
    """Zero IQ: zdb all -inf (log of zero power), zdr NaN (0/0)."""
    cfg = tiny_config(m=M, n=N)
    proc = tpipe.SectorProcessor(cfg, method=method, device="cpu")
    zdb, zdr = proc(np.zeros((1, cfg.num_channels, 2, M, N), np.int16))
    assert np.all(_np(zdb) == -np.inf)
    assert np.all(np.isnan(_np(zdr)))


@pytest.mark.parametrize("mf", ["fold", "spectral"])
def test_matched_filter_variants(sectors, mf):
    cfg = tiny_config(m=M, n=N)
    base = tpipe.SectorProcessor(cfg, method="mxu", device="cpu")(sectors)
    other = tpipe.SectorProcessor(cfg, method="mxu", matched_filter=mf,
                                  device="cpu")(sectors)
    for a, b in zip(base, other):
        assert oracle.relative_l2(_np(a), _np(b)) < 1e-5


def test_all_stages_match_oracle(sectors):
    cfg = tiny_config(m=M, n=N)
    iq = torch.from_numpy(sectors[0])                   # complex128
    got = tpipe.all_stages(iq, PipelineConstants.build(cfg, dtype=np.float64))
    want = oracle.all_stages(sectors[0], jtiny(m=M, n=N))
    for k in ("01hamm", "02fft1", "03fft2", "04abs", "07conv", "08pow",
              "09zdb", "10zdr"):
        assert oracle.relative_l2(np.abs(want[k]), np.abs(_np(got[k]))) \
            < 1e-10, k


@pytest.mark.parametrize("method", ["pallas", "parseval"])
def test_products_from_jax_constants(sectors, method):
    """The JAX package's constants, carried over with from_numpy, drive the
    port to the same products as its own (bit-identical arrays in, equal
    products out) and to wrp_tpu's products."""
    cfg = tiny_config(m=M, n=N)
    consts = PipelineConstants.from_numpy(
        dataclasses.asdict(JConsts.build(jtiny(m=M, n=N))))
    got = tpipe.SectorProcessor(cfg, method=method, device="cpu",
                                consts=consts)(sectors)
    own = tpipe.SectorProcessor(cfg, method=method, device="cpu")(sectors)
    for a, b in zip(got, own):
        assert torch.equal(a, b)
    jz = jpipe.SectorProcessor(jtiny(m=M, n=N), method=method)(
        jnp.asarray(sectors, jnp.complex64))
    for a, b in zip(jz, got):
        assert oracle.relative_l2(np.asarray(a), _np(b)) < 2e-4
