"""The port's numpy layer (config, constants, oracle, codec, frames, radix
plan helpers) against wrp_tpu's: array-equal, bit-exact codecs."""

import dataclasses

import numpy as np
import pytest

from wrp_tpu import config as jconfig
from wrp_tpu import constants as jconst
from wrp_tpu import oracle as joracle
from wrp_tpu.io import codec as jcodec
from wrp_tpu.io import frames as jframes
from wrp_tpu.ops.pallas import fullchain as jfull
from wrp_tpu_torch import config as tconfig
from wrp_tpu_torch import constants as tconst
from wrp_tpu_torch import oracle as toracle
from wrp_tpu_torch.io import codec as tcodec
from wrp_tpu_torch.io import frames as tframes
from wrp_tpu_torch.ops import fullchain as tfull

GEOMETRIES = {
    "default": None,
    "tiny-3ch": dict(m=64, n=32, channels=3),
    "tiny-2ch": dict(m=64, n=32, channels=2),
}


def _cfgs(name):
    kw = GEOMETRIES[name]
    if kw is None:
        return jconfig.DEFAULT_CONFIG, tconfig.DEFAULT_CONFIG
    return jconfig.tiny_config(**kw), tconfig.tiny_config(**kw)


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_config_matches(geom):
    jc, tc = _cfgs(geom)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for prop in ("bytes_per_sample", "m", "n", "num_output_bins",
                 "sector_shape", "sector_nbytes_wire", "datagram_nbytes",
                 "sectors_per_volume"):
        assert getattr(jc, prop) == getattr(tc, prop), prop


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_constants_array_equal(geom):
    jc, tc = _cfgs(geom)
    jp = jconst.PipelineConstants.build(jc)
    tp = tconst.PipelineConstants.build(tc)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for fn in ("hamming_coefficients", "ma_coefficients", "ma_spectrum",
               "range_gain"):
        np.testing.assert_array_equal(getattr(jconst, fn)(jc),
                                      getattr(tconst, fn)(tc), err_msg=fn)
    for a, b in zip(jconst.parseval_vectors(jc), tconst.parseval_vectors(tc)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jconst.stage1_operators(jc), tconst.stage1_operators(tc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jconst.dft_matrix(jc.n, inverse=True),
                                  tconst.dft_matrix(tc.n, inverse=True))


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_from_numpy_round_trips(geom):
    """from_numpy(asdict(wrp_tpu's constants)) is the port's own build,
    field by field and bit-exact; and it round-trips the port's."""
    jc, tc = _cfgs(geom)
    own = tconst.PipelineConstants.build(tc)
    for src in (jconst.PipelineConstants.build(jc), own):
        got = tconst.PipelineConstants.from_numpy(dataclasses.asdict(src))
        for f in dataclasses.fields(own):
            a, b = getattr(got, f.name), getattr(own, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    fields = dataclasses.asdict(own)
    fields.pop("wd")
    with pytest.raises(ValueError, match="fields"):
        tconst.PipelineConstants.from_numpy(fields)


@pytest.mark.parametrize("geom", ["tiny-3ch", "tiny-2ch"])
def test_oracle_matches(geom):
    jc, tc = _cfgs(geom)
    for kind in ("ramp", "noise"):
        a = joracle.synthetic_iq(jc, kind=kind, seed=5)
        b = toracle.synthetic_iq(tc, kind=kind, seed=5)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(joracle.produce_sector_iq(jc, 9, 3),
                                  toracle.produce_sector_iq(tc, 9, 3))
    iq = joracle.synthetic_iq(jc, kind="noise", seed=1)
    for ja, ta in zip(joracle.process_sector(iq, jc),
                      toracle.process_sector(iq, tc)):
        np.testing.assert_array_equal(ja, ta)
    js, ts = joracle.all_stages(iq, jc), toracle.all_stages(iq, tc)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    x = np.array([1.0, np.inf, 3.0, np.nan])
    y = np.array([1.5, 2.0, -np.inf, 4.0])
    assert joracle.relative_l2(x, y) == toracle.relative_l2(x, y)
    assert toracle.relative_l2([np.nan], [1.0]) == float("inf")


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_codec_bit_exact(geom):
    jc, tc = _cfgs(geom)
    iq = toracle.produce_sector_iq(tc, 4, 0)
    wire = tcodec.encode_iq(iq, tc)
    assert wire == jcodec.encode_iq(iq, jc)
    f32 = tcodec.decode_iq(wire, tc)
    i16 = tcodec.decode_iq_i16(wire, tc)
    np.testing.assert_array_equal(f32, jcodec.decode_iq(wire, jc))
    np.testing.assert_array_equal(i16, jcodec.decode_iq_i16(wire, jc))
    assert f32.dtype == np.float32 and i16.dtype == np.int16
    # both directions: wire -> planar -> wire and IQ -> wire -> IQ
    assert tcodec.encode_iq(tcodec.to_complex(f32), tc) == wire
    np.testing.assert_array_equal(tcodec.to_complex(f32), iq)
    out = np.empty_like(i16)
    assert tcodec.decode_iq_i16(wire, tc, planar_out=out) is out
    np.testing.assert_array_equal(out, i16)
    vals = np.random.default_rng(0).standard_normal(17).astype(np.float32)
    be = tcodec.encode_be_float32(vals)
    assert be == jcodec.encode_be_float32(vals)
    np.testing.assert_array_equal(tcodec.decode_be_float32(be),
                                  jcodec.decode_be_float32(be))
    with pytest.raises(ValueError):
        tcodec.encode_iq(iq[:1], tc)


def test_result_and_ingest_frames_match():
    vals = np.linspace(-3, 3, 512, dtype=np.float32)
    assert tframes.pack_result_v1(7, vals) == jframes.pack_result_v1(7, vals)
    assert (tframes.pack_result_v1x(7, 2, vals)
            == jframes.pack_result_v1x(7, 2, vals))
    hdr = tframes.IngestHeader(5, 1, 9)
    assert (tframes.pack_ingest_row(hdr, b"abc")
            == jframes.pack_ingest_row(jframes.IngestHeader(5, 1, 9), b"abc"))
    assert tframes.unpack_result_udp(jframes.pack_result_v1x(7, 2, vals))[:2] \
        == (7, 2)


@pytest.mark.parametrize("m", [8, 16, 32, 64, 128, 256, 1024])
def test_radix_helpers_match(m):
    assert tfull.radix_for(m) == jfull.radix_for(m)
    r = tfull.radix_for(m)
    np.testing.assert_array_equal(tfull.radix_row_order(m, r),
                                  jfull.radix_row_order(m, r))
