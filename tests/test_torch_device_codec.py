"""The port's on-device wire decode (ops/device_codec.py, and the word decode
and lane constants of ops/fullchain.py) against wrp_tpu's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

M, N = 16, 8
EDGE_WORDS = (0x8000, 0x7FFF, 0xFFFF, 0x0000)


def _wires(cfg, b, seed):
    """[b, nbytes] uint8: random bytes, with the first samples of every
    sector set to the big-endian edge values 0x8000, 0x7FFF, 0xFFFF,
    0x0000 in both I and Q."""
    rng = np.random.default_rng(seed)
    wires = rng.integers(0, 256, (b, cfg.sector_nbytes_wire), dtype=np.uint8)
    for k, v in enumerate(EDGE_WORDS):
        pair = np.array([v >> 8, v & 0xFF], np.uint8)
        wires[:, 4 * k:4 * k + 2] = pair            # I of sample k
        wires[:, 4 * k + 2:4 * k + 4] = pair[::-1]  # Q gets the byte swap
    return wires


@pytest.mark.parametrize("channels", [3, 2])
def test_decode_wire_i16_bit_exact(channels):
    cfg = tiny_config(m=M, n=N, channels=channels)
    wires = _wires(cfg, 3, seed=channels)
    got = tdc.decode_wire_i16(torch.from_numpy(wires), cfg)
    assert got.dtype == torch.int16
    assert tuple(got.shape) == (3, channels, 2, M, N)
    want = np.asarray(jdc.decode_wire_i16(
        jnp.asarray(wires), jtiny(m=M, n=N, channels=channels), radix=1))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in range(3):
        np.testing.assert_array_equal(
            got[k].numpy(), codec.decode_iq_i16(wires[k].tobytes(), cfg))
    # the edge words decode to the int16 extremes, -1 and 0 (word k is
    # pulse k // channels of channel k % channels)
    for k, v in enumerate(EDGE_WORDS):
        j, c = divmod(k, channels)
        want_i = v - 65536 if v >= 32768 else v
        assert (got[:, c, 0, 0, j] == want_i).all(), k
    unbatched = tdc.decode_wire_i16(wires[0], cfg)
    assert torch.equal(unbatched, got[0])


@pytest.mark.parametrize("channels", [3, 2])
def test_wire_words_and_word_decode_bit_exact(channels):
    cfg = tiny_config(m=M, n=N, channels=channels)
    jcfg = jtiny(m=M, n=N, channels=channels)
    wires = _wires(cfg, 2, seed=10 + channels)
    want = np.asarray(jdc.wire_words_i32(jnp.asarray(wires), jcfg, radix=1))
    from_bytes = tdc.wire_words_i32(torch.from_numpy(wires), cfg)
    from_words = tdc.wire_words_i32(wires.view("<i4"), cfg)
    assert from_bytes.dtype == torch.int32
    assert tuple(from_bytes.shape) == (2, M, channels * N)
    np.testing.assert_array_equal(from_bytes.numpy(), want)
    np.testing.assert_array_equal(from_words.numpy(), want)
    ti, tq = tfull.decode_words_iq(from_bytes)
    ji, jq = jfull.decode_words_iq(jnp.asarray(want))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    # and against the host codec: word ch*j + c of row i is (I, Q) of
    # channel c, pulse j
    planar = codec.decode_iq_i16(wires[0].tobytes(), cfg)
    np.testing.assert_array_equal(
        ti[0].numpy().reshape(M, N, channels).transpose(2, 0, 1), planar[:, 0])
    np.testing.assert_array_equal(
        tq[0].numpy().reshape(M, N, channels).transpose(2, 0, 1), planar[:, 1])


def test_wire_input_validation():
    cfg = tiny_config(m=M, n=N)
    nb = cfg.sector_nbytes_wire
    with pytest.raises(ValueError, match="uint8 bytes or int32 words"):
        tdc.wire_words_i32(np.zeros((2, nb // 2), np.int16), cfg)
    with pytest.raises(ValueError, match="wire bytes"):
        tdc.wire_words_i32(np.zeros((2, nb - 4), np.uint8), cfg)
    with pytest.raises(ValueError, match="wire words"):
        tdc.wire_words_i32(np.zeros((2, nb // 4 + 1), np.int32), cfg)
    with pytest.raises(ValueError, match="wire bytes"):
        tdc.decode_wire_i16(np.zeros((2, nb // 4), np.int32), cfg)
    with pytest.raises(ValueError, match="wire bytes"):
        tdc.decode_wire_i16(np.zeros((nb + 1,), np.uint8), cfg)


@pytest.mark.parametrize("channels", [3, 2])
def test_wire_lane_consts_equal_jax(channels):
    cfg = tiny_config(m=M, n=N, channels=channels)
    wd_il, ph_il = tfull.wire_lane_consts(PipelineConstants.build(cfg),
                                          channels)
    jwd, jph = jfull.wire_lane_consts(JConsts.build(jtiny(m=M, n=N)),
                                      channels)
    assert wd_il.dtype == ph_il.dtype == np.float32
    np.testing.assert_array_equal(wd_il, jwd)
    np.testing.assert_array_equal(ph_il, jph)
    plan = tfull.build_plan(PipelineConstants.build(cfg), "cpu",
                            channels=channels)
    np.testing.assert_array_equal(plan.wd_il.numpy(), jwd)
    np.testing.assert_array_equal(plan.ph_il.numpy(), jph)
    assert tfull.build_plan(PipelineConstants.build(cfg), "cpu").wd_il is None
