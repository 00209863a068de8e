"""Vectorised wire codecs for the radar formats (numpy).

Wire IQ format (reference sector.cpp:52-62, read_single.cc:15): one sector =
m*n samples x (4 * channels) bytes, each sample interleaved big-endian int16
``hhI hhQ vvI vvQ vhI vhQ``.  The decoders run the native codec
(native/codec.cpp: one SIMD pass over the wire, built with g++ at first
use; a build failure raises) unless the caller passes ``native=False``;
then the plain numpy version runs: a zero-copy view plus one transposing
copy into planar [channels, 2, m, n].  Both give the same bits.

Rows are always decoded in NATURAL range order: the port's kernel reads the
radix branches by index arithmetic (ops/fullchain.py), so the radix
pre-permutation ``wrp_tpu``'s decoders can emit has no counterpart here.

Result format (floats.c:3-43): big-endian float32 arrays with 2- or 4-byte
big-endian integer headers (see frames.py for the framing).
"""

from __future__ import annotations

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG
from ..native import codec_native


def _wire_view(buf, cfg: RadarConfig) -> np.ndarray:
    """Wire bytes -> [ch, 2, m, n] big-endian int16 view (no copy)."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    raw = np.frombuffer(buf, dtype=">i2", count=m * n * ch * 2)
    return raw.reshape(m, n, ch, 2).transpose(2, 3, 0, 1)


def decode_iq(buf: bytes | bytearray | memoryview | np.ndarray,
              cfg: RadarConfig = DEFAULT_CONFIG,
              planar_out: np.ndarray | None = None,
              native: bool = True) -> np.ndarray:
    """Wire bytes -> float32 planar IQ [channels, 2(I/Q), m, n], written
    into `planar_out` when it is given."""
    if native:
        return codec_native.decode_iq(buf, cfg.num_range_cells,
                                      cfg.num_pulses, cfg.num_channels,
                                      out=planar_out)
    out = planar_out if planar_out is not None else np.empty(
        cfg.sector_shape[:1] + (2,) + cfg.sector_shape[1:], np.float32)
    np.copyto(out, _wire_view(buf, cfg))
    return out


def decode_iq_i16(buf: bytes | bytearray | memoryview | np.ndarray,
                  cfg: RadarConfig = DEFAULT_CONFIG,
                  planar_out: np.ndarray | None = None,
                  native: bool = True) -> np.ndarray:
    """Wire bytes -> int16 planar IQ [channels, 2(I/Q), m, n].

    The compact device-feed layout: the 14-bit ADC samples ARE int16, so
    shipping int16 halves host->device bytes; the kernel converts to f32
    as it reads.  ``planar_out`` may be a view of a pinned staging
    buffer, so the decode writes straight into it."""
    if native:
        return codec_native.decode_iq_i16(buf, cfg.num_range_cells,
                                          cfg.num_pulses, cfg.num_channels,
                                          out=planar_out)
    out = planar_out if planar_out is not None else np.empty(
        cfg.sector_shape[:1] + (2,) + cfg.sector_shape[1:], np.int16)
    np.copyto(out, _wire_view(buf, cfg))
    return out


def decode_iq_i16_grouped(buf, stage: np.ndarray, slot: int, group: int,
                          cfg: RadarConfig = DEFAULT_CONFIG,
                          native: bool = True) -> None:
    """Decode ONE wire sector straight into a lane-grouped staging buffer
    ``stage[total_cs/group, 2, m, group*n]`` (int16) at batch slot
    ``slot``: channel-sector ``i = slot*ch + c`` lands in group
    ``i // group``, lane block ``i % group`` (``wrp_tpu``'s
    `decode_iq_i16_grouped`, natural row order)."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if native:
        codec_native.decode_iq_i16_grouped(buf, m, n, ch, stage, slot, group)
        return
    if stage.dtype != np.int16 or stage.ndim != 4 \
            or stage.shape[1:] != (2, m, group * n):
        raise ValueError(
            f"stage must be int16 [cs/{group}, 2, {m}, {group * n}]; "
            f"got {stage.dtype} {stage.shape}")
    i_last = slot * ch + ch - 1
    if group < 1 or slot < 0 or i_last // group >= stage.shape[0]:
        raise ValueError(
            f"slot {slot} writes channel-sector {i_last}, beyond the "
            f"stage's {stage.shape[0] * max(group, 1)} channel-sectors")
    planar = decode_iq_i16(buf, cfg, native=False)
    for c in range(ch):
        i = slot * ch + c
        lane = (i % group) * n
        stage[i // group, :, :, lane:lane + n] = planar[c]


def to_complex(planar: np.ndarray) -> np.ndarray:
    """[C, 2, m, n] float32 -> [C, m, n] complex64."""
    return (planar[:, 0] + 1j * planar[:, 1]).astype(np.complex64)


def encode_iq(iq: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> bytes:
    """Inverse of decode_iq for producers/tests: [C, m, n] complex (integer
    valued) -> interleaved BE int16 wire bytes."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if iq.shape != (ch, m, n):
        raise ValueError(f"IQ must be [{ch}, {m}, {n}]; got {iq.shape}")
    out = np.empty((m, n, ch, 2), dtype=">i2")
    out[..., 0] = np.round(iq.real).astype(np.int16).transpose(1, 2, 0)
    out[..., 1] = np.round(iq.imag).astype(np.int16).transpose(1, 2, 0)
    return out.tobytes()


def encode_be_float32(a: np.ndarray) -> bytes:
    """float32 array -> big-endian bytes (floats.c aftoab)."""
    return np.ascontiguousarray(a, dtype=">f4").tobytes()


def decode_be_float32(buf: bytes, count: int = -1) -> np.ndarray:
    """Big-endian float32 bytes -> float32 array (floats.c abtoaf)."""
    return np.frombuffer(buf, dtype=">f4", count=count).astype(np.float32)
