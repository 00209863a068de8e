"""ctypes binding for the native wire codec (codec.cpp), natural row order.

The port's counterpart of ``wrp_tpu/native/codec_native.py``.  The library
is built at the first call (build.py), not at import; a build or load
failure raises, there is no numpy fallback here (io/codec.py runs numpy
only when its caller passes native=False).
"""

from __future__ import annotations

import os

import numpy as np

from .build import load_library

#: decode threads a call, unless the caller passes num_threads: 4 (or the
#: cores, if fewer) decoded a full sector fastest of 1, 2, 4 and 6 threads
#: on an 8-core host (chip_smoke.py's capacity phase, PERF.md)
DEFAULT_THREADS = int(os.environ.get("WRP_CODEC_THREADS",
                                      min(4, os.cpu_count() or 1)))


def _as_u8(buf) -> np.ndarray:
    """Zero-copy uint8 view over bytes/bytearray/memoryview/ndarray."""
    return np.frombuffer(buf, np.uint8)


def _check_out(out: np.ndarray, shape, dtype) -> np.ndarray:
    """Validate a caller-supplied output array before handing its raw
    pointer to C++: a wrong dtype or shape, or a non-contiguous or
    read-only view, would be silent memory corruption, not an exception."""
    if out.shape != tuple(shape) or out.dtype != dtype:
        raise ValueError(
            f"out must be {np.dtype(dtype)} {tuple(shape)}, got {out.dtype} "
            f"{out.shape}")
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out must be C-contiguous and writeable")
    return out


def _wire(wire, m: int, n: int, ch: int) -> np.ndarray:
    """The wire bytes as uint8, long enough for one sector (a short buffer
    would be an out-of-bounds read in C++)."""
    src = _as_u8(wire)
    if src.size < m * n * ch * 4:
        raise ValueError(
            f"wire buffer too short: {src.size} < {m * n * ch * 4}")
    return src


def decode_iq(wire, m: int, n: int, ch: int,
              out: np.ndarray | None = None,
              num_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """Wire bytes -> planar float32 [ch, 2, m, n]."""
    if out is None:
        out = np.empty((ch, 2, m, n), np.float32)
    else:
        _check_out(out, (ch, 2, m, n), np.float32)
    src = _wire(wire, m, n, ch)
    load_library().wrp_decode_iq(src.ctypes.data, out.ctypes.data, m, n, ch,
                                 num_threads)
    return out


def decode_iq_i16(wire, m: int, n: int, ch: int,
                  out: np.ndarray | None = None,
                  num_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """Wire bytes -> planar int16 [ch, 2, m, n] (the compact device feed)."""
    if out is None:
        out = np.empty((ch, 2, m, n), np.int16)
    else:
        _check_out(out, (ch, 2, m, n), np.int16)
    src = _wire(wire, m, n, ch)
    load_library().wrp_decode_iq_i16(src.ctypes.data, out.ctypes.data, m, n,
                                     ch, num_threads)
    return out


def decode_iq_i16_grouped(wire, m: int, n: int, ch: int,
                          stage: np.ndarray, slot: int, group: int,
                          num_threads: int = DEFAULT_THREADS) -> None:
    """Scatter ONE wire sector into a lane-grouped staging buffer
    stage[total_cs/group, 2, m, group*n] at batch slot `slot`: channel-
    sector i = slot*ch + c lands in group i // group, lane block
    i % group (the same loops as decode_iq_i16, other offsets)."""
    if group < 1 or stage.ndim != 4:
        raise ValueError(f"need group >= 1 and a 4-d stage; got {group}, "
                         f"{stage.shape}")
    _check_out(stage, stage.shape, np.int16)
    if stage.shape[1:] != (2, m, group * n):
        raise ValueError(f"stage must be [cs/{group}, 2, {m}, {group * n}]"
                         f"; got {stage.shape}")
    i_last = slot * ch + ch - 1
    if slot < 0 or i_last // group >= stage.shape[0]:
        raise ValueError(
            f"slot {slot} writes channel-sector {i_last}, beyond the "
            f"stage's {stage.shape[0] * group} channel-sectors")
    src = _wire(wire, m, n, ch)
    load_library().wrp_decode_iq_i16_grouped(
        src.ctypes.data, stage.ctypes.data, m, n, ch, num_threads, group,
        slot)


def encode_iq(planar: np.ndarray) -> bytes:
    """Planar [ch, 2, m, n] (float, integer valued) -> interleaved BE int16
    wire bytes, rounding to nearest-even like io/codec.encode_iq."""
    if planar.ndim != 4 or planar.shape[1] != 2:
        raise ValueError(f"planar must be [ch, 2, m, n]; got {planar.shape}")
    ch, _, m, n = planar.shape
    planar = np.ascontiguousarray(planar, np.float32)
    wire = np.empty(m * n * ch * 4, np.uint8)
    load_library().wrp_encode_iq(planar.ctypes.data, wire.ctypes.data, m, n,
                                 ch)
    return wire.tobytes()


def encode_be_f32(a: np.ndarray) -> bytes:
    """float32 array -> big-endian bytes (io/codec.encode_be_float32)."""
    a = np.ascontiguousarray(a, np.float32)
    out = np.empty(a.size * 4, np.uint8)
    load_library().wrp_encode_be_f32(a.ctypes.data, out.ctypes.data, a.size)
    return out.tobytes()
