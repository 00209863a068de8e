"""Readers/writers for the reference's file formats: ASCII IQ in
(read.cc:106-123), ASCII matrices (one matrix row per line,
space-separated; `99result` files are lines of "zdb zdr"), the raw
big-endian float32 wire dump (floats.c) and the native-endian zdb capture
(out/cpu.bin, read_single.cc:129-130).  Same behaviour as the matching
``wrp_tpu.io.files`` functions.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_ascii_matrix(path: str | Path) -> np.ndarray:
    """Space-separated ASCII floats, one row per line ('-inf' tolerated)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append(np.array([float(tok) for tok in line.split()], np.float64))
    widths = {len(r) for r in rows}
    if len(widths) != 1:
        raise ValueError(f"ragged matrix file {path}: row widths {sorted(widths)}")
    return np.stack(rows)


def write_ascii_matrix(path: str | Path, a: np.ndarray) -> None:
    a = np.atleast_2d(np.asarray(a))
    with open(path, "w") as f:
        for row in a:
            f.write(" ".join(format(float(v), "g") for v in row) + "\n")


def read_result_file(path: str | Path):
    """99result format: lines of 'zdb zdr' -> (zdb[m/2], zdr[m/2])."""
    mat = read_ascii_matrix(path)
    if mat.shape[1] != 2:
        raise ValueError(f"{path}: expected 2 columns, got {mat.shape[1]}")
    return mat[:, 0], mat[:, 1]


def read_be_float32_bin(path: str | Path) -> np.ndarray:
    """Raw big-endian float32 dump (the floats.c wire serialisation)."""
    return np.fromfile(path, dtype=">f4").astype(np.float32)


def read_zdb_dump(path: str | Path, bins: int = 512) -> np.ndarray:
    """The reference's binary zdb capture (out/cpu.bin): consecutive
    sectors' zdb rows written with a native-endian fwrite (read_single.cc:
    129-130), little-endian on x86, NOT the floats.c big-endian wire.
    Returns [sectors, bins] float32; bin 0 is -inf in every row."""
    a = np.fromfile(path, dtype="<f4")
    if a.size % bins:
        raise ValueError(f"{path}: {a.size} floats is not a whole number "
                         f"of {bins}-bin sectors")
    return a.reshape(-1, bins).astype(np.float32)


def read_ascii_iq(stream, m: int, n: int, channels: int = 2) -> np.ndarray:
    """Reference single-shot IQ input (read.cc:106-123): whitespace-
    separated ASCII "<i> <q>" pairs, one full channel at a time (all hh,
    then all vv), row-major m x n per channel.  Returns complex128
    [channels, m, n]."""
    toks = np.array(stream.read().split(), np.float64)
    want = channels * m * n * 2
    if toks.size != want:
        raise ValueError(
            f"ASCII IQ stream: expected {want} numbers "
            f"({channels} channels x {m} x {n} x 2), got {toks.size}")
    pairs = toks.reshape(channels, m, n, 2)
    return pairs[..., 0] + 1j * pairs[..., 1]


def write_ascii_iq(stream, iq: np.ndarray) -> None:
    """Inverse of read_ascii_iq, for replay and tests: one "<i> <q>" pair
    per line, channel-major as read.cc consumes them."""
    for v in np.asarray(iq).reshape(-1):
        stream.write(f"{v.real:g} {v.imag:g}\n")
