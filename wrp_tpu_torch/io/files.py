"""Readers/writers for the reference's ASCII file formats — what `cli
process` needs: ASCII IQ in (read.cc:106-123), ASCII matrix out (one
matrix row per line, space-separated; `99result` files are lines of
"zdb zdr").  Same behaviour as the matching ``wrp_tpu.io.files`` functions.
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

