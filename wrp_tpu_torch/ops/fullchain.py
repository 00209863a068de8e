"""The fused chain (stages 01-08) as hand-written CUDA kernels.

Counterpart of ``wrp_tpu/ops/pallas/fullchain.py``: per channel-sector,
IQ [2, m, n] -> matched-filter power [m/2] via a half-spectrum range DFT
followed by the closed-form Parseval epilogue (``pipeline.stage_b_parseval``).
Each kernel has its wrapper, plain torch version and launch counter; which
kernel serves an m is m's alone:

* radix, csrc/fused_chain_radix.cu (``wrp_tpu`` `fused_chain_power_radix`):
  `fused_chain_power_radix`, `LAUNCHES`.  Planar int16/f32 IQ for m that
  splits (`radix_for(m) > 1`), through the route `chain_route(m)` names:
  the register body of csrc/fft_chain.cuh for m <= FFT_SHORT_M = 1024
  (plain `fft_chain_power_reference`); the cluster body
  (csrc/fused_chain_radix_cluster.cu, csrc/cluster_chain.cuh: each ray
  split across a cluster of 8 blocks, 16 above CLUSTER_MAX_M8 = 8192;
  plain `cluster_chain_power_reference`, counted also in
  `RADIX_CLUSTER_LAUNCHES`) for 1024 < m <= CLUSTER_MAX_M = 16384; where
  the cluster body refuses m (16 x p above 8192, p a prime whose Bluestein
  length passes BLUESTEIN_MAX_N; above 16384) the dense entries' matrix
  kernel on the dense A_half
  (`RadixPlan.dense_operator`, built at first use; plain
  `fused_chain_power_reference`), counted also in `DENSE_MATRIX_LAUNCHES`.
* wire, csrc/fused_chain_wire.cu (``wrp_tpu`` `fused_chain_power_wire`):
  `fused_chain_power_wire`, plain `fused_chain_power_wire_reference`,
  `WIRE_LAUNCHES`.  Raw wire words [bs, m, ch*n] int32, decoded in
  registers, one channel a cluster, through the route `chain_route(m)`
  names, as the radix entry's: the register body of csrc/fft_chain.cuh for
  m <= 1024; the cluster body (csrc/fused_chain_wire_cluster.cu,
  csrc/cluster_chain.cuh: each ray split across a cluster of 8 blocks, 16
  above CLUSTER_MAX_M8; plain `cluster_chain_power_reference`, counted
  also in `WIRE_CLUSTER_LAUNCHES`) for 1024 < m <= CLUSTER_MAX_M; where
  the cluster body refuses m the matrix kernel's wire source
  (csrc/fused_chain_dense.cu `wrp_fused_chain_dense_wire`, on
  `RadixPlan.dense_operator`, plain `fused_chain_power_reference`),
  counted also in `DENSE_MATRIX_LAUNCHES`.
* dense, csrc/fused_chain_dense.cu (``wrp_tpu`` `fused_chain_power`):
  `fused_chain_power_dense`, `DENSE_LAUNCHES`, for m that does not split
  (`radix_for(m) == 1`), through the route `chain_route(m)` names, as the
  radix entry's: every even m <= 1024 (m = 1000 = 8 x 125) the register
  body of csrc/fft_chain.cuh (plain `fft_chain_power_reference`,
  `DENSE_FFT_LAUNCHES`); 1024 < m <= CLUSTER_MAX_M, m = S x odd (S = 2, 4,
  8 and m <= 1024 S: 1832 = 8 x 229) the cluster body through the planar
  chain's cluster entry, unsalted (a ray split across a cluster of S
  blocks, each block's m/S-point sub-DFT the leaf alone; plain
  `cluster_chain_power_reference`, `DENSE_CLUSTER_LAUNCHES`); m = 2 x odd
  in (2048, FFT_MAX_M = 4096] the long-ray form of the FFT-form body
  (csrc/fused_chain_radix_long.cu, P = 2: every row's partials in shared
  memory, `DENSE_FFT_LAUNCHES`); any other m (odd m, m above those, a
  leaf prime whose Bluestein length would pass 1024) the matrix kernel,
  the dense A_half [m/2, m] contraction (plain
  `fused_chain_power_reference`, its R == 1 branch,
  `DENSE_MATRIX_LAUNCHES`, which counts the radix and wire entries'
  launches of it too).

The FFT-form body of csrc/fft_chain.cuh (`fft_takes`) has two forms, chosen
from m alone (`fft_long`): m <= 1024 keeps each thread's epilogue partials
in registers; the dense entries' m = 2 x odd in (2048, FFT_MAX_M] (the
long-ray body, csrc/fused_chain_radix_long.cu, P = 2) keeps them in shared
memory and runs every odd L through its Stockham leaf.

The benchmark (wrp_tpu_torch/bench.py) reads each step's slab of a larger
staged array through the OFFSET entries, one per kernel, each with its own
counter (counted only when an offset is given): `fused_chain_power_radix`
and `fused_chain_power_wire` with `offset=`, `bc=`/`bs=` and `salt=`
(``wrp_tpu``'s `_kernel_radix_offset`, `_kernel_radix_wire_offset`;
`RADIX_OFFSET_LAUNCHES`, `WIRE_OFFSET_LAUNCHES`; for m <= 1024 a salt
launches through csrc/fused_chain_{radix,wire}_salted.cu, the same
instantiation with its salt; the cluster and matrix entries take the salt
themselves), and `fused_chain_power_at` (``wrp_tpu``'s dense offset entry;
`DENSE_OFFSET_LAUNCHES`).  The offset is applied by the C launcher as
pointer arithmetic, so there is no copy; one past the staged array raises
(``wrp_tpu`` clamps it in interpret mode and would read past the buffer
compiled).  The salt, an int32, is added to every I and Q sample after its
conversion to f32.

The pulse-sharded path (parallel/sharded.py "pallas-seq") splits the
radix chain at its one communication point, with a kernel on each side:

* A-stage (``wrp_tpu`` `fused_chain_astage`): `fused_chain_astage`, plain
  `fused_chain_astage_reference`, `ASTAGE_LAUNCHES`.  A rank's pulse slab
  [bc, 2, m, w] -> Y [bc, 2, m/2, w] through the route `chain_route(m)`
  names: the FFT stage of csrc/fft_chain.cuh (csrc/fused_chain_astage.cu)
  for m <= 1024; the cluster body (csrc/fused_chain_astage_cluster.cu,
  plain `cluster_stage_reference`, counted also in
  `ASTAGE_CLUSTER_LAUNCHES`) for 1024 < m <= CLUSTER_MAX_M, a cluster of
  16 above 8192; where the cluster body refuses m the matrix form of
  csrc/radix_chain.cuh through csrc/fused_chain_astage_matrix.cu (int16
  and f32, any radix and w), counted also in `ASTAGE_MATRIX_LAUNCHES`.
* row epilogue, csrc/parseval_rows.cu (``wrp_tpu`` `parseval_rows_power`):
  `parseval_rows_power`, plain `parseval_rows_power_reference`,
  `PARSEVAL_ROWS_LAUNCHES`.  The Parseval epilogue on full-pulse rows
  Y [bc, 2, rows, n] -> pow [bc, rows]; rows the register form does not
  take (`parseval_rows_form`) run its two-pass form, counted also in
  `PARSEVAL_ROWS_TWO_PASS_LAUNCHES`.

The host plan (`build_plan`) holds the FFT forms' tables (`fft_tables`:
the range window w_r c, the twiddles W_P, the leaf's factors; for the
cluster body `cluster_tables`, the same for the m/S-point sub-DFT and the
cluster's twiddles W_m^(b k1) and W_S; each fp64, cast once;
`fft_round_phasor_sums`) beside the TPU algorithm's matrix form
(`radix_plan`: the branch operators A_p = F_M diag(w_r c)[p::R] diag(T_p)
and the combine factors fac[s][p] = exp(-2 pi i p s / R); R == 1: A_half
itself), which the dense kernel, the matrix-form plain version
`fused_chain_power_reference` and the in-kernel time breakdown
(ops/probes.py) use.  Each wrapper sends a CPU tensor to the plain
version; a CUDA tensor launches the kernel or raises.

Rows stay in NATURAL order everywhere, so ``wrp_tpu``'s radix row layout
(`layout="radix"`, `wire_order`, `reorder_wire_rows`) has no counterpart.
`radix_row_order` is kept only to name the DIT branch structure (and is
held equal to ``wrp_tpu``'s by the tests).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..constants import PipelineConstants, dft_matrix
from ..pipeline import stage_b_parseval
from . import _build

#: kernel launches, counted where each wrapper launches its CUDA kernel and
#: nowhere else (chip_smoke.py resets and reads them around each path's run)
LAUNCHES = 0            # fused_chain_radix.cu
WIRE_LAUNCHES = 0       # fused_chain_wire.cu
DENSE_LAUNCHES = 0      # fused_chain_dense.cu
ASTAGE_LAUNCHES = 0     # fused_chain_astage (any route)
ASTAGE_CLUSTER_LAUNCHES = 0  # of those, fused_chain_astage_cluster.cu (1024 < m <= 16384)
ASTAGE_MATRIX_LAUNCHES = 0   # of those, fused_chain_astage_matrix.cu (m the cluster refuses)
PARSEVAL_ROWS_LAUNCHES = 0   # parseval_rows.cu (either form)
PARSEVAL_ROWS_TWO_PASS_LAUNCHES = 0  # of those, its two-pass form
RADIX_OFFSET_LAUNCHES = 0    # the radix offset entry (salted: fused_chain_radix_salted.cu)
WIRE_OFFSET_LAUNCHES = 0     # the wire offset entry (salted: fused_chain_wire_salted.cu)
#: launches of the wire chain's cluster body (fused_chain_wire_cluster.cu,
#: 1024 < m <= 16384) from either wire entry
WIRE_CLUSTER_LAUNCHES = 0
#: launches of the planar chain's cluster body (fused_chain_radix_cluster.cu,
#: 1024 < m <= 16384) from either radix entry
RADIX_CLUSTER_LAUNCHES = 0
DENSE_OFFSET_LAUNCHES = 0    # fused_chain_power_at (fused_chain_dense.cu)
#: launches of each dense body, from either dense entry (a run shows which
#: body its m took)
DENSE_FFT_LAUNCHES = 0       # the FFT-form body (fft_chain.cuh, either form)
DENSE_CLUSTER_LAUNCHES = 0   # the cluster body (fused_chain_radix_cluster.cu)
DENSE_MATRIX_LAUNCHES = 0    # the matrix kernel of fused_chain_dense.cu (any entry)

RADIX = 8

#: tile heights (sub-DFT rows per block) the matrix-form A-stage
#: (csrc/radix_chain.cuh: the A-stage where the cluster body refuses m and
#: the in-kernel time breakdown's) is instantiated for
KERNEL_TILES = (8, 4, 2)

#: tile heights (rows of Y per block) the dense kernel is instantiated for,
#: and the operator rows it stages per step (csrc/fused_chain_dense.cu kQ)
DENSE_TILES = (10, 4, 2, 1)
DENSE_KQ = 64

#: dynamic shared memory one block may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024


def radix_for(m: int) -> int:
    """Largest supported radix for this geometry (1 = the dense form)."""
    r = RADIX
    while r > 1 and (m % r or (m // r) % 8):
        r //= 2
    return r


def radix_row_order(m: int, radix: int) -> np.ndarray:
    """Natural row index of each DIT branch row, branch-major: row
    j = radix * t + p is listed at position p * (m / radix) + t."""
    return np.concatenate([np.arange(p, m, radix) for p in range(radix)])


@dataclasses.dataclass(frozen=True)
class FftGeometry:
    """How the FFT-form kernels (csrc/fft_chain.cuh) cut one geometry.

    The range DFT of m = P L points (P the largest power of two dividing
    m, L odd) is L P-point FFTs on the decimated rows L i + r2, each in
    four steps P = P1 P2 (P1 = min(32, P): a P1-point DFT in registers, a
    twiddle W_P^(k1 n2), a P2-point register DFT, P2 <= 32), then for L > 1
    an L-point leaf DFT across the L sub-FFTs, a mixed-radix Stockham FFT
    (`leaf_fft_reference`; 5 x 5 x 5 at m = 1000).  The pulse columns split
    into chunks of `cols`, dealt round-robin to the unit's `blocks` blocks
    (at most 8: one thread-block cluster): in round r, block b runs chunk
    r blocks + b."""

    P: int
    L: int
    P1: int
    P2: int
    cols: int
    blocks: int


#: the FFT-form kernels' limits: m <= FFT_SHORT_M for every entry, and for
#: the dense entries' m = 2 x odd in (2048, FFT_MAX_M] the long-ray form;
#: at most FFT_MAX_CLUSTER blocks per unit (the portable cluster size),
#: FFT_THREADS threads a block.  Up to FFT_SHORT_M a thread holds its two
#: rows' epilogue partials in registers (csrc/fft_chain.cuh kRows); in the
#: long-ray form every row's partials live in shared memory
FFT_MAX_M = 4096
FFT_SHORT_M = 1024
FFT_MAX_CLUSTER = 8
FFT_THREADS = 256
#: complex values of one round's working set (m cols): 64 KB of fp32
FFT_ROUND_VALUES = 8192
#: floats of one row's epilogue partials (shift 2, mean 2, energy 1, the
#: four phasor projections of re and im 8), and of the cluster exchange's
#: row in the m <= 1024 body (padded to 16)
FFT_PARTIALS = 13
FFT_STAT = 16


def leaf_radix(rem: int) -> int:
    """The radix of the leaf's next Stockham pass over the `rem` points
    still to combine: 5, 3 or 7 where one divides, else all of `rem` in one
    pass (csrc/fft_chain.cuh leaf_radix)."""
    for r in (5, 3, 7):
        if rem % r == 0:
            return r
    return rem


def fft_long(m: int) -> bool:
    """Whether the long-ray form of the FFT-form body (partials in shared
    memory, csrc/fft_chain.cuh fft_chain_long_kernel) takes m: the dense
    entries' m = 2 x odd in (2048, FFT_MAX_M] (dispatch_long, P = 2), which
    the cluster body cannot split (m / 2 > CLUSTER_MAX_MS)."""
    return 2048 < m <= FFT_MAX_M and m % 4 == 2


def fft_takes(m: int) -> bool:
    """Whether the FFT-form body takes m range rows: every even m, 2 <= m
    <= FFT_SHORT_M (the register body), and the dense entries' m that
    `fft_long` names (its long-ray form).  Every other m above
    FFT_SHORT_M takes the cluster body or the matrix kernel
    (`chain_route`)."""
    return (2 <= m <= FFT_SHORT_M and m % 2 == 0) or fft_long(m)


def _fft_factors(m: int):
    """(P, L, P1, P2) of m (csrc/fft_chain.cuh Geometry)."""
    P = m & -m
    P1 = min(32, P)
    return P, m // P, P1, P // P1


def _round4(v: int) -> int:
    return (v + 3) & ~3


def fft_smem_bytes(m: int, cols: int, fused: bool = True,
                   elem: int = 2) -> int:
    """Dynamic shared memory of one block of the FFT-form kernel at m and
    `cols` columns a round, staging planar samples of `elem` bytes (2:
    int16, 4: f32; 0: the wire, read straight from device memory): the
    words of csrc/fft_chain.cuh Layout.  fused=False: the A-stage."""
    P, L, P1, P2 = _fft_factors(m)
    pad = cols if cols < 32 else 0
    sp = P2 * cols + pad
    np_ = cols + 1
    inplace = L == 1 and cols * P1 <= FFT_THREADS
    leaf = max(m * cols, (m // 2) * np_)
    if L == 1:
        size_a = _round4(P1 * sp)
        size_b = _round4(0 if inplace else (m // 2) * np_)
    else:
        size_a = _round4(max(L * P1 * sp if P2 > 1 else 0, leaf))
        size_b = _round4(leaf)
    data = 2 * (size_a + size_b) + 2 * m * cols * elem // 4
    data += 5 * cols if fused else 0
    if not fused:
        return 4 * data
    if m > FFT_SHORT_M:
        return 4 * (data + FFT_PARTIALS * (m // 2) + 8)
    return 4 * max(data, FFT_STAT * (m // 2) + 8)


def fft_geometry(m: int, width: int) -> FftGeometry:
    """The FFT-form kernels' cut of m range rows and `width` pulse
    columns (see FftGeometry).  cols: the largest power of two with
    m cols <= FFT_ROUND_VALUES (8 at m = 1024: 64 KB), or half that for
    L > 1 (4 at m = 1000 and 960), at most 64 and no
    more than width needs, and for L = 1 with pass 2's cols P1 tasks no
    more than the block's threads (its output then overwrites its input in
    shared memory); in the long-ray form, halved until the fused block
    fits one block's shared memory with f32 samples staged; blocks: at most
    FFT_MAX_CLUSTER, each with at least one chunk (8 blocks of 8 rounds at
    n = 512).  Refuses m the body does not take (`fft_takes`)."""
    if not fft_takes(m):
        raise ValueError(f"the FFT-form kernels take an even m <= "
                         f"{FFT_SHORT_M} and, for the dense entries, m = 2 "
                         f"x odd in (2048, FFT_MAX_M = {FFT_MAX_M}] (every "
                         f"other m above {FFT_SHORT_M} takes the cluster "
                         f"body or the matrix kernel), got m={m}")
    P, L, P1, P2 = _fft_factors(m)
    lng = m > FFT_SHORT_M
    # L > 1: the leaf's passes run between two m x cols buffers (the L = 1
    # chain writes pass 2 in place), so half the round keeps two blocks
    # per SM
    values = FFT_ROUND_VALUES if m == P else FFT_ROUND_VALUES // 2
    cols = 1
    while (cols < 64 and 2 * cols * m <= values and cols < width
           and (m > P or lng or 2 * cols * P1 <= FFT_THREADS)):
        cols *= 2
    while lng and cols > 1 and fft_smem_bytes(m, cols, True, 4) > MAX_SMEM_BYTES:
        cols //= 2
    return FftGeometry(P=P, L=L, P1=P1, P2=P2, cols=cols,
                       blocks=min(FFT_MAX_CLUSTER, _cdiv(width, cols)))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _snap(v: complex) -> complex:
    """exact 4th roots of unity (and their 0 parts) stay exact in f32"""
    re = round(v.real) if abs(v.real - round(v.real)) < 1e-12 else v.real
    im = round(v.imag) if abs(v.imag - round(v.imag)) < 1e-12 else v.imag
    return complex(re, im)


def _roots(count: int, period: int) -> np.ndarray:
    """exp(-2 pi i t / period) for t < count, in float64, snapped"""
    t = np.arange(count)
    return np.array([_snap(v) for v in np.exp(-2j * np.pi * (t % period) / period)])


def fft_tables(consts: PipelineConstants) -> np.ndarray:
    """The FFT-form kernels' constants, one float32 vector (fp64 on the
    host, cast once; the kernels compute no sine at run time):

      [0, m)                 w_r c, the real range window and scale
                             (row 0 of op_a_half, as `radix_plan` reads it)
      [m, m + 2P)            W_P^t (re, im), t < P
      then 2 L P             W_m^(k r2) at (r2 P + k): the leaf's twiddles
      then 2 L               W_L^t, t < L: the leaf FFT's roots (its
                             passes' twiddles and butterflies index them)."""
    m = consts.op_a_half.shape[1]
    g = fft_geometry(m, 1)
    P, L = g.P, g.L
    wr_c = np.asarray(consts.op_a_half[0]).astype(np.complex128).real
    k, r2 = np.meshgrid(np.arange(P), np.arange(L))          # [L, P]
    leaf_tw = _roots(m, m)[(k * r2) % m]
    leaf = _roots(L, L)

    def inter(c):
        c = np.asarray(c).reshape(-1)
        return np.stack([c.real, c.imag], -1).reshape(-1)

    return np.concatenate([wr_c, inter(_roots(P, P)), inter(leaf_tw),
                           inter(leaf)]).astype(np.float32)


def fft_round_phasor_sums(phasors: np.ndarray, cols: int) -> np.ndarray:
    """Phi [ceil(n / cols), 4] float32: each round's (cols pulse columns')
    sum of the four clip-bin phasor rows, summed in float64.  The merged
    epilogue moves a chunk's projections from its own mean to the whole
    row's with them."""
    ph = np.asarray(phasors, np.float64)
    n = ph.shape[1]
    pad = -(-n // cols) * cols - n
    ph = np.concatenate([ph, np.zeros((4, pad))], 1)
    return ph.reshape(4, -1, cols).sum(-1).T.astype(np.float32).copy()


#: the cluster body (csrc/cluster_chain.cuh), the route of the planar chain
#: (#3/#4), the wire chain (#7/#8) and the A-stage (#5) for FFT_SHORT_M <
#: m <= CLUSTER_MAX_M, of the dense entries (#1/#2) up to CLUSTER_MAX_M8:
#: each ray split across a cluster of S blocks
#: (`cluster_split`: CLUSTER_SPLIT = 8 for a radix m up to CLUSTER_MAX_M8,
#: CLUSTER_SPLIT_LONG = 16, a non-portable cluster size, above it; S = 2,
#: 4 or 8 for the dense entries' m = S x odd), block b the rows S t + b, of
#: whose S-point DFT across the blocks S / 2 outputs are kept (k < m/2); a
#: block's sub-DFT at most CLUSTER_MAX_MS points (its m / 2S owned rows,
#: two a thread); at most CLUSTER_MAX_COLS pulse columns a round (each
#: round costs two cluster barriers, so a round takes as many columns as
#: shared memory allows)
CLUSTER_MAX_M = 16384
CLUSTER_MAX_M8 = 8192
CLUSTER_SPLIT = 8
CLUSTER_SPLIT_LONG = 16
CLUSTER_MAX_MS = 1024
CLUSTER_MAX_COLS = 64
#: the cluster body's odd leaf: a register DFT pass for each odd prime
#: factor up to LEAF_MAX_RADIX; a larger prime p in Bluestein's form, a
#: cyclic convolution of length N, the power of two >= 2p - 1, at most
#: BLUESTEIN_MAX_N (a BLUESTEIN_N1-point then an N / BLUESTEIN_N1-point
#: register DFT each way), BLUESTEIN_MAX_BATCH down to BLUESTEIN_MIN_BATCH
#: convolutions at a time in one block's shared memory
LEAF_MAX_RADIX = 31
BLUESTEIN_MAX_N = 1024
BLUESTEIN_N1 = 32
BLUESTEIN_MAX_BATCH = 64
BLUESTEIN_MIN_BATCH = 4
MAX_SMEM_WORDS = MAX_SMEM_BYTES // 4


def prime_factors(v: int) -> list:
    """The prime factors of v, ascending, with multiplicity."""
    out, q = [], 2
    while q * q <= v:
        while v % q == 0:
            out.append(q)
            v //= q
        q += 1
    return out + ([v] if v > 1 else [])


def bluestein_n(p: int) -> int:
    """Bluestein's convolution length for a p-point DFT: the power of two
    >= 2p - 1."""
    n = 1
    while n < 2 * p - 1:
        n *= 2
    return n


def cluster_split(m: int) -> int:
    """S, the blocks a unit's cluster splits an even m across: for a radix
    m (m % 16 == 0) 8 up to CLUSTER_MAX_M8 and 16 above it, else the power
    of two in m (2, 4 or 8: m = S x odd, so each block's m/S-point sub-DFT
    is the odd leaf alone)."""
    if m % 16:
        return m & -m
    return CLUSTER_SPLIT_LONG if m > CLUSTER_MAX_M8 else CLUSTER_SPLIT


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """The cluster body's odd leaf, the L-point DFT over r2 of each block's
    sub-transforms: in-place decimation-in-frequency passes, one a prime
    factor, ascending (a Bluestein prime, at most one, last).  Pass i of
    radix R = radices[i] and stride Lc = strides[i] (Lp = R Lc) takes, for
    each block of Lp points and j < Lc, the points j + r Lc (r < R), an
    R-point DFT, and writes output s times W_Lp^(j s) back to j + s Lc.
    Frequency t then lies at position perm[t] (t = s_1 + R_1 (s_2 + R_2
    (...)) at sum s_i Lc_i); the combine reads it there.  bluestein: the
    last pass's convolution length N (0: none)."""

    L: int
    radices: tuple
    strides: tuple
    perm: np.ndarray
    bluestein: int


@functools.lru_cache(maxsize=None)
def leaf_plan(L: int) -> LeafPlan:
    """The leaf's passes for an odd L (see LeafPlan).  Kept per L (perm
    read-only): every launch asks for its m's route and cut, and working
    out perm in Python at an L of several hundred takes longer than the
    kernel runs."""
    radices = tuple(prime_factors(L))
    strides, rem = [], L
    for r in radices:
        rem //= r
        strides.append(rem)
    perm = np.zeros(L, np.int64)
    for t in range(L):
        pos, q = 0, t
        for r, lc in zip(radices, strides):
            pos += (q % r) * lc
            q //= r
        perm[t] = pos
    perm.setflags(write=False)
    big = radices[-1] if radices and radices[-1] > LEAF_MAX_RADIX else 0
    return LeafPlan(L=L, radices=radices, strides=tuple(strides), perm=perm,
                    bluestein=bluestein_n(big) if big else 0)


def _cluster_factors(m: int):
    """(S, ms, P, L, P1, P2) of the cluster body at m."""
    S = cluster_split(m)
    ms = m // S
    P = ms & -ms
    P1 = min(32, P)
    return S, ms, P, ms // P, P1, P // P1


def cluster_refusal(m: int):
    """Why the cluster body does not take m, or None where it does: an odd
    m, m outside (FFT_SHORT_M, CLUSTER_MAX_M], a block's sub-DFT over
    CLUSTER_MAX_MS points (m = 8 x odd above 8192, 4 x odd above 4096, 2 x
    odd above 2048), or a leaf prime whose Bluestein length passes
    BLUESTEIN_MAX_N (above 8192 the radix m = 16 x p, p a prime in (512,
    1023]: N = 2048).  A radix m = 16 x odd above CLUSTER_MAX_M8 is taken
    at P = 1, each block's m/16-point sub-DFT the odd leaf alone."""
    if m % 2 or not FFT_SHORT_M < m <= CLUSTER_MAX_M:
        return (f"the cluster body takes an even m with {FFT_SHORT_M} < m "
                f"<= CLUSTER_MAX_M = {CLUSTER_MAX_M}, got m={m}")
    S, ms, P, L, _, _ = _cluster_factors(m)
    if ms > CLUSTER_MAX_MS:
        return (f"m={m} = {S} x {ms}: a block's {ms}-point sub-DFT passes "
                f"CLUSTER_MAX_MS = {CLUSTER_MAX_MS}")
    n = leaf_plan(L).bluestein
    if n > BLUESTEIN_MAX_N:
        return (f"m={m}: the leaf prime {prime_factors(L)[-1]} needs a "
                f"Bluestein length {n} > BLUESTEIN_MAX_N = {BLUESTEIN_MAX_N}")
    return None


def cluster_takes(m: int) -> bool:
    """Whether the cluster body takes m (`cluster_refusal`)."""
    return cluster_refusal(m) is None


def chain_route(m: int) -> str:
    """The kernel a chain launches for m, from m alone, the same for every
    chain: the planar chain (#3/#4), the wire chain (#7/#8) and the A-stage
    (#5) for a radix m, the dense entries (#1/#2) for a radix-1 m:
    "register" (csrc/fft_chain.cuh's register body, even m <=
    FFT_SHORT_M), "cluster" (csrc/cluster_chain.cuh, up to CLUSTER_MAX_M,
    where `cluster_refusal` finds nothing), "long" (the dense entries' m =
    2 x odd in (2048, FFT_MAX_M]: the FFT-form body's long-ray form) or
    "matrix" (any other: csrc/fused_chain_dense.cu's matrix kernel and its
    wire source, csrc/fused_chain_astage_matrix.cu; `cluster_refusal` says
    why)."""
    if 2 <= m <= FFT_SHORT_M and m % 2 == 0:
        return "register"
    if cluster_takes(m):
        return "cluster"
    return "long" if fft_long(m) else "matrix"


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """How the cluster body (csrc/cluster_chain.cuh) cuts m range rows.

    Block b of a unit's cluster of S blocks owns the rows r = S t + b,
    t < ms = m / S, and runs their ms-point DFT F_b (ms = P L, P the largest
    power of two dividing ms, L odd; P = P1 P2, a P1-point then a P2-point
    register DFT, each <= 32; for L > 1 the leaf's passes, `leaf_plan`, in
    place).  Then block b' combines the k1 of its slice,
    [b' span, min(ms, (b' + 1) span)), span = ceil(ms / S), over the S
    blocks: Y[k1 + ms k2] = sum_b W_S^(b k2) W_m^(b k1) F_b[k1], k2 < S / 2.
    Every block sees every pulse column, `cols` a round: as many as one
    block's shared memory allows for the body (the planar and wire chains,
    which read their samples straight from device memory, or the A-stage,
    which stages them, at its input's sample width).  bluestein: the leaf's
    convolution length N (0: none), batch: the convolutions a block runs at
    a time at this cut."""

    S: int
    ms: int
    P: int
    L: int
    P1: int
    P2: int
    cols: int
    span: int
    bluestein: int
    batch: int


def _cluster_layout(m: int, cols: int, fused: bool, elem: int):
    """(words, batch) of one block of the cluster body: csrc/cluster_chain.cuh
    Layout.  A ([r2][k1][n2][column] slots, rows padded where pass 2 reads
    them at cols < 32: the leaf runs in them, in place), the staged
    samples, then one region that the fused chains' owned rows use after
    the leaf and a Bluestein leaf's convolutions use during it (the largest
    power-of-two batch from BLUESTEIN_MAX_BATCH down to BLUESTEIN_MIN_BATCH
    that fits; 0 where none does),
    then the fused chains' round constants (wd, 4 phasor rows)."""
    S, ms, _, L, P1, P2 = _cluster_factors(m)
    pad = cols if cols < 32 and P2 > 1 else 0
    size_a = _round4(L * P1 * (P2 * cols + pad))
    own = _round4(S // 2 * _cdiv(ms, S) * (cols + 1)) if fused else 0
    base = (2 * size_a + _round4(2 * ms * cols * elem // 4)
            + (_round4(5 * cols) if fused else 0))
    n = leaf_plan(L).bluestein if L > 1 else 0
    batch = 0
    if n:
        batch = next((g for g in (64, 32, 16, 8, 4)
                      if BLUESTEIN_MIN_BATCH <= g <= BLUESTEIN_MAX_BATCH
                      and base + max(2 * own, 2 * g * n) <= MAX_SMEM_WORDS), 0)
    return base + max(2 * own, 2 * batch * n), batch


def cluster_smem_bytes(m: int, cols: int, fused: bool = True,
                       elem: int = 0) -> int:
    """Dynamic shared memory of one block of the cluster body at m and
    `cols` columns a round (`_cluster_layout`; a Bluestein leaf that no
    batch fits reads as one byte over the block's 227 KB).  fused: the
    planar and wire chains (the owned rows and the round's constants beside
    the FFT's buffer); else the A-stage.  `elem`: the bytes of a staged
    planar sample (2: int16, 4: f32; 0: none staged, the samples read
    straight from device memory, as the fused chains do)."""
    words, batch = _cluster_layout(m, cols, fused, elem)
    if leaf_plan(_cluster_factors(m)[3]).bluestein and not batch:
        return MAX_SMEM_BYTES + 1
    return 4 * words


def cluster_geometry(m: int, width: int, fused: bool = True,
                     elem: int = 0) -> ClusterGeometry:
    """The cluster body's cut of m range rows and `width` pulse columns for
    the fused chains (fused, the default: the planar and wire chains, which
    stage nothing, elem = 0) or the A-stage staging samples of `elem` bytes
    (`cluster_smem_bytes`): cols the largest power of two <=
    CLUSTER_MAX_COLS that width needs, halved until the block fits one
    block's shared memory.  The leaf runs in place in pass 1's slots, so an
    odd L takes the columns L = 1 takes at the same block budget: the fused
    chains 64 at m = 1536, 1832, 1840 and 2048, 32 at 1836, 4096, 4112-
    4160 and 8224-9216 (S = 16), 16 at 2002, 8192, 12288 and 16384.
    Refuses m the body does not take, saying why (`cluster_refusal`)."""
    why = cluster_refusal(m)
    if why is not None:
        raise ValueError(why)
    S, ms, P, L, P1, P2 = _cluster_factors(m)
    cols = 1
    while cols < CLUSTER_MAX_COLS and cols < width:
        cols *= 2
    while cols > 1 and cluster_smem_bytes(m, cols, fused, elem) > MAX_SMEM_BYTES:
        cols //= 2
    return ClusterGeometry(S=S, ms=ms, P=P, L=L, P1=P1, P2=P2, cols=cols,
                           span=_cdiv(ms, S),
                           bluestein=leaf_plan(L).bluestein if L > 1 else 0,
                           batch=_cluster_layout(m, cols, fused, elem)[1])


def _words(ints) -> np.ndarray:
    """int32 values as the float32 words that hold their bits, padded to an
    even count (a float2 after them stays 8-byte aligned)."""
    v = list(ints) + [0] * (len(ints) % 2)
    return np.asarray(v, np.int32).view(np.float32)


def _inter32(c) -> np.ndarray:
    """complex values as interleaved (re, im) float32"""
    c = np.asarray(c, np.complex128).reshape(-1)
    return np.stack([c.real, c.imag], -1).reshape(-1).astype(np.float32)


def leaf_tables(L: int) -> np.ndarray:
    """The leaf's plan as float32 words (int32 bits where an int):

      header      npass, perm's word offset, then per pass R, Lc, nq = L /
                  R and the word offset of its data (all from the header)
      perm        L ints: the position of frequency t
      per pass    pos [nq] ints: the first point of butterfly jj (block jj
                  // Lc, j = jj % Lc: block Lp + j); then for R <=
                  LEAF_MAX_RADIX (cos, sin)(2 pi t / R), t = 1..(R - 1)/2,
                  and, for Lc > 1, W_Lp^(j s) at [jj][s - 1]; for a
                  Bluestein prime p (Lc = 1): the chirp exp(-i pi (t^2 mod
                  2p) / p), t < p; the filter's N-point spectrum
                  FFT(conj(chirp) on (-p, p), cyclic) / N; W_N^(k1 n2) at
                  [n2][k1] (k1 < 32); W_32^t, t < 32.
    Every value is fp64 on the host, cast once."""
    lp = leaf_plan(L)
    npass = len(lp.radices)
    head = 2 + 4 * npass + (4 * npass + 2) % 2
    parts, at = [], head
    perm_at = at
    parts.append(_words(lp.perm))
    at += parts[-1].size
    entries = []
    for r, lc in zip(lp.radices, lp.strides):
        nq, lp_ = L // r, r * lc
        jj = np.arange(nq)
        blk, j = jj // lc, jj % lc
        data = [_words(blk * lp_ + j)]
        if r <= LEAF_MAX_RADIX:
            t = np.arange(1, (r - 1) // 2 + 1)
            data.append(np.stack([np.cos(2 * np.pi * t / r),
                                  np.sin(2 * np.pi * t / r)], -1)
                        .reshape(-1).astype(np.float32))
            if lc > 1:
                s_ = np.arange(1, r)
                data.append(_inter32(np.exp(-2j * np.pi * np.outer(j, s_)
                                            / lp_)))
        else:
            p, n = r, lp.bluestein
            t = np.arange(p)
            chirp = np.exp(-1j * np.pi * ((t * t) % (2 * p)) / p)
            b = np.zeros(n, np.complex128)
            b[t] = np.conj(chirp)
            b[(-t[1:]) % n] = np.conj(chirp[1:])
            n2 = n // BLUESTEIN_N1
            k1, q2 = np.meshgrid(np.arange(BLUESTEIN_N1), np.arange(n2))
            data += [_inter32(chirp), _inter32(np.fft.fft(b) / n),
                     _inter32(np.exp(-2j * np.pi * k1 * q2 / n)),
                     _inter32(_roots(BLUESTEIN_N1, BLUESTEIN_N1))]
        entries += [r, lc, nq, at]
        parts += data
        at += sum(d.size for d in data)
    header = _words([npass, perm_at] + entries)
    return np.concatenate([header] + parts)


def cluster_tables(consts: PipelineConstants) -> np.ndarray:
    """The cluster body's constants, one float32 vector (fp64 on the host,
    cast once; the kernels compute no sine at run time):

      [0, m)                 w_r c, the real range window and scale
      [m, m + 2P)            W_P^t (re, im), t < P
      then 2 L P             W_ms^(k r2) at (r2 P + k): the leaf's twiddles
      then 2 S ms            W_m^(b k1) at (b ms + k1): the cluster's twiddles
      then 2 S               W_S^t, t < S: the combine across the blocks
      then (L > 1)           the leaf's plan, `leaf_tables`."""
    m = consts.op_a_half.shape[1]
    S, ms, P, L, _, _ = _cluster_factors(m)
    wr_c = np.asarray(consts.op_a_half[0]).astype(np.complex128).real
    k, r2 = np.meshgrid(np.arange(P), np.arange(L))          # [L, P]
    leaf_tw = _roots(ms, ms)[(k * r2) % ms]
    b, k1 = np.meshgrid(np.arange(S), np.arange(ms), indexing="ij")
    ctw = _roots(m, m)[(b * k1) % m]                          # [S, ms]
    head = np.concatenate([wr_c.astype(np.float32), _inter32(_roots(P, P)),
                           _inter32(leaf_tw), _inter32(ctw),
                           _inter32(_roots(S, S))])
    if L == 1:
        return head
    return np.concatenate([head, leaf_tables(L)])


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    """Device-resident constants of the fused chain for one geometry."""

    radix: int
    m: int
    n: int
    a: torch.Tensor          # [R, 2, M, M] f32: re/im of A_p[t, q]; R == 1: [1, 2, m/2, m]
    a_kernel: torch.Tensor   # [R, M(q), M(t), 2] f32: the kernel's layout of `a`
    fac: tuple               # [S][R] python complex combine factors
    fac_t: torch.Tensor      # [S, R, 2] f32 (re, im) of fac
    wd: torch.Tensor         # [n] f32 pulse window
    phasors: torch.Tensor    # [4, n] f32 clip-bin phasors
    fft_t: torch.Tensor | None = None   # fft_tables (every m that fft_takes)
    fft_phi: torch.Tensor | None = None  # [rounds, 4] fft_round_phasor_sums at n
    cluster_t: torch.Tensor | None = None    # cluster_tables (every m that cluster_takes)
    #: [rounds, 4] at the cluster geometry's cols, the one cut both fused
    #: chains (#3/#4 and #7/#8, int16 or f32) launch at
    cluster_phi: torch.Tensor | None = None
    #: a radix plan whose chains take the matrix kernel (an m the cluster
    #: body refuses: 16 x p above CLUSTER_MAX_M8, p a prime whose Bluestein
    #: length passes BLUESTEIN_MAX_N; above CLUSTER_MAX_M): the host's
    #: A_half [m/2, m] complex, from which `dense_operator` builds its
    #: operator
    host_a_half: np.ndarray | None = dataclasses.field(default=None,
                                                       repr=False)
    _dense_op: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def device(self) -> torch.device:
        return self.a.device

    def dense_operator(self) -> torch.Tensor:
        """The matrix kernel's operator, A_half as [m(q), m/2(t), 2] f32 on
        the plan's device: a radix-1 plan's `a_kernel`; for a radix plan
        whose chains take the matrix kernel built from `host_a_half` at
        first use and kept (it holds m^2 / 2 complex values: 278 MB at m =
        8336, so only a plan that launches the matrix kernel pays for it;
        the chains at 8320 do not)."""
        if self.radix == 1:
            return self.a_kernel
        if self.host_a_half is None:
            raise ValueError(
                f"m={self.m}: a radix plan takes the matrix kernel only at an "
                f"m the cluster body refuses (16 x p above CLUSTER_MAX_M8 = "
                f"{CLUSTER_MAX_M8}, p a prime whose Bluestein length passes "
                f"BLUESTEIN_MAX_N = {BLUESTEIN_MAX_N}; above CLUSTER_MAX_M = "
                f"{CLUSTER_MAX_M}); chain_route({self.m}) is "
                f"{chain_route(self.m)!r}")
        if "a" not in self._dense_op:
            a = np.asarray(self.host_a_half)
            # C order: the stack of transposed views keeps their strides
            planes = np.ascontiguousarray(np.stack([a.real.T, a.imag.T], -1),
                                          dtype=np.float32)
            self._dense_op["a"] = torch.from_numpy(planes).to(self.device)
        return self._dense_op["a"]

    @property
    def fft(self) -> FftGeometry:
        """The FFT-form kernels' cut of the plan's m x n."""
        return fft_geometry(self.m, self.n)

    @property
    def cluster(self) -> ClusterGeometry:
        """The cluster body's cut of the plan's m x n for the fused chains
        (the cut `cluster_phi` is summed at)."""
        return cluster_geometry(self.m, self.n)


def radix_plan(consts: PipelineConstants, radix: int):
    """Host constants in float64: (a [R, M, M] complex branch operators
    A_p[t, q], fac [S][R] complex combine factors).

    w_r c is recovered from the dense operator's row 0 (A[0, j] = w_r[j] c,
    since row 0 of the DFT matrix is all ones), as wrp_tpu's
    radix_plan_host does; the twiddles T_p[t] = exp(-2 pi i p t / m) are
    folded in, so the kernel never multiplies them at run time."""
    m = consts.op_a_half.shape[1]
    M = m // radix
    S = (m // 2) // M
    wr_c = np.asarray(consts.op_a_half[0]).astype(np.complex128).real
    fm = dft_matrix(M)
    t = np.arange(M)
    a = np.stack([fm * wr_c[p::radix][None, :]
                  * np.exp(-2j * np.pi * p * t / m)[:, None]
                  for p in range(radix)])
    om = np.exp(-2j * np.pi * M / m)
    fac = tuple(tuple(_snap(om ** (p * s)) for p in range(radix))
                for s in range(S))
    return a, fac


def build_plan(consts: PipelineConstants, device) -> RadixPlan:
    """The plan for `consts`' geometry, on `device` (every channel count:
    the wire kernel reads the planar window and phasors)."""
    m = consts.op_a_half.shape[1]
    n = consts.wd.shape[0]
    radix = radix_for(m)
    if radix > 1:
        a, fac = radix_plan(consts, radix)
    else:
        a, fac = consts.op_a_half.astype(np.complex128)[None], ()
    planes = np.stack([a.real, a.imag], axis=1).astype(np.float32)
    a_t = torch.from_numpy(planes).to(device)
    fac_np = np.array([[[f.real, f.imag] for f in row] for row in fac],
                      np.float32).reshape(len(fac), radix, 2)
    lanes = {}
    if fft_takes(m):
        lanes["fft_t"] = torch.from_numpy(fft_tables(consts)).to(device)
        lanes["fft_phi"] = torch.from_numpy(fft_round_phasor_sums(
            consts.clip_phasors, fft_geometry(m, n).cols)).to(device)
    if radix > 1 and chain_route(m) == "matrix":
        lanes["host_a_half"] = consts.op_a_half
    if cluster_takes(m):
        lanes["cluster_t"] = torch.from_numpy(cluster_tables(consts)).to(device)
        lanes["cluster_phi"] = torch.from_numpy(fft_round_phasor_sums(
            consts.clip_phasors, cluster_geometry(m, n).cols)).to(device)
    return RadixPlan(
        radix=radix, m=m, n=n,
        a=a_t,
        a_kernel=a_t.permute(0, 3, 2, 1).contiguous(),
        fac=fac,
        fac_t=torch.from_numpy(fac_np).to(device),
        wd=torch.from_numpy(np.asarray(consts.wd, np.float32)).to(device),
        phasors=torch.from_numpy(
            np.asarray(consts.clip_phasors, np.float32)).to(device),
        **lanes,
    )


def _contract_reference(x: torch.Tensor, plan: RadixPlan):
    """The contraction and combine of x [bc, 2, m, w] (any w, natural row
    order) -> (yr, yi) [bc, m/2, w] f32: per-branch fp32 matmuls on the
    strided row views x[..., p::R, :] and the generic complex combine;
    R == 1 contracts the dense A_half."""
    xf = x.to(torch.float32)
    xr, xi = xf[:, 0], xf[:, 1]
    ar, ai = plan.a[:, 0], plan.a[:, 1]
    R = plan.radix
    if R == 1:
        return ar[0] @ xr - ai[0] @ xi, ar[0] @ xi + ai[0] @ xr
    S = len(plan.fac)
    ys_r = [0.0] * S
    ys_i = [0.0] * S
    for p in range(R):
        vr, vi = xr[:, p::R, :], xi[:, p::R, :]
        gr = ar[p] @ vr - ai[p] @ vi
        gi = ar[p] @ vi + ai[p] @ vr
        for s in range(S):
            f = plan.fac[s][p]
            ys_r[s] = ys_r[s] + (f.real * gr - f.imag * gi)
            ys_i[s] = ys_i[s] + (f.real * gi + f.imag * gr)
    return torch.cat(ys_r, dim=-2), torch.cat(ys_i, dim=-2)


def fused_chain_power_reference(x: torch.Tensor, plan: RadixPlan,
                                salt: int | None = None) -> torch.Tensor:
    """Plain torch version of the radix and dense kernels: x [bc, 2, m, n]
    int16/f32 in natural row order -> pow [bc, m/2] f32.  The contraction
    (`_contract_reference`), then the Parseval epilogue; `salt` is added to
    every sample after its conversion to f32 (the salted kernels)."""
    if salt is not None:
        x = x.to(torch.float32) + float(salt)
    yr, yi = _contract_reference(x, plan)
    return stage_b_parseval(yr, yi, plan.wd, plan.phasors)


def _fft_plan_tables(plan: RadixPlan, name: str):
    """(geometry at the plan's n, the fft_tables split into complex64
    tensors: win [m] f32, tw [P], leaf_tw [L, P], roots [L])."""
    if plan.fft_t is None:
        raise ValueError(f"{name}: the FFT-form kernels take an even m <= "
                         f"{FFT_SHORT_M} and the dense entries' m = 2 x odd "
                         f"in (2048, FFT_MAX_M = {FFT_MAX_M}] (m={plan.m})")
    g = plan.fft
    m, P, L = plan.m, g.P, g.L
    t = plan.fft_t

    def cplx(lo, count):
        v = t[lo:lo + 2 * count].reshape(count, 2)
        return torch.complex(v[:, 0], v[:, 1])

    tw = cplx(m, P)
    leaf_tw = cplx(m + 2 * P, L * P).reshape(L, P)
    roots = cplx(m + 2 * P + 2 * L * P, L)
    return g, t[:m], tw, leaf_tw, roots


def leaf_fft_reference(z: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """The leaf's L-point DFT along dim 1 of z [b, L, ...] (complex): the
    kernel's mixed-radix Stockham passes (csrc/fft_chain.cuh leaf_pass),
    one per factor `leaf_radix` gives, with every factor indexed from
    `roots` = W_L^t, t < L.  Pass of radix R after factors of product ns:
    v_r = z[j + r L/R] W_(ns R)^(r (j mod ns)), an R-point DFT, output s to
    (j // ns) ns R + j mod ns + s ns.  Returns the natural-order DFT."""
    L = z.shape[1]
    rem, ns = L, 1
    while rem > 1:
        R = leaf_radix(rem)
        lr = L // R
        j = torch.arange(lr)
        r = torch.arange(R)
        v = z.reshape(z.shape[0], R, lr, *z.shape[2:])         # [b, r, j, ...]
        tw = roots[(r[:, None] * (j % ns)[None, :] * (L // (ns * R))) % L]
        v = v * tw.reshape(1, R, lr, *([1] * (z.dim() - 2)))
        f = roots[((r[:, None] * r[None, :]) % R) * lr]      # [s, r]
        o = torch.einsum("sr,brj...->bsj...", f, v)
        d = (j // ns) * ns * R + j % ns
        out = torch.empty_like(z)
        out[:, (d[None, :] + r[:, None] * ns).reshape(-1)] = o.reshape(z.shape)
        z, rem, ns = out, rem // R, ns * R
    return z


def fft_stage_reference(x: torch.Tensor, plan: RadixPlan,
                        salt: int | None = None):
    """Plain torch version of the FFT-form kernels' range stage: x [bc, 2,
    m, w] int16/f32 (natural row order, any w) -> (yr, yi) [bc, m/2, w] f32,
    Y[k, j] = sum_r W_m^(k r) (w_r c)[r] (x[r, j] + salt (1 + i)), k < m/2.

    The kernels' stages, written out: the window and salt on load; per
    decimated sub-sequence r2 (rows L i + r2), the four-step P-point FFT
    (a P1-point DFT over n1 of rows i = P2 n1 + n2, the twiddle
    W_P^(k1 n2), a P2-point DFT over n2, X[k1 + P1 k2]); for L > 1 the
    leaf's twiddle W_m^(k r2) and L-point DFT (`leaf_fft_reference`),
    Y[k + P k2]; the crop.  Every factor comes from the plan's float32
    tables (fft_tables)."""
    g, win, tw, leaf_tw, roots = _fft_plan_tables(plan, "fft_stage_reference")
    xf = x.to(torch.float32)
    if salt is not None:
        xf = xf + float(salt)
    xw = xf * win[:, None]
    v = torch.complex(xw[:, 0], xw[:, 1])                  # [bc, m, w]
    y = _fft_points(v, g.P1, g.P2, tw, leaf_tw, roots)[:, : x.shape[2] // 2]
    return y.real.contiguous(), y.imag.contiguous()


def _pow2_points(v: torch.Tensor, P1: int, P2: int,
                 tw: torch.Tensor) -> torch.Tensor:
    """The four-step P-point DFTs (P = P1 P2) of v [bc, m, w] complex over
    the decimated rows L i + r2 (L = m / P): X [bc, L(r2), P(k), w], the
    P1-point DFT over n1 of rows i = P2 n1 + n2, the twiddle W_P^(k1 n2),
    the P2-point DFT over n2 (k = k1 + P1 k2), on the twiddles W_P `tw`."""
    P = P1 * P2
    bc, m, w = v.shape
    v = v.reshape(bc, P, m // P, w).permute(0, 2, 1, 3)    # [bc, L, P(i), w]
    v = v.reshape(bc, m // P, P1, P2, w)                   # i = P2 n1 + n2
    a1 = torch.arange(P1)
    a2 = torch.arange(P2)
    f1 = tw[(a1[:, None] * a1[None, :] * P2) % P]          # [k1, n1]
    a = torch.einsum("kn,blnqw->blkqw", f1, v)
    a = a * tw[(a1[:, None] * a2[None, :]) % P][None, None, :, :, None]
    f2 = tw[(a2[:, None] * a2[None, :] * (P // P2)) % P]   # [k2, n2]
    xk = torch.einsum("jq,blkqw->bljkw", f2, a)            # [bc, L, k2, k1, w]
    return xk.reshape(bc, m // P, P, w)                    # k = k1 + P1 k2


def _fft_points(v: torch.Tensor, P1: int, P2: int, tw: torch.Tensor,
                leaf_tw: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """The FFT-form kernels' DFT of v [bc, m, w] complex along dim 1, m = P
    L (P = P1 P2, L = len(roots)), in natural order: the steps
    `fft_stage_reference` writes out, on the twiddles W_P `tw`, the leaf's
    `leaf_tw` [L, P] and its roots."""
    bc, m, w = v.shape
    xk = _pow2_points(v, P1, P2, tw)
    if roots.shape[0] > 1:
        xk = leaf_fft_reference(xk * leaf_tw[None, :, :, None],
                                roots)                     # [bc, k2, k, w]
    return xk.reshape(bc, m, w)


def merged_epilogue_reference(yr: torch.Tensor, yi: torch.Tensor,
                              plan: RadixPlan, cols: int | None = None,
                              blocks: int | None = None) -> torch.Tensor:
    """Plain torch version of the FFT-form fused kernel's epilogue: Y [bc,
    rows, n] -> pow [bc, rows] f32, the Parseval power of
    `pipeline.stage_b_parseval` from chunked partials merged exactly.

    The columns split into chunks of `cols`, dealt round-robin to
    `blocks` blocks (round r of block b: chunk r blocks + b).  Per row, the block
    first shifts q = Y wd by its own first column's value s_b (exact where
    a DC line dominates, so every later sum is of values at the noise's
    scale, not the line's).  Per round: the mean mu_r, E_r = sum |q -
    mu_r|^2 and the projections P_rc = sum (q - mu_r) ph_c (two passes).
    A block's rounds merge in order (Chan's pairwise form, as a thread
    does in registers); then the blocks' partials merge in closed form (as
    the cluster does), with mu_b = (s_b - s_0) + the block's shifted mean:
    mu = sum n_b mu_b / n, E = sum [E_b + n_b |mu_b - mu|^2], D_c = sum
    [P_bc + (mu_b - mu) Phi_bc], Phi_bc the chunk's phasor sums.  Then
    pow = n E - |q.f_k1|^2 - |q.f_k2|^2 as there.  No large quantity
    cancels.  `cols` and `blocks` default to the kernel's (the plan's
    FftGeometry); any chunking gives the same power."""
    n = yr.shape[-1]
    cols = cols or fft_geometry(plan.m, n).cols
    chunks = _cdiv(n, cols)
    K = min(blocks or FFT_MAX_CLUSTER, chunks)
    rounds = _cdiv(chunks, K)
    pad = rounds * K * cols - n
    ph = plan.phasors.to(torch.float32)
    if plan.fft_phi is not None and n == plan.n and cols == plan.fft.cols:
        phi = plan.fft_phi.cpu()       # the kernel's table
    elif (plan.cluster_phi is not None and n == plan.n
          and cols == plan.cluster.cols):
        phi = plan.cluster_phi.cpu()   # the cluster body's
    else:
        phi = torch.from_numpy(fft_round_phasor_sums(ph.cpu().numpy(), cols))

    def by_block(t):
        # [..., rounds * K * cols] -> [..., K, rounds, cols]: chunk r K + b
        t = t.reshape(*t.shape[:-1], rounds, K, cols)
        return t.transpose(-3, -2)

    q = torch.complex(yr * plan.wd, yi * plan.wd)
    q = torch.view_as_complex(torch.nn.functional.pad(
        torch.view_as_real(q), (0, 0, 0, pad)).contiguous())
    q = by_block(q)                                        # [.., K, rounds, cols]
    valid = by_block(torch.nn.functional.pad(torch.ones(n), (0, pad)))
    php = by_block(torch.nn.functional.pad(ph, (0, pad)))  # [4, K, rounds, cols]
    phi = torch.nn.functional.pad(phi, (0, 0, 0, rounds * K - chunks))
    phi = phi.reshape(rounds, K, 4).transpose(0, 1).to(q.device)

    cnt = valid.sum(-1).to(q.device)                       # [K, rounds]
    valid = valid.to(q.device)
    shift = q[..., 0, 0]                                   # [.., K]
    q = (q - shift[..., None, None]) * valid
    mu_r = q.sum(-1) / cnt.clamp(min=1)                    # [.., K, rounds]
    c = (q - mu_r[..., None]) * valid
    e_r = (c.real * c.real + c.imag * c.imag).sum(-1)
    p_r = torch.einsum("...krc,xkrc->...krx", c, php.to(c.dtype))

    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    n_a = torch.zeros(K, device=q.device)
    mu = torch.zeros_like(mu_r[..., 0])
    e = torch.zeros_like(e_r[..., 0])
    d = torch.zeros_like(p_r[..., 0, :])
    phi_a = torch.zeros(K, 4, device=q.device)
    for r in range(rounds):           # a thread's running merge, in order
        nb = cnt[:, r]
        live = nb > 0
        tot = torch.where(live, n_a + nb, torch.ones_like(nb))
        f = torch.where(live, nb / tot, zero)
        delta = mu_r[..., r] - mu
        mu = mu + f * delta
        e = e + e_r[..., r] + n_a * f * (delta.real ** 2 + delta.imag ** 2)
        d = (d - (f * delta)[..., None] * phi_a
             + p_r[..., r, :] + ((1 - f) * delta)[..., None] * phi[:, r])
        phi_a = phi_a + phi[:, r]
        n_a = n_a + nb
    # the cluster's closed-form merge across the K blocks, about block 0's
    # shift
    mu = mu + (shift - shift[..., :1])
    mu_all = (n_a * mu).sum(-1) / n
    dm = mu - mu_all[..., None]
    e_all = (e + n_a * (dm.real ** 2 + dm.imag ** 2)).sum(-1)
    d_all = (d + dm[..., None] * phi_a).sum(-2)            # [.., 4] complex
    dr, di = d_all.real, d_all.imag
    pw = n * e_all
    for cc, sn in ((0, 1), (2, 3)):
        re = dr[..., cc] - di[..., sn]
        im = dr[..., sn] + di[..., cc]
        pw = pw - (re * re + im * im)
    return pw


def _cluster_plan_tables(plan: RadixPlan, name: str) -> dict:
    """The cluster_tables of the plan, split into tensors on the table's
    device: geometry (at the plan's n), win [m] f32, tw [P], leaf_tw
    [L, P], ctw [S, ms], ws [S] (complex64), and for L > 1 the leaf's perm
    and passes (`parse_leaf_tables`)."""
    if plan.cluster_t is None:
        raise ValueError(f"{name}: " + (cluster_refusal(plan.m)
                                         or f"m={plan.m} takes another route"))
    g = plan.cluster
    m, P, L, ms, S = plan.m, g.P, g.L, g.ms, g.S
    t = plan.cluster_t
    at = [m]

    def cplx(count):
        v = t[at[0]:at[0] + 2 * count].reshape(count, 2)
        at[0] += 2 * count
        return torch.complex(v[:, 0], v[:, 1])

    out = {"geometry": g, "win": t[:m], "tw": cplx(P),
           "leaf_tw": cplx(L * P).reshape(L, P),
           "ctw": cplx(S * ms).reshape(S, ms), "ws": cplx(S), "passes": []}
    if L > 1:
        out.update(parse_leaf_tables(t[at[0]:], L, g.bluestein))
    return out


def parse_leaf_tables(t: torch.Tensor, L: int, n: int) -> dict:
    """`leaf_tables(L)` (float32 words t, on any device) split into tensors:
    perm [L] and `passes`, each {R, Lc, pos, cs, sn, tw} or, for a
    Bluestein prime (convolution length n), {R, Lc, pos, n, chirp, bh,
    ftw, r32}; complex ones complex64."""
    words = t.view(torch.int32)

    def ints(lo, count):
        return words[lo:lo + count].long()

    def cplx(lo, count):
        v = t[lo:lo + 2 * count].reshape(count, 2)
        return torch.complex(v[:, 0], v[:, 1])

    npass, perm_at = ints(0, 2).tolist()
    out = {"perm": ints(perm_at, L), "passes": []}
    for i in range(npass):
        r, lc, nq, off = ints(2 + 4 * i, 4).tolist()
        ps = {"R": r, "Lc": lc, "pos": ints(off, nq)}
        data = off + nq + nq % 2
        if r <= LEAF_MAX_RADIX:
            h = (r - 1) // 2
            cs = t[data:data + 2 * h].reshape(h, 2)
            ps["cs"], ps["sn"] = cs[:, 0], cs[:, 1]
            if lc > 1:
                ps["tw"] = cplx(data + 2 * h, nq * (r - 1)).reshape(nq, r - 1)
        else:
            ps.update(n=n, chirp=cplx(data, r), bh=cplx(data + 2 * r, n),
                      ftw=cplx(data + 2 * (r + n), n).reshape(
                          n // BLUESTEIN_N1, BLUESTEIN_N1),
                      r32=cplx(data + 2 * (r + 2 * n), BLUESTEIN_N1))
        out["passes"].append(ps)
    return out


def _odd_dft_reference(v: torch.Tensor, cs: torch.Tensor,
                       sn: torch.Tensor) -> torch.Tensor:
    """The leaf's register DFT of an odd prime R along dim 2 of v [b, nb,
    R, ...] (csrc/cluster_chain.cuh dft_odd): a_r = v_r + v_(R-r), b_r =
    v_r - v_(R-r) (r = 1..H, H = (R - 1) / 2), X_0 = v_0 + sum a_r, and
    for s = 1..H, C = v_0 + sum a_r cos(2 pi r s / R), T = sum b_r sin(2
    pi r s / R): X_s = C - i T, X_(R-s) = C + i T, each cos and sin one of
    the table's H (cs, sn), folded."""
    R = v.shape[2]
    h = (R - 1) // 2
    e = (torch.arange(1, h + 1)[:, None] * torch.arange(1, h + 1)[None, :]) % R
    f = torch.where(e <= h, e, R - e) - 1                  # [s, r]
    cm = cs.to(v.device)[f]
    sm = torch.where(e <= h, 1.0, -1.0).to(sn.dtype).to(v.device) * sn.to(
        v.device)[f]
    v0, vr = v[:, :, :1], v[:, :, 1:h + 1]
    vm = v[:, :, torch.arange(R - 1, h, -1, device=v.device)]   # v_(R-r)
    a, b = vr + vm, vr - vm
    c = v0 + torch.einsum("sr,bnr...->bns...", cm.to(v.dtype), a)
    tt = torch.einsum("sr,bnr...->bns...", sm.to(v.dtype), b)
    itt = torch.complex(-tt.imag, tt.real)                 # i T
    return torch.cat([v0 + a.sum(2, keepdim=True), c - itt,
                      (c + itt).flip(2)], 2)


def _bluestein_reference(v: torch.Tensor, ps: dict) -> torch.Tensor:
    """The leaf's p-point DFT along dim 2 of v [b, nb, p, T] in Bluestein's
    form, the kernel's steps (csrc/cluster_chain.cuh bluestein_pass): the
    chirped inputs, zero-padded to N = 32 N2 at t = N2 n1 + n2; a 32-point
    DFT over n1, W_N^(k1 n2); an N2-point DFT over n2 (A[k1 + 32 k2]), times
    the filter's spectrum; conjugated, an N2-point DFT over k2, W_N^(k1 n2);
    a 32-point DFT over k1; conjugated (the inverse transform, 1/N in the
    filter), times the chirp: X_t for t < p."""
    b, nb, p, tcols = v.shape
    n, n1 = ps["n"], BLUESTEIN_N1
    n2 = n // n1
    r32, chirp, bh = (ps[k].to(v.device, v.dtype) for k in ("r32", "chirp", "bh"))
    ftw = ps["ftw"].to(v.device, v.dtype).transpose(0, 1)  # ftw [k1, n2]
    q1 = torch.arange(n1)
    q2 = torch.arange(n2)
    e1 = r32[(q1[:, None] * q1[None, :]) % n1]             # W_32^(k1 n1)
    e2 = r32[((q2[:, None] * q2[None, :]) * (n1 // n2)) % n1]
    a = torch.zeros(b, nb, n, tcols, dtype=v.dtype, device=v.device)
    a[:, :, :p] = v * chirp[None, None, :, None]
    a = a.reshape(b, nb, n1, n2, tcols)                    # [n1, n2]
    u = torch.einsum("kn,bjnqw->bjkqw", e1, a) * ftw[None, None, :, :, None]
    y = torch.einsum("kq,bjnqw->bjnkw", e2, u)             # [k1, k2]
    y = y * bh.reshape(n2, n1).transpose(0, 1)[None, None, :, :, None]
    z = torch.einsum("qk,bjnkw->bjnqw", e2, y.conj())      # [k1, n2']
    z = z * ftw[None, None, :, :, None]
    o = torch.einsum("mk,bjkqw->bjmqw", e1, z)             # [n1', n2']
    c = o.conj().reshape(b, nb, n, tcols)[:, :, :p]        # t = N2 n1' + n2'
    return c * chirp[None, None, :, None]


def cluster_leaf_reference(z: torch.Tensor, tables: dict) -> torch.Tensor:
    """The cluster body's leaf on z [b, L, ...] (complex, natural r2 order,
    its twiddles W_ms^(k r2) applied): the in-place passes of `leaf_plan`
    (`_odd_dft_reference`, `_bluestein_reference`, each pass's twiddles
    from the table), then frequency t read at position perm[t].  Returns
    the natural-order L-point DFT along dim 1."""
    shape = z.shape
    L = shape[1]
    z = z.reshape(shape[0], L, -1)
    for ps in tables["passes"]:
        r, lc = ps["R"], ps["Lc"]
        v = z.reshape(z.shape[0], L // (r * lc), r, lc, -1)
        if r > LEAF_MAX_RADIX:                             # Lc = 1: the last
            x = _bluestein_reference(v[:, :, :, 0], ps)[:, :, :, None]
        else:
            x = _odd_dft_reference(v, ps["cs"], ps["sn"])
            if lc > 1:                                     # W_Lp^(j s)
                tw = ps["tw"].reshape(L // (r * lc), lc, r - 1)
                x = torch.cat([x[:, :, :1], x[:, :, 1:] * tw.permute(
                    0, 2, 1)[None, :, :, :, None]], 2)
        z = x.reshape(z.shape)
    return z[:, tables["perm"].to(z.device)].reshape(shape)


def _split_dft(f: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The kept outputs k2 < S / 2 of the S-point DFT along dim 1 of f [bc,
    S, ...] (csrc/cluster_chain.cuh's combine), ws = W_S^t, t < S: S = 16,
    E[k2] + W_16^k2 O[k2] (E, O the 8-point DFTs of the even and odd
    blocks, `_dft8`); S = 8, E[k2] + W_8^k2 O[k2] (E, O the 4-point DFTs
    of the even and odd blocks, exact in +-1, +-i); S = 4, the 4-point
    DFT's outputs 0, 1; S = 2, f_0 + f_1."""
    S = f.shape[1]
    if S == 16:
        w8 = ws[0:8:2]                                     # W_8^t, t < 4
        e, o = _dft8(f[:, 0::2], w8), _dft8(f[:, 1::2], w8)
        return e + o * ws[:8].reshape(1, 8, *([1] * (f.dim() - 2)))
    if S == 8:
        e, o = _dft4(f[:, 0::2]), _dft4(f[:, 1::2])
        return e + o * ws[:4].reshape(1, 4, *([1] * (f.dim() - 2)))
    if S == 4:
        return _dft4(f)[:, :2]
    return f[:, :1] + f[:, 1:]


def _dft8(g: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The 8-point DFT along dim 1 of g [bc, 8, ...] in the kernel's order
    (csrc/cluster_chain.cuh join8): a, c the 4-point DFTs of the even and
    odd points, then a[k] + W_8^k c[k] and a[k] - W_8^k c[k], k < 4 (w8 =
    W_8^k)."""
    a, c = _dft4(g[:, 0::2]), _dft4(g[:, 1::2])
    v = c * w8.reshape(1, 4, *([1] * (g.dim() - 2)))
    return torch.cat([a + v, a - v], 1)


def _dft4(g: torch.Tensor) -> torch.Tensor:
    """The 4-point DFT along dim 1 of g [bc, 4, ...] (W_4 = -i, exact), in
    the kernel's order (csrc/cluster_chain.cuh dft4)."""
    s, a = g[:, 0] + g[:, 2], g[:, 0] - g[:, 2]
    t, d = g[:, 1] + g[:, 3], g[:, 1] - g[:, 3]
    jd = torch.complex(-d.imag, d.real)                   # i d
    return torch.stack([s + t, a - jd, s - t, a + jd], 1)


def cluster_stage_reference(x: torch.Tensor, plan: RadixPlan,
                            salt: int | None = None):
    """Plain torch version of the cluster body's range stage
    (csrc/cluster_chain.cuh): x [bc, 2, m, w] int16/f32 (natural row order,
    any w) -> (yr, yi) [bc, m/2, w] f32, Y[k, j] = sum_r W_m^(k r) (w_r c)[r]
    (x[r, j] + salt (1 + i)), k < m/2, by the kernel's steps: the window and
    salt on load; decimate the rows by S (block b: rows S t + b, t < ms =
    m / S); each block's ms-point DFT F_b (the P-point register DFTs,
    `_pow2_points`; for L > 1 the leaf's twiddle W_ms^(k r2) and its
    passes, `cluster_leaf_reference`); the twiddle W_m^(b k1); the kept
    outputs k2 < S / 2 of the S-point DFT across the blocks (`_split_dft`),
    Y[k1 + ms k2].  Every factor comes from the plan's float32 tables
    (cluster_tables)."""
    tb = _cluster_plan_tables(plan, "cluster_stage_reference")
    g = tb["geometry"]
    S = g.S
    bc, _, m, w = x.shape
    xf = x.to(torch.float32)
    if salt is not None:
        xf = xf + float(salt)
    xw = xf * tb["win"][:, None]
    v = torch.complex(xw[:, 0], xw[:, 1]).reshape(bc, g.ms, S, w)
    v = v.transpose(1, 2).reshape(bc * S, g.ms, w)         # [bc b, t, w]
    f = _pow2_points(v, g.P1, g.P2, tb["tw"])              # [bc b, L, P, w]
    if g.L > 1:
        f = cluster_leaf_reference(f * tb["leaf_tw"][None, :, :, None], tb)
    f = f.reshape(bc, S, g.ms, w) * tb["ctw"][None, :, :, None]
    y = _split_dft(f, tb["ws"]).reshape(bc, m // 2, w)     # [bc, k2, k1, w]
    return y.real.contiguous(), y.imag.contiguous()


def cluster_chain_power_reference(x: torch.Tensor, plan: RadixPlan,
                                  salt: int | None = None) -> torch.Tensor:
    """Plain torch version of the cluster body's fused chains (#3/#4 on
    planar samples, #7/#8 on the decoded wire): x [bc, 2, m, n] int16/f32
    -> pow [bc, m/2] f32, with `salt` added to every sample after its
    conversion to f32, the range stage
    (`cluster_stage_reference`) then the epilogue of one block a row
    (`merged_epilogue_reference` with blocks = 1 at the geometry's cols:
    every column of a row passes through the block that owns it)."""
    yr, yi = cluster_stage_reference(x, plan, salt)
    return merged_epilogue_reference(yr, yi, plan, cols=plan.cluster.cols,
                                     blocks=1)


def fft_chain_power_reference(x: torch.Tensor, plan: RadixPlan,
                              salt: int | None = None) -> torch.Tensor:
    """Plain torch version of the FFT-form fused chain kernels (radix,
    wire, salted, and the dense entries for every m `fft_takes`): x [bc,
    2, m, n] int16/f32 -> pow [bc, m/2] f32, the
    range stage (`fft_stage_reference`) then the merged epilogue
    (`merged_epilogue_reference`) at the kernel's chunk sizes."""
    yr, yi = fft_stage_reference(x, plan, salt)
    return merged_epilogue_reference(yr, yi, plan)


def dense_tile(plan: RadixPlan) -> int:
    """Tallest dense tile T dividing m/2 whose Y rows [T, n] and operator
    slice [DENSE_KQ, T] fit in shared memory (T = 10 at m = 1000, 45 KB)."""
    mh = plan.m // 2
    for t in DENSE_TILES:
        if mh % t == 0 and (2 * t * plan.n + 2 * t * DENSE_KQ) * 4 <= MAX_SMEM_BYTES:
            return t
    raise ValueError(f"no dense tile fits m={plan.m}, n={plan.n} in "
                     f"{MAX_SMEM_BYTES} bytes of shared memory")


def _check_planar(x: torch.Tensor, plan: RadixPlan, name: str) -> None:
    if x.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"{name}: x must be int16 or float32, got {x.dtype}")
    if x.dim() != 4 or tuple(x.shape[1:]) != (2, plan.m, plan.n):
        raise ValueError(f"{name}: x must be [bc, 2, {plan.m}, {plan.n}], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if plan.device != x.device:
        raise ValueError(f"{name}: plan is on {plan.device}, x on {x.device}")


def _raise_on_error(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.wrp_cuda_error_string(rc).decode())


def _slab(units: int, offset, count, salt, name: str, what: str):
    """(start, count) of the units an entry reads: all `units` without an
    offset; else `count` from `offset`, which must lie inside the staged
    array.  `count` and `salt` apply only with an offset."""
    if offset is None:
        if count is not None or salt is not None:
            raise ValueError(f"{name}: {what} and salt apply with an offset")
        return 0, units
    if count is None:
        raise ValueError(f"{name}: an offset needs {what}")
    start, count = int(offset), int(count)
    if start < 0 or count < 0 or start + count > units:
        raise ValueError(f"{name}: units [{start}, {start + count}) lie outside "
                         f"the {units} staged")
    if salt is not None and not -2 ** 31 <= int(salt) < 2 ** 31:
        raise ValueError(f"{name}: salt {salt} is not an int32")
    return start, count


def fused_chain_power_radix(x: torch.Tensor, plan: RadixPlan, offset=None,
                            bc: int | None = None,
                            salt: int | None = None) -> torch.Tensor:
    """x [bc, 2, m, n] int16/f32, rows in natural order -> pow [bc, m/2] f32,
    for a radix plan, through the route `chain_route(m)` names:

    * m <= 1024: csrc/fused_chain_radix.cu (salted:
      csrc/fused_chain_radix_salted.cu), the register body of
      csrc/fft_chain.cuh cut by `plan.fft`;
    * 1024 < m <= CLUSTER_MAX_M: csrc/fused_chain_radix_cluster.cu, the
      cluster body of csrc/cluster_chain.cuh cut by `plan.cluster` (the
      same cut for int16 and f32; a cluster of 16 above CLUSTER_MAX_M8;
      also counted in RADIX_CLUSTER_LAUNCHES);
    * an m the cluster body refuses (16 x p above 8192, p a prime in (512,
      1023], by its Bluestein length; above 16384): the dense entries'
      matrix kernel (csrc/fused_chain_dense.cu on
      `plan.dense_operator()`, as wrp_tpu's radix kernel runs such an m;
      also counted in DENSE_MATRIX_LAUNCHES).

    With `offset` (the benchmark's entry), x is a larger staged array and
    the kernel reads its `bc` channel-sectors from channel-sector `offset`
    (no copy), with the int32 `salt`, if given, added to every sample.

    A CPU tensor takes the route's plain version (`fft_chain_power_reference`,
    `cluster_chain_power_reference` or `fused_chain_power_reference`).  A
    CUDA tensor launches the route's kernel on the current stream (no
    synchronisation) or raises; there is no fallback."""
    global LAUNCHES, RADIX_OFFSET_LAUNCHES, DENSE_MATRIX_LAUNCHES
    global RADIX_CLUSTER_LAUNCHES
    name = "fused_chain_power_radix"
    start, count = _slab(x.shape[0], offset, bc, salt, name, "bc")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if plan.radix == 1:
        raise ValueError(f"m={plan.m} does not split into radix branches: "
                         "use fused_chain_power_dense")
    route = chain_route(plan.m)
    if x.device.type == "cpu":
        plain = {"register": fft_chain_power_reference,
                 "cluster": cluster_chain_power_reference,
                 "matrix": fused_chain_power_reference}[route]
        return plain(x[start:start + count], plan, salt)
    _check_planar(x, plan, name)
    out = torch.empty((count, plan.m // 2), dtype=torch.float32, device=x.device)
    if count == 0:
        return out
    if route == "matrix":
        _launch_matrix(x, plan, out, start, count, salt)
    else:
        lib = _build.load_library()
        planar = (x.data_ptr(), int(x.dtype == torch.int16))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if route == "cluster":
                rc = lib.wrp_fused_chain_radix_cluster(
                    *planar, plan.cluster_t.data_ptr(),
                    plan.cluster_phi.data_ptr(), plan.wd.data_ptr(),
                    plan.phasors.data_ptr(), out.data_ptr(), count, plan.m,
                    plan.n, plan.cluster.cols, start, int(salt or 0), stream)
            else:
                g = plan.fft
                args = (*planar, plan.fft_t.data_ptr(),
                        plan.fft_phi.data_ptr(), plan.wd.data_ptr(),
                        plan.phasors.data_ptr(), out.data_ptr(), count,
                        plan.m, plan.n, g.cols, g.blocks, start)
                if salt is None:
                    rc = lib.wrp_fused_chain_radix(*args, stream)
                else:
                    rc = lib.wrp_fused_chain_radix_salted(*args, int(salt),
                                                          stream)
        _raise_on_error(lib, rc, "fused_chain_radix_cluster"
                        if route == "cluster" else "fused_chain_radix")
    DENSE_MATRIX_LAUNCHES += route == "matrix"
    RADIX_CLUSTER_LAUNCHES += route == "cluster"
    if offset is None:
        LAUNCHES += 1
    else:
        RADIX_OFFSET_LAUNCHES += 1
    return out


def _launch_matrix(x: torch.Tensor, plan: RadixPlan, out: torch.Tensor,
                   start: int, count: int, salt: int | None) -> None:
    """Launch csrc/fused_chain_dense.cu's matrix kernel on x[start:start +
    count] (the caller checked it) into `out`, with `salt` (None: 0) added
    to every sample."""
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wrp_fused_chain_dense(
            x.data_ptr(), int(x.dtype == torch.int16),
            plan.dense_operator().data_ptr(), plan.wd.data_ptr(),
            plan.phasors.data_ptr(), out.data_ptr(), count, plan.m, plan.n,
            dense_tile(plan), start, int(salt or 0), stream)
    _raise_on_error(lib, rc, "fused_chain_dense")


def fft_occupancy(plan: RadixPlan, body: str = "radix") -> dict:
    """{blocks_per_sm, clusters}: the FFT-form kernel `body` ("radix",
    "wire" or "astage") at the plan's geometry, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor and, for the clustered
    kernels, cudaOccupancyMaxActiveClusters (clusters of `plan.fft.blocks`
    blocks; of S for the cluster body, which a body takes where
    `chain_route` says "cluster" for it, each at its cut of the plan's n,
    the A-stage with f32 staged; None for the register body's A-stage).  A
    radix-1 plan has the planar body only ("radix": the dense entries'
    FFT-form or cluster body).  Needs CUDA."""
    import ctypes

    if plan.radix == 1 and body != "radix":
        raise ValueError(f"fft_occupancy: a radix-1 plan (m={plan.m}) has the "
                         "planar body alone ('radix')")
    if body in ("radix", "wire", "astage") and chain_route(plan.m) == "cluster":
        return cluster_occupancy(plan.m, plan.n, body)
    lib = _build.load_library()
    bps, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _fft_plan_tables(plan, "fft_occupancy")
    g = plan.fft
    if body == "astage":
        rc = lib.wrp_fused_chain_astage_occupancy(plan.m, g.cols,
                                                  ctypes.addressof(bps))
    elif body in ("radix", "wire"):
        fn = getattr(lib, f"wrp_fused_chain_{body}_occupancy")
        rc = fn(plan.m, g.cols, g.blocks, ctypes.addressof(bps),
                ctypes.addressof(clusters))
    else:
        raise ValueError(f"unknown body {body!r}")
    _raise_on_error(lib, rc, f"fft_occupancy ({body})")
    return {"blocks_per_sm": bps.value,
            "clusters": clusters.value if body != "astage" else None}


def cluster_occupancy(m: int, n: int, body: str = "radix") -> dict:
    """{blocks_per_sm, clusters}: the cluster body's kernel for `body`
    ("radix", "wire" or "astage") at m and its cut of n pulses (the
    A-stage's with f32 staged), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor and
    cudaOccupancyMaxActiveClusters (clusters of S); no plan needed.  Needs
    CUDA; raises where the C entry refuses m."""
    import ctypes

    lib = _build.load_library()
    bps, clusters = ctypes.c_int(0), ctypes.c_int(0)
    g = (cluster_geometry(m, n) if body != "astage"
         else cluster_geometry(m, n, False, 4))
    rc = getattr(lib, f"wrp_fused_chain_{body}_cluster_occupancy")(
        m, g.cols, ctypes.addressof(bps), ctypes.addressof(clusters))
    _raise_on_error(lib, rc, f"cluster_occupancy ({body}, m={m})")
    return {"blocks_per_sm": bps.value, "clusters": clusters.value}


def _dense(x: torch.Tensor, plan: RadixPlan, start: int, count: int,
           name: str, counter: str) -> torch.Tensor:
    """pow of x[start:start + count] through the route `chain_route(m)`
    names: on CUDA its kernel, adding one to the module counter named
    `counter` and to the route's (DENSE_FFT_LAUNCHES for the FFT-form
    body's register and long-ray forms, DENSE_CLUSTER_LAUNCHES,
    DENSE_MATRIX_LAUNCHES) per launch; on the CPU its plain version."""
    global DENSE_FFT_LAUNCHES, DENSE_CLUSTER_LAUNCHES, DENSE_MATRIX_LAUNCHES
    if plan.radix != 1:
        raise ValueError(f"{name} needs a radix-1 plan; m={plan.m} splits "
                         f"into {plan.radix} branches")
    route = chain_route(plan.m)
    if x.device.type == "cpu":
        plain = {"register": fft_chain_power_reference,
                 "long": fft_chain_power_reference,
                 "cluster": cluster_chain_power_reference,
                 "matrix": fused_chain_power_reference}[route]
        return plain(x[start:start + count], plan)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_planar(x, plan, name)
    out = torch.empty((count, plan.m // 2), dtype=torch.float32, device=x.device)
    if count == 0:
        return out
    if route == "matrix":
        _launch_matrix(x, plan, out, start, count, None)
    else:
        lib = _build.load_library()
        planar = (x.data_ptr(), int(x.dtype == torch.int16))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if route == "cluster":
                # the planar chain's cluster entry, unsalted
                rc = lib.wrp_fused_chain_radix_cluster(
                    *planar, plan.cluster_t.data_ptr(),
                    plan.cluster_phi.data_ptr(), plan.wd.data_ptr(),
                    plan.phasors.data_ptr(), out.data_ptr(), count, plan.m,
                    plan.n, plan.cluster.cols, start, 0, stream)
            else:
                # the radix entry's planar FFT-form body, unsalted
                g = plan.fft
                rc = lib.wrp_fused_chain_radix(
                    *planar, plan.fft_t.data_ptr(), plan.fft_phi.data_ptr(),
                    plan.wd.data_ptr(), plan.phasors.data_ptr(),
                    out.data_ptr(), count, plan.m, plan.n, g.cols, g.blocks,
                    start, stream)
        _raise_on_error(lib, rc, "fused_chain_radix_cluster"
                        if route == "cluster" else "fused_chain_radix")
    globals()[counter] += 1
    DENSE_FFT_LAUNCHES += route in ("register", "long")
    DENSE_CLUSTER_LAUNCHES += route == "cluster"
    DENSE_MATRIX_LAUNCHES += route == "matrix"
    return out


def fused_chain_power_dense(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, n] int16/f32 -> pow [bc, m/2] f32, for a plan with
    radix 1, through the route `chain_route(m)` names: the FFT-form body
    for every even m <= 1024 (and its long-ray form at m = 2 x odd in
    (2048, FFT_MAX_M]), the cluster body for m = S x odd up to
    CLUSTER_MAX_M, else the dense A_half.  A CPU tensor takes that route's
    plain version (`fft_chain_power_reference`,
    `cluster_chain_power_reference`, or the R == 1 branch of
    `fused_chain_power_reference`); a CUDA tensor launches its kernel
    (csrc/fused_chain_dense.cu's entries) or raises: there is no
    fallback."""
    return _dense(x, plan, 0, x.shape[0], "fused_chain_power_dense",
                  "DENSE_LAUNCHES")


def fused_chain_power_at(x_all: torch.Tensor, offset, bc: int,
                         plan: RadixPlan) -> torch.Tensor:
    """The dense entry on `bc` channel-sectors of the staged x_all [BC, 2,
    m, n] from channel-sector `offset` (no copy; ``wrp_tpu``'s
    `fused_chain_power_at`, the benchmark's entry for m that does not split)
    -> pow [bc, m/2] f32, through the route `chain_route(m)` names.  No
    salt, as there.  A CPU tensor takes that route's plain version on the
    slab; a CUDA tensor launches its kernel or raises."""
    start, count = _slab(x_all.shape[0], offset, bc, None,
                         "fused_chain_power_at", "bc")
    return _dense(x_all, plan, start, count, "fused_chain_power_at",
                  "DENSE_OFFSET_LAUNCHES")


def decode_words_iq(w: torch.Tensor):
    """Little-endian int32 wire words -> (I, Q) int32, sign-extended.

    One word = one channel-sample's wire bytes b0 b1 b2 b3 = I_hi I_lo Q_hi
    Q_lo (big-endian int16 pairs); read little-endian, w = b0 | b1<<8 |
    b2<<16 | b3<<24.  Swapping the bytes of each 16-bit half puts Q in the
    high half (the arithmetic shift gives its sign) and I in the low half
    (a shift pair sign-extends it).  The kernel does the same with one
    __byte_perm (csrc/chain_common.cuh)."""
    s = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return (s << 16) >> 16, s >> 16


def fused_chain_power_wire_reference(w32: torch.Tensor, plan: RadixPlan,
                                     ch: int, salt: int | None = None) -> torch.Tensor:
    """Plain torch version of the wire kernels: w32 [bs, m, ch*n] int32 ->
    pow [bs, ch, m/2] f32.  Decode the words, deinterleave the channels,
    then the planar plain version of the route `chain_route(m)`
    names on the planar sectors (`fft_chain_power_reference`,
    `cluster_chain_power_reference` or `fused_chain_power_reference`), with
    `salt` added to every decoded sample (the salted kernels)."""
    bs, m, lanes = w32.shape
    i_, q_ = decode_words_iq(w32)
    planar = torch.stack([i_, q_], dim=1).reshape(bs, 2, m, lanes // ch, ch)
    planar = planar.permute(0, 4, 1, 2, 3).reshape(bs * ch, 2, m, lanes // ch)
    plain = {"register": fft_chain_power_reference,
             "cluster": cluster_chain_power_reference,
             "matrix": fused_chain_power_reference}[chain_route(m)]
    return plain(planar.to(torch.float32), plan, salt).reshape(bs, ch, m // 2)


def fused_chain_power_wire(w32: torch.Tensor, plan: RadixPlan, ch: int,
                           offset=None, bs: int | None = None,
                           salt: int | None = None) -> torch.Tensor:
    """w32 [bs, m, ch*n] int32 wire words, rows in natural order -> pow
    [bs, ch, m/2] f32 (ops/device_codec.wire_words_i32 builds w32 from wire
    bytes).

    With `offset` (the benchmark's entry), w32 is a larger staged array and
    the kernel reads its `bs` sectors from SECTOR `offset` (no copy), with
    the int32 `salt`, if given, added to every decoded sample.

    The route is m's alone (`chain_route(m)`, the planar chain's): m <=
    1024 launches csrc/fused_chain_wire.cu (salted:
    csrc/fused_chain_wire_salted.cu), the register body; 1024 < m <=
    CLUSTER_MAX_M csrc/fused_chain_wire_cluster.cu, the cluster body cut by
    `plan.cluster` (a cluster of 16 above CLUSTER_MAX_M8; also counted in
    WIRE_CLUSTER_LAUNCHES); an m the cluster body refuses (16 x p above
    8192, p a prime in (512, 1023], by its Bluestein length; above 16384)
    the matrix kernel's wire source (csrc/fused_chain_dense.cu
    `wrp_fused_chain_dense_wire`, on `plan.dense_operator()`, also counted
    in DENSE_MATRIX_LAUNCHES).  A CPU tensor takes the plain version.  A
    CUDA tensor launches the route's kernel on the current stream or
    raises: there is no fallback.  Every channel reads the planar window
    and phasors."""
    global WIRE_LAUNCHES, WIRE_OFFSET_LAUNCHES, DENSE_MATRIX_LAUNCHES
    global WIRE_CLUSTER_LAUNCHES
    name = "fused_chain_power_wire"
    start, count = _slab(w32.shape[0], offset, bs, salt, name, "bs")
    if w32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {w32.device}")
    if w32.dtype != torch.int32:
        raise TypeError(f"w32 must be int32 wire words, got {w32.dtype}")
    if plan.radix == 1:
        raise ValueError(f"m={plan.m} does not split into radix branches: the "
                         "wire path decodes first (wire_decode='xla')")
    if w32.device.type == "cpu":
        return fused_chain_power_wire_reference(w32[start:start + count], plan,
                                                ch, salt)
    L = ch * plan.n
    if w32.dim() != 3 or tuple(w32.shape[1:]) != (plan.m, L):
        raise ValueError(f"w32 must be [bs, {plan.m}, {L}], got "
                         f"{tuple(w32.shape)}")
    if not w32.is_contiguous():
        raise ValueError("w32 must be contiguous")
    if plan.device != w32.device:
        raise ValueError(f"plan is on {plan.device}, w32 on {w32.device}")
    out = torch.empty((count, ch, plan.m // 2), dtype=torch.float32,
                      device=w32.device)
    if count == 0:
        return out
    route = chain_route(plan.m)
    lib = _build.load_library()
    with torch.cuda.device(w32.device):
        stream = torch.cuda.current_stream(w32.device).cuda_stream
        if route == "matrix":
            rc = lib.wrp_fused_chain_dense_wire(
                w32.data_ptr(), plan.dense_operator().data_ptr(),
                plan.wd.data_ptr(), plan.phasors.data_ptr(), out.data_ptr(),
                count, plan.m, plan.n, ch, dense_tile(plan), start,
                int(salt or 0), stream)
        elif route == "cluster":
            rc = lib.wrp_fused_chain_wire_cluster(
                w32.data_ptr(), plan.cluster_t.data_ptr(),
                plan.cluster_phi.data_ptr(), plan.wd.data_ptr(),
                plan.phasors.data_ptr(), out.data_ptr(), count, plan.m,
                plan.n, ch, plan.cluster.cols, start, int(salt or 0), stream)
        else:
            g = plan.fft
            args = (w32.data_ptr(), plan.fft_t.data_ptr(),
                    plan.fft_phi.data_ptr(), plan.wd.data_ptr(),
                    plan.phasors.data_ptr(), out.data_ptr(), count, plan.m,
                    plan.n, ch, g.cols, g.blocks, start)
            if salt is None:
                rc = lib.wrp_fused_chain_wire(*args, stream)
            else:
                rc = lib.wrp_fused_chain_wire_salted(*args, int(salt), stream)
    _raise_on_error(lib, rc, {"register": "fused_chain_wire",
                              "cluster": "fused_chain_wire_cluster",
                              "matrix": "fused_chain_dense_wire"}[route])
    DENSE_MATRIX_LAUNCHES += route == "matrix"
    WIRE_CLUSTER_LAUNCHES += route == "cluster"
    if offset is None:
        WIRE_LAUNCHES += 1
    else:
        WIRE_OFFSET_LAUNCHES += 1
    return out


def astage_tile(plan: RadixPlan) -> int:
    """Tallest tile T in KERNEL_TILES of the matrix-form A-stage
    (csrc/radix_chain.cuh: the A-stage where the cluster body refuses m and
    the in-kernel time breakdown's) that divides M = m / R and whose operator slice
    [M, T] complex, 2 T M 4 bytes, fits one block's shared memory (8 KB at
    T = 8, M = 128; 131,584 bytes at m = 4112, M = 2056; at m = 7280, M =
    3640, T = 8 would need 232,960, so T = 4).  T = 8 measured fastest at
    1024 x 512 (PERF.md).  Raises, naming m, where no tile fits."""
    M = plan.m // plan.radix
    for t in KERNEL_TILES:
        if M % t == 0 and 2 * t * M * 4 <= MAX_SMEM_BYTES:
            return t
    raise ValueError(f"no A-stage tile divides M={M} and fits "
                     f"{MAX_SMEM_BYTES} bytes of shared memory (m={plan.m})")


def fused_chain_astage_reference(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the A-stage kernels: x [bc, 2, m, w]
    int16/f32, natural row order, any pulse count w -> Y [bc, 2, m/2, w]
    f32, that of the route `chain_route(m)` names: the register body's
    (`fft_stage_reference`), the cluster body's (`cluster_stage_reference`)
    or the matrix form's (`_contract_reference`)."""
    route = chain_route(plan.m)
    if route == "register":
        yr, yi = fft_stage_reference(x, plan)
    elif route == "cluster":
        yr, yi = cluster_stage_reference(x, plan)
    else:
        yr, yi = _contract_reference(x, plan)
    return torch.stack([yr, yi], dim=1)


def fused_chain_astage(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, w] int16/f32 (natural row order, w = this rank's pulse
    lanes) -> Y [bc, 2, m/2, w] f32, the windowed half-spectrum range DFT.
    Needs a plan whose m splits into radix branches, as ``wrp_tpu``'s
    pallas-seq does.  The route is m's alone (`chain_route`):

    * m <= 1024: csrc/fused_chain_astage.cu, the FFT stage of
      csrc/fft_chain.cuh cut by `fft_geometry(m, w)`;
    * 1024 < m <= CLUSTER_MAX_M: csrc/fused_chain_astage_cluster.cu, the
      cluster body of csrc/cluster_chain.cuh cut by `cluster_geometry(m,
      w, False, x.element_size())` (a cluster of 16 above CLUSTER_MAX_M8;
      also counted in ASTAGE_CLUSTER_LAUNCHES);
    * an m the cluster body refuses (16 x p above 8192, p a prime in (512,
      1023], by its Bluestein length; above 16384):
      csrc/fused_chain_astage_matrix.cu, the matrix form of
      csrc/radix_chain.cuh on the plan's branch operators and combine
      factors at the tile `astage_tile` picks (also counted in
      ASTAGE_MATRIX_LAUNCHES).

    A CPU tensor takes the route's plain version
    (`fused_chain_astage_reference`).  A CUDA tensor launches the route's
    kernel on the current stream or raises; there is no fallback."""
    global ASTAGE_LAUNCHES, ASTAGE_MATRIX_LAUNCHES, ASTAGE_CLUSTER_LAUNCHES
    name = "fused_chain_astage"
    if plan.radix < 2:
        raise ValueError(f"the A-stage needs the radix plan (m={plan.m} "
                         "supports radix 1 only)")
    if x.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"{name}: x must be int16 or float32, got {x.dtype}")
    if x.dim() != 4 or tuple(x.shape[1:3]) != (2, plan.m) or x.shape[3] < 1:
        raise ValueError(f"{name}: x must be [bc, 2, {plan.m}, w], "
                         f"got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cpu":
        return fused_chain_astage_reference(x, plan)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if plan.device != x.device:
        raise ValueError(f"{name}: plan is on {plan.device}, x on {x.device}")
    bc, w = x.shape[0], x.shape[3]
    y = torch.empty((bc, 2, plan.m // 2, w), dtype=torch.float32,
                    device=x.device)
    if bc == 0:
        return y
    route = chain_route(plan.m)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "register":
            g = fft_geometry(plan.m, w)
            rc = lib.wrp_fused_chain_astage(
                x.data_ptr(), int(x.dtype == torch.int16),
                plan.fft_t.data_ptr(), y.data_ptr(), bc, plan.m, w, g.cols,
                g.blocks, stream)
        elif route == "cluster":
            rc = lib.wrp_fused_chain_astage_cluster(
                x.data_ptr(), int(x.dtype == torch.int16),
                plan.cluster_t.data_ptr(), y.data_ptr(), bc, plan.m, w,
                cluster_geometry(plan.m, w, False, x.element_size()).cols,
                stream)
        else:
            rc = lib.wrp_fused_chain_astage_matrix(
                x.data_ptr(), int(x.dtype == torch.int16),
                plan.a_kernel.data_ptr(), plan.fac_t.data_ptr(), y.data_ptr(),
                bc, plan.m, w, plan.radix, astage_tile(plan), stream)
    _raise_on_error(lib, rc, f"fused_chain_astage ({route})")
    ASTAGE_LAUNCHES += 1
    ASTAGE_CLUSTER_LAUNCHES += route == "cluster"
    ASTAGE_MATRIX_LAUNCHES += route == "matrix"
    return y


#: the longest row the row epilogue's register form holds (csrc/
#: parseval_rows.cu `lanes_v`: V = ceil(n / 128) float4s a lane a plane, 1,
#: 2, 4 or 8)
ROWS_MAX_N = 1024


def parseval_rows_form(n: int, *ptrs: int) -> str:
    """The form of csrc/parseval_rows.cu that takes rows of n pulses at the
    addresses `ptrs` (y, wd, ph): "registers" (one read, float4 rows held
    in registers) for n % 4 == 0, 4 <= n <= ROWS_MAX_N and 16-byte aligned
    pointers, else "two-pass" (scalar loads, the row read twice; any
    n >= 1).  The C entry refuses the register form wherever this says
    two-pass."""
    if n % 4 or not 4 <= n <= ROWS_MAX_N or any(p % 16 for p in ptrs):
        return "two-pass"
    return "registers"


def parseval_rows_power_reference(y: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the row-epilogue kernel: Y [bc, 2, rows, n]
    f32 -> pow [bc, rows] f32 (`pipeline.stage_b_parseval`)."""
    return stage_b_parseval(y[:, 0], y[:, 1], plan.wd, plan.phasors)


def parseval_rows_power(y: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Y [bc, 2, rows, n] f32 (the full pulse axis, any slice of the m/2
    range bins) -> pow [bc, rows] f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/parseval_rows.cu on the current
    stream, in the form `parseval_rows_form` picks, or raises."""
    global PARSEVAL_ROWS_LAUNCHES, PARSEVAL_ROWS_TWO_PASS_LAUNCHES
    if y.dtype != torch.float32:
        raise TypeError(f"parseval_rows_power: y must be float32, got {y.dtype}")
    if y.dim() != 4 or y.shape[1] != 2 or y.shape[3] != plan.n:
        raise ValueError(f"parseval_rows_power: y must be [bc, 2, rows, "
                         f"{plan.n}], got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return parseval_rows_power_reference(y, plan)
    if y.device.type != "cuda":
        raise ValueError(f"parseval_rows_power: unsupported device {y.device}")
    if not y.is_contiguous():
        raise ValueError("parseval_rows_power: y must be contiguous")
    if plan.device != y.device:
        raise ValueError(f"parseval_rows_power: plan is on {plan.device}, y on "
                         f"{y.device}")
    bc, rows = y.shape[0], y.shape[2]
    out = torch.empty((bc, rows), dtype=torch.float32, device=y.device)
    if bc == 0 or rows == 0:
        return out
    ptrs = (y.data_ptr(), plan.wd.data_ptr(), plan.phasors.data_ptr())
    two_pass = parseval_rows_form(plan.n, *ptrs) == "two-pass"
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.wrp_parseval_rows(*ptrs, out.data_ptr(), bc, rows, plan.n,
                                   int(two_pass), stream)
    _raise_on_error(lib, rc, "parseval_rows")
    PARSEVAL_ROWS_LAUNCHES += 1
    PARSEVAL_ROWS_TWO_PASS_LAUNCHES += two_pass
    return out


def parseval_rows_occupancy(n: int) -> int:
    """Resident blocks per SM of the row epilogue's register form at n (on
    the current CUDA device); raises where the C entry refuses n."""
    import ctypes

    lib = _build.load_library()
    blocks = ctypes.c_int(0)
    rc = lib.wrp_parseval_rows_occupancy(n, ctypes.addressof(blocks))
    _raise_on_error(lib, rc, "parseval_rows occupancy")
    return blocks.value


def build_fused_processor(consts: PipelineConstants, device):
    """fn(iq_planar [B, C, 2, m, n]) -> pow [B, C, m/2] through the radix
    kernel, or the dense one when m does not split (the plan is built
    once, on `device`)."""
    plan = build_plan(consts, device)
    power = fused_chain_power_radix if plan.radix > 1 else fused_chain_power_dense

    def fn(iq_planar: torch.Tensor) -> torch.Tensor:
        b, c, two, m, n = iq_planar.shape
        p = power(iq_planar.reshape(b * c, two, m, n).contiguous(), plan)
        return p.reshape(b, c, -1)

    return fn
