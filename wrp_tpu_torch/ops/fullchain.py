"""The fused chain (stages 01-08) as hand-written CUDA kernels.

Counterpart of ``wrp_tpu/ops/pallas/fullchain.py``: per channel-sector,
IQ [2, m, n] -> matched-filter power [m/2] via a half-spectrum range DFT
followed by the closed-form Parseval epilogue (``pipeline.stage_b_parseval``).
Each kernel has its wrapper, plain torch version and launch counter:

* radix, csrc/fused_chain_radix.cu (``wrp_tpu`` `fused_chain_power_radix`):
  `fused_chain_power_radix`, plain `fft_chain_power_reference`,
  `LAUNCHES`.  Planar int16/f32 IQ through the FFT-form kernel
  (csrc/fft_chain.cuh), for m that splits (`radix_for(m) > 1`) up to
  FFT_MAX_M: the range DFT as an FFT, and the Parseval epilogue from
  chunked partials merged across a thread-block cluster.
* wire, csrc/fused_chain_wire.cu (``wrp_tpu`` `fused_chain_power_wire`):
  `fused_chain_power_wire`, plain `fused_chain_power_wire_reference`,
  `WIRE_LAUNCHES`.  The same kernel body on raw wire words [bs, m, ch*n]
  int32, decoded in registers, one channel per block.
* dense, csrc/fused_chain_dense.cu (``wrp_tpu`` `fused_chain_power`):
  `fused_chain_power_dense`, plain `fused_chain_power_reference` (its
  R == 1 branch), `DENSE_LAUNCHES`.  Planar IQ through the dense A_half
  [m/2, m], for m that does not split (`radix_for(m) == 1`).

The benchmark (wrp_tpu_torch/bench.py) reads each step's slab of a larger
staged array through the OFFSET entries, one per kernel, each with its own
counter (counted only when an offset is given): `fused_chain_power_radix`
and `fused_chain_power_wire` with `offset=`, `bc=`/`bs=` and `salt=`
(``wrp_tpu``'s `_kernel_radix_offset`, `_kernel_radix_wire_offset`;
`RADIX_OFFSET_LAUNCHES`, `WIRE_OFFSET_LAUNCHES`; a salt launches through
csrc/fused_chain_{radix,wire}_salted.cu, the same instantiation with its
salt), and `fused_chain_power_at` (``wrp_tpu``'s dense offset entry;
`DENSE_OFFSET_LAUNCHES`).  The offset is applied by the C launcher as
pointer arithmetic, so there is no copy; one past the staged array raises
(``wrp_tpu`` clamps it in interpret mode and would read past the buffer
compiled).  The salt, an int32, is added to every I and Q sample after its
conversion to f32.

The pulse-sharded path (parallel/sharded.py "pallas-seq") splits the
radix chain at its one communication point, with a kernel on each side:

* A-stage, csrc/fused_chain_astage.cu (``wrp_tpu`` `fused_chain_astage`):
  `fused_chain_astage`, plain `fused_chain_astage_reference`,
  `ASTAGE_LAUNCHES`.  The FFT stage of csrc/fft_chain.cuh on a rank's
  pulse slab [bc, 2, m, w] -> Y [bc, 2, m/2, w].
* row epilogue, csrc/parseval_rows.cu (``wrp_tpu`` `parseval_rows_power`):
  `parseval_rows_power`, plain `parseval_rows_power_reference`,
  `PARSEVAL_ROWS_LAUNCHES`.  The Parseval epilogue on full-pulse rows
  Y [bc, 2, rows, n] -> pow [bc, rows].

The host plan (`build_plan`) holds the FFT form's tables (`fft_tables`:
the range window w_r c, the twiddles W_P, the leaf's factors, fp64 cast
once; `fft_round_phasor_sums`) beside the TPU algorithm's matrix form
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
ASTAGE_LAUNCHES = 0     # fused_chain_astage.cu
PARSEVAL_ROWS_LAUNCHES = 0   # parseval_rows.cu
RADIX_OFFSET_LAUNCHES = 0    # the radix offset entry (salted: fused_chain_radix_salted.cu)
WIRE_OFFSET_LAUNCHES = 0     # the wire offset entry (salted: fused_chain_wire_salted.cu)
DENSE_OFFSET_LAUNCHES = 0    # fused_chain_power_at (fused_chain_dense.cu)

RADIX = 8

#: tile heights (sub-DFT rows per block) the radix and wire kernels are
#: instantiated for
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
    twiddle W_P^(k1 n2), a P2-point DFT in registers), then for L > 1 an
    L-point leaf DFT in matrix form across the L sub-FFTs.  The pulse
    columns split into chunks of `cols`, dealt round-robin to the unit's
    `blocks` blocks (at most 8: one thread-block cluster): in round r,
    block b runs chunk r blocks + b."""

    P: int
    L: int
    P1: int
    P2: int
    cols: int
    blocks: int


#: the FFT-form kernels' limits: m <= FFT_MAX_M (a thread owns at most
#: two of the m/2 <= 512 rows across its rounds, csrc/fft_chain.cuh
#: kRows), at most FFT_MAX_CLUSTER blocks per unit (the portable cluster
#: size), FFT_THREADS threads a block
FFT_MAX_M = 1024
FFT_MAX_CLUSTER = 8
FFT_THREADS = 256
#: complex values of one round's working set (m cols): 64 KB of fp32
FFT_ROUND_VALUES = 8192


def fft_geometry(m: int, width: int) -> FftGeometry:
    """The FFT-form kernels' cut of m range rows and `width` pulse
    columns (see FftGeometry).  cols: the largest power of two with
    m cols <= FFT_ROUND_VALUES (8 at m = 1024: 64 KB), at most 64 and no
    more than width needs, and for L = 1 with pass 2's cols P1 tasks no
    more than the block's threads (its output then overwrites its input in
    shared memory); blocks: at most FFT_MAX_CLUSTER, each with at least one
    chunk (8 blocks of 8 rounds at n = 512)."""
    if m > FFT_MAX_M or m % 2 or m < 2:
        raise ValueError(f"the FFT-form kernels take even m <= {FFT_MAX_M}, "
                         f"got m={m}")
    P = m & -m
    P1 = min(32, P)
    cols = 1
    while (cols < 64 and 2 * cols * m <= FFT_ROUND_VALUES and cols < width
           and (m > P or 2 * cols * P1 <= FFT_THREADS)):
        cols *= 2
    return FftGeometry(P=P, L=m // P, P1=P1, P2=P // P1, cols=cols,
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
      then 2 L L             W_L^(k2 r2) at (k2 L + r2): the leaf DFT."""
    m = consts.op_a_half.shape[1]
    g = fft_geometry(m, 1)
    P, L = g.P, g.L
    wr_c = np.asarray(consts.op_a_half[0]).astype(np.complex128).real
    k, r2 = np.meshgrid(np.arange(P), np.arange(L))          # [L, P]
    leaf_tw = _roots(m, m)[(k * r2) % m]
    k2, r = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    leaf = _roots(L, L)[(k2 * r) % L]

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
    fft_t: torch.Tensor | None = None   # fft_tables (radix plans with m <= FFT_MAX_M)
    fft_phi: torch.Tensor | None = None  # [rounds, 4] fft_round_phasor_sums at n

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def fft(self) -> FftGeometry:
        """The FFT-form kernels' cut of the plan's m x n."""
        return fft_geometry(self.m, self.n)


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
    if radix > 1 and m <= FFT_MAX_M:
        lanes["fft_t"] = torch.from_numpy(fft_tables(consts)).to(device)
        lanes["fft_phi"] = torch.from_numpy(fft_round_phasor_sums(
            consts.clip_phasors, fft_geometry(m, n).cols)).to(device)
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
    tensors: win [m] f32, tw [P], leaf_tw [L, P], leaf [L, L])."""
    if plan.fft_t is None:
        raise ValueError(f"{name}: the FFT-form kernels take a radix plan "
                         f"with m <= {FFT_MAX_M} (m={plan.m}, radix "
                         f"{plan.radix})")
    g = plan.fft
    m, P, L = plan.m, g.P, g.L
    t = plan.fft_t

    def cplx(lo, count):
        v = t[lo:lo + 2 * count].reshape(count, 2)
        return torch.complex(v[:, 0], v[:, 1])

    tw = cplx(m, P)
    leaf_tw = cplx(m + 2 * P, L * P).reshape(L, P)
    leaf = cplx(m + 2 * P + 2 * L * P, L * L).reshape(L, L)
    return g, t[:m], tw, leaf_tw, leaf


def fft_stage_reference(x: torch.Tensor, plan: RadixPlan,
                        salt: int | None = None):
    """Plain torch version of the FFT-form kernels' range stage: x [bc, 2,
    m, w] int16/f32 (natural row order, any w) -> (yr, yi) [bc, m/2, w] f32,
    Y[k, j] = sum_r W_m^(k r) (w_r c)[r] (x[r, j] + salt (1 + i)), k < m/2.

    The kernels' stages, written out: the window and salt on load; per
    decimated sub-sequence r2 (rows L i + r2), the four-step P-point FFT
    (a P1-point DFT over n1 of rows i = P2 n1 + n2, the twiddle
    W_P^(k1 n2), a P2-point DFT over n2, X[k1 + P1 k2]); for L > 1 the
    leaf's twiddle W_m^(k r2) and L-point DFT, Y[k + P k2]; the crop.
    Every factor comes from the plan's float32 tables (fft_tables)."""
    g, win, tw, leaf_tw, leaf = _fft_plan_tables(plan, "fft_stage_reference")
    P, L, P1, P2 = g.P, g.L, g.P1, g.P2
    bc, _, m, w = x.shape
    xf = x.to(torch.float32)
    if salt is not None:
        xf = xf + float(salt)
    xw = xf * win[:, None]
    v = torch.complex(xw[:, 0], xw[:, 1])                  # [bc, m, w]
    v = v.reshape(bc, P, L, w).permute(0, 2, 1, 3)         # [bc, L, P(i), w]
    v = v.reshape(bc, L, P1, P2, w)                        # i = P2 n1 + n2
    a1 = torch.arange(P1)
    a2 = torch.arange(P2)
    f1 = tw[(a1[:, None] * a1[None, :] * P2) % P]          # [k1, n1]
    a = torch.einsum("kn,blnqw->blkqw", f1, v)
    a = a * tw[(a1[:, None] * a2[None, :]) % P][None, None, :, :, None]
    f2 = tw[(a2[:, None] * a2[None, :] * P1) % P]          # [k2, n2]
    xk = torch.einsum("jq,blkqw->bljkw", f2, a)            # [bc, L, k2, k1, w]
    xk = xk.reshape(bc, L, P, w)                           # k = P1 k2 + k1
    if L > 1:
        xk = torch.einsum("jr,brkw->bjkw", leaf,
                          xk * leaf_tw[None, :, :, None])  # [bc, k2, k, w]
    y = xk.reshape(bc, m, w)[:, : m // 2]
    return y.real.contiguous(), y.imag.contiguous()


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


def fft_chain_power_reference(x: torch.Tensor, plan: RadixPlan,
                              salt: int | None = None) -> torch.Tensor:
    """Plain torch version of the FFT-form fused chain kernels (radix,
    wire, salted): x [bc, 2, m, n] int16/f32 -> pow [bc, m/2] f32, the
    range stage (`fft_stage_reference`) then the merged epilogue
    (`merged_epilogue_reference`) at the kernel's chunk sizes."""
    yr, yi = fft_stage_reference(x, plan, salt)
    return merged_epilogue_reference(yr, yi, plan)


def kernel_tile(plan: RadixPlan) -> int:
    """Tallest tile of the radix and wire kernels whose Y rows [S*T, n] and
    operator slice [M, T] fit in one block's shared memory (T = 8 at
    m = 1024, n = 512: 136 KB).  The wire kernel gives each block one
    channel, so its tile is the planar one."""
    S = plan.radix // 2
    M = plan.m // plan.radix
    for t in KERNEL_TILES:
        if M % t == 0 and (2 * S * t * plan.n + 2 * t * M) * 4 <= MAX_SMEM_BYTES:
            return t
    raise ValueError(f"no kernel tile fits m={plan.m}, n={plan.n} in "
                     f"{MAX_SMEM_BYTES} bytes of shared memory")


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


def _fft_launch_geometry(plan: RadixPlan, name: str) -> FftGeometry:
    """The plan's FftGeometry, or a ValueError naming why the FFT-form
    kernels do not take the plan."""
    if plan.radix == 1:
        raise ValueError(f"m={plan.m} does not split into radix branches: "
                         "use fused_chain_power_dense")
    _fft_plan_tables(plan, name)
    return plan.fft


def fused_chain_power_radix(x: torch.Tensor, plan: RadixPlan, offset=None,
                            bc: int | None = None,
                            salt: int | None = None) -> torch.Tensor:
    """x [bc, 2, m, n] int16/f32, rows in natural order -> pow [bc, m/2] f32,
    through the FFT-form kernel (csrc/fft_chain.cuh) for a radix plan with
    m <= FFT_MAX_M.

    With `offset` (the benchmark's entry), x is a larger staged array and
    the kernel reads its `bc` channel-sectors from channel-sector `offset`
    (no copy), with the int32 `salt`, if given, added to every sample.

    A CPU tensor takes the plain version (`fft_chain_power_reference`).  A
    CUDA tensor launches the kernel on the current stream (no
    synchronisation) or raises; there is no fallback."""
    global LAUNCHES, RADIX_OFFSET_LAUNCHES
    name = "fused_chain_power_radix"
    start, count = _slab(x.shape[0], offset, bc, salt, name, "bc")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    g = _fft_launch_geometry(plan, name)
    if x.device.type == "cpu":
        return fft_chain_power_reference(x[start:start + count], plan, salt)
    _check_planar(x, plan, name)
    out = torch.empty((count, plan.m // 2), dtype=torch.float32, device=x.device)
    if count == 0:
        return out
    lib = _build.load_library()
    args = (x.data_ptr(), int(x.dtype == torch.int16), plan.fft_t.data_ptr(),
            plan.fft_phi.data_ptr(), plan.wd.data_ptr(), plan.phasors.data_ptr(),
            out.data_ptr(), count, plan.m, plan.n, g.cols, g.blocks, start)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if salt is None:
            rc = lib.wrp_fused_chain_radix(*args, stream)
        else:
            rc = lib.wrp_fused_chain_radix_salted(*args, int(salt), stream)
    _raise_on_error(lib, rc, "fused_chain_radix")
    if offset is None:
        LAUNCHES += 1
    else:
        RADIX_OFFSET_LAUNCHES += 1
    return out


def fft_occupancy(plan: RadixPlan, body: str = "radix") -> dict:
    """{blocks_per_sm, clusters}: the FFT-form kernel `body` ("radix",
    "wire" or "astage") at the plan's geometry, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor and, for the clustered
    fused kernels, cudaOccupancyMaxActiveClusters (clusters of
    `plan.fft.blocks` blocks; None for the A-stage).  Needs CUDA."""
    import ctypes

    g = _fft_launch_geometry(plan, "fft_occupancy")
    lib = _build.load_library()
    bps, clusters = ctypes.c_int(0), ctypes.c_int(0)
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


def _dense(x: torch.Tensor, plan: RadixPlan, start: int, count: int,
           name: str, counter: str) -> torch.Tensor:
    """pow of x[start:start + count] through the dense kernel (CUDA, adding
    one to the module counter named `counter` per launch) or its plain
    version (CPU)."""
    if plan.radix != 1:
        raise ValueError(f"{name} needs a radix-1 plan; m={plan.m} splits "
                         f"into {plan.radix} branches")
    if x.device.type == "cpu":
        return fused_chain_power_reference(x[start:start + count], plan)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_planar(x, plan, name)
    out = torch.empty((count, plan.m // 2), dtype=torch.float32, device=x.device)
    if count == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wrp_fused_chain_dense(
            x.data_ptr(), int(x.dtype == torch.int16), plan.a_kernel.data_ptr(),
            plan.wd.data_ptr(), plan.phasors.data_ptr(), out.data_ptr(), count,
            plan.m, plan.n, dense_tile(plan), start, stream)
    _raise_on_error(lib, rc, "fused_chain_dense")
    globals()[counter] += 1
    return out


def fused_chain_power_dense(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, n] int16/f32 -> pow [bc, m/2] f32 through the dense
    A_half, for a plan with radix 1.  A CPU tensor takes the plain version
    (the R == 1 branch of `fused_chain_power_reference`); a CUDA tensor
    launches csrc/fused_chain_dense.cu or raises."""
    return _dense(x, plan, 0, x.shape[0], "fused_chain_power_dense",
                  "DENSE_LAUNCHES")


def fused_chain_power_at(x_all: torch.Tensor, offset, bc: int,
                         plan: RadixPlan) -> torch.Tensor:
    """The dense kernel on `bc` channel-sectors of the staged x_all [BC, 2,
    m, n] from channel-sector `offset` (no copy; ``wrp_tpu``'s
    `fused_chain_power_at`, the benchmark's entry for m that does not split)
    -> pow [bc, m/2] f32.  No salt, as there.  A CPU tensor takes the plain
    version on the slab; a CUDA tensor launches the kernel or raises."""
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
    """Plain torch version of the wire kernel: w32 [bs, m, ch*n] int32 ->
    pow [bs, ch, m/2] f32.  Decode the words, deinterleave the channels,
    then `fft_chain_power_reference` on the planar sectors (with `salt`
    added to every decoded sample, the salted kernel)."""
    bs, m, lanes = w32.shape
    i_, q_ = decode_words_iq(w32)
    planar = torch.stack([i_, q_], dim=1).reshape(bs, 2, m, lanes // ch, ch)
    planar = planar.permute(0, 4, 1, 2, 3).reshape(bs * ch, 2, m, lanes // ch)
    return fft_chain_power_reference(planar.to(torch.float32), plan,
                                     salt).reshape(bs, ch, m // 2)


def fused_chain_power_wire(w32: torch.Tensor, plan: RadixPlan, ch: int,
                           offset=None, bs: int | None = None,
                           salt: int | None = None) -> torch.Tensor:
    """w32 [bs, m, ch*n] int32 wire words, rows in natural order -> pow
    [bs, ch, m/2] f32 (ops/device_codec.wire_words_i32 builds w32 from wire
    bytes).

    With `offset` (the benchmark's entry), w32 is a larger staged array and
    the kernel reads its `bs` sectors from SECTOR `offset` (no copy), with
    the int32 `salt`, if given, added to every decoded sample.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/fused_chain_wire.cu (salted: csrc/fused_chain_wire_salted.cu) on
    the current stream or raises.  Every channel reads the planar window
    and phasors."""
    global WIRE_LAUNCHES, WIRE_OFFSET_LAUNCHES
    name = "fused_chain_power_wire"
    start, count = _slab(w32.shape[0], offset, bs, salt, name, "bs")
    if w32.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {w32.device}")
    if w32.dtype != torch.int32:
        raise TypeError(f"w32 must be int32 wire words, got {w32.dtype}")
    if plan.radix == 1:
        raise ValueError(f"m={plan.m} does not split into radix branches: the "
                         "wire path decodes first (wire_decode='xla')")
    g = _fft_launch_geometry(plan, name)
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
    lib = _build.load_library()
    args = (w32.data_ptr(), plan.fft_t.data_ptr(), plan.fft_phi.data_ptr(),
            plan.wd.data_ptr(), plan.phasors.data_ptr(), out.data_ptr(), count,
            plan.m, plan.n, ch, g.cols, g.blocks, start)
    with torch.cuda.device(w32.device):
        stream = torch.cuda.current_stream(w32.device).cuda_stream
        if salt is None:
            rc = lib.wrp_fused_chain_wire(*args, stream)
        else:
            rc = lib.wrp_fused_chain_wire_salted(*args, int(salt), stream)
    _raise_on_error(lib, rc, "fused_chain_wire")
    if offset is None:
        WIRE_LAUNCHES += 1
    else:
        WIRE_OFFSET_LAUNCHES += 1
    return out


def astage_tile(plan: RadixPlan) -> int:
    """Tallest tile dividing M = m / R of the matrix-form A-stage, which
    the in-kernel time breakdown runs (csrc/kernel_breakdown.cu): the block
    holds only its operator slice [M, T] (8 KB at T = 8, M = 128), so
    shared memory never binds; T = 8 measured fastest at 1024 x 512
    (PERF.md)."""
    M = plan.m // plan.radix
    for t in KERNEL_TILES:
        if M % t == 0:
            return t
    raise ValueError(f"no A-stage tile divides M={M}")


def fused_chain_astage_reference(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the A-stage kernel: x [bc, 2, m, w] int16/f32,
    natural row order, any pulse count w -> Y [bc, 2, m/2, w] f32
    (`fft_stage_reference`)."""
    yr, yi = fft_stage_reference(x, plan)
    return torch.stack([yr, yi], dim=1)


def fused_chain_astage(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, w] int16/f32 (natural row order, w = this rank's pulse
    lanes) -> Y [bc, 2, m/2, w] f32, the windowed half-spectrum range DFT.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/fused_chain_astage.cu (the FFT stage of csrc/fft_chain.cuh, cut
    by `fft_geometry(m, w)`) on the current stream or raises.  Needs a
    plan whose m splits into radix branches, as ``wrp_tpu``'s pallas-seq
    does, with m <= FFT_MAX_M."""
    global ASTAGE_LAUNCHES
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
    _fft_plan_tables(plan, name)
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
    g = fft_geometry(plan.m, w)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wrp_fused_chain_astage(
            x.data_ptr(), int(x.dtype == torch.int16), plan.fft_t.data_ptr(),
            y.data_ptr(), bc, plan.m, w, g.cols, g.blocks, stream)
    _raise_on_error(lib, rc, "fused_chain_astage")
    ASTAGE_LAUNCHES += 1
    return y


def parseval_rows_power_reference(y: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the row-epilogue kernel: Y [bc, 2, rows, n]
    f32 -> pow [bc, rows] f32 (`pipeline.stage_b_parseval`)."""
    return stage_b_parseval(y[:, 0], y[:, 1], plan.wd, plan.phasors)


def parseval_rows_power(y: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Y [bc, 2, rows, n] f32 (the full pulse axis, any slice of the m/2
    range bins) -> pow [bc, rows] f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/parseval_rows.cu on the current
    stream or raises."""
    global PARSEVAL_ROWS_LAUNCHES
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
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.wrp_parseval_rows(
            y.data_ptr(), plan.wd.data_ptr(), plan.phasors.data_ptr(),
            out.data_ptr(), bc, rows, plan.n, stream)
    _raise_on_error(lib, rc, "parseval_rows")
    PARSEVAL_ROWS_LAUNCHES += 1
    return out


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
