"""The fused chain (stages 01-08) as hand-written CUDA kernels.

Counterpart of ``wrp_tpu/ops/pallas/fullchain.py``: per channel-sector,
IQ [2, m, n] -> matched-filter power [m/2] via a half-spectrum range DFT
followed by the closed-form Parseval epilogue (``pipeline.stage_b_parseval``).
Three kernels, each with its wrapper, plain torch version and launch
counter:

* radix, csrc/fused_chain_radix.cu (``wrp_tpu`` `fused_chain_power_radix`):
  `fused_chain_power_radix`, plain `fused_chain_power_reference`,
  `LAUNCHES`.  Planar int16/f32 IQ through an R-branch decimation-in-time
  DFT, for m that splits (`radix_for(m) > 1`).
* wire, csrc/fused_chain_wire.cu (``wrp_tpu`` `fused_chain_power_wire`):
  `fused_chain_power_wire`, plain `fused_chain_power_wire_reference`,
  `WIRE_LAUNCHES`.  The same contraction on raw wire words [bs, m, ch*n]
  int32, decoded in registers, with a per-channel epilogue.  The radix
  and wire kernels are one kernel body (csrc/radix_chain.cuh) with two
  load policies.
* dense, csrc/fused_chain_dense.cu (``wrp_tpu`` `fused_chain_power`):
  `fused_chain_power_dense`, plain `fused_chain_power_reference` (its
  R == 1 branch), `DENSE_LAUNCHES`.  Planar IQ through the dense A_half
  [m/2, m], for m that does not split (`radix_for(m) == 1`).

The pulse-sharded path (parallel/sharded.py "pallas-seq") splits the
radix chain at its one communication point, with a kernel on each side:

* A-stage, csrc/fused_chain_astage.cu (``wrp_tpu`` `fused_chain_astage`):
  `fused_chain_astage`, plain `fused_chain_astage_reference`,
  `ASTAGE_LAUNCHES`.  The radix kernel's contraction on a rank's pulse
  slab [bc, 2, m, w] -> Y [bc, 2, m/2, w] (the same kernel body).
* row epilogue, csrc/parseval_rows.cu (``wrp_tpu`` `parseval_rows_power`):
  `parseval_rows_power`, plain `parseval_rows_power_reference`,
  `PARSEVAL_ROWS_LAUNCHES`.  The Parseval epilogue on full-pulse rows
  Y [bc, 2, rows, n] -> pow [bc, rows].

The host plan (`radix_for`, `radix_row_order`, `radix_plan`, `build_plan`)
holds the branch operators A_p = F_M diag(w_r c)[p::R] diag(T_p), with the
window row factor and the DIT twiddles folded in, and the combine factors
fac[s][p] = exp(-2 pi i p s / R) (R == 1: A_half itself).  Each wrapper
sends a CPU tensor to the plain version; a CUDA tensor launches the kernel
or raises.

Rows stay in NATURAL order everywhere: the kernels read branch p's rows
R q + p by index arithmetic, so ``wrp_tpu``'s radix row layout
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
    wd_il: torch.Tensor | None = None   # [ch*n] channel-tiled wd (wire kernel)
    ph_il: torch.Tensor | None = None   # [4, ch*n] channel-tiled phasors

    @property
    def device(self) -> torch.device:
        return self.a.device


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

    def snap(v: complex) -> complex:
        # exact 4th roots of unity stay exact in f32
        re = round(v.real) if abs(v.real - round(v.real)) < 1e-12 else v.real
        im = round(v.imag) if abs(v.imag - round(v.imag)) < 1e-12 else v.imag
        return complex(re, im)

    fac = tuple(tuple(snap(om ** (p * s)) for p in range(radix))
                for s in range(S))
    return a, fac


def wire_lane_consts(consts: PipelineConstants, ch: int):
    """Channel-tiled epilogue constants of the wire kernel: (wd_il [L],
    ph_il [4, L]) f32, L = ch*n, with entry ch*j + c equal to the planar
    entry j for every channel c (the wire interleaves channels per sample,
    so lane ch*j + c is channel c, pulse j)."""
    wd_il = np.repeat(np.asarray(consts.wd, np.float32), ch)
    ph_il = np.repeat(np.asarray(consts.clip_phasors, np.float32), ch, axis=1)
    return wd_il, ph_il


def build_plan(consts: PipelineConstants, device,
               channels: int | None = None) -> RadixPlan:
    """The plan for `consts`' geometry, on `device`; with `channels`, also
    the channel-tiled constants the wire kernel reads."""
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
    if channels is not None:
        wd_il, ph_il = wire_lane_consts(consts, channels)
        lanes = {"wd_il": torch.from_numpy(wd_il).to(device),
                 "ph_il": torch.from_numpy(ph_il).to(device)}
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


def fused_chain_power_reference(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the radix and dense kernels: x [bc, 2, m, n]
    int16/f32 in natural row order -> pow [bc, m/2] f32.  The contraction
    (`_contract_reference`), then the Parseval epilogue."""
    yr, yi = _contract_reference(x, plan)
    return stage_b_parseval(yr, yi, plan.wd, plan.phasors)


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


def fused_chain_power_radix(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, n] int16/f32, rows in natural order -> pow [bc, m/2] f32.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    kernel on the current stream (no synchronisation) or raises; there is
    no fallback."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_chain_power_reference(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain_power_radix: unsupported device {x.device}")
    if plan.radix == 1:
        raise ValueError(f"m={plan.m} does not split into radix branches: "
                         "use fused_chain_power_dense")
    _check_planar(x, plan, "fused_chain_power_radix")
    bc = x.shape[0]
    out = torch.empty((bc, plan.m // 2), dtype=torch.float32, device=x.device)
    if bc == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wrp_fused_chain_radix(
            x.data_ptr(), int(x.dtype == torch.int16), plan.a_kernel.data_ptr(),
            plan.fac_t.data_ptr(), plan.wd.data_ptr(), plan.phasors.data_ptr(),
            out.data_ptr(), bc, plan.m, plan.n, plan.radix, kernel_tile(plan),
            stream)
    _raise_on_error(lib, rc, "fused_chain_radix")
    LAUNCHES += 1
    return out


def fused_chain_power_dense(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, n] int16/f32 -> pow [bc, m/2] f32 through the dense
    A_half, for a plan with radix 1.  A CPU tensor takes the plain version
    (the R == 1 branch of `fused_chain_power_reference`); a CUDA tensor
    launches csrc/fused_chain_dense.cu or raises."""
    global DENSE_LAUNCHES
    if plan.radix != 1:
        raise ValueError(f"fused_chain_power_dense needs a radix-1 plan; m="
                         f"{plan.m} splits into {plan.radix} branches")
    if x.device.type == "cpu":
        return fused_chain_power_reference(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain_power_dense: unsupported device {x.device}")
    _check_planar(x, plan, "fused_chain_power_dense")
    bc = x.shape[0]
    out = torch.empty((bc, plan.m // 2), dtype=torch.float32, device=x.device)
    if bc == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wrp_fused_chain_dense(
            x.data_ptr(), int(x.dtype == torch.int16), plan.a_kernel.data_ptr(),
            plan.wd.data_ptr(), plan.phasors.data_ptr(), out.data_ptr(), bc,
            plan.m, plan.n, dense_tile(plan), stream)
    _raise_on_error(lib, rc, "fused_chain_dense")
    DENSE_LAUNCHES += 1
    return out


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
                                     ch: int) -> torch.Tensor:
    """Plain torch version of the wire kernel: w32 [bs, m, ch*n] int32 ->
    pow [bs, ch, m/2] f32.  Decode the words, deinterleave the channels,
    then `fused_chain_power_reference` on the planar sectors."""
    bs, m, lanes = w32.shape
    i_, q_ = decode_words_iq(w32)
    planar = torch.stack([i_, q_], dim=1).reshape(bs, 2, m, lanes // ch, ch)
    planar = planar.permute(0, 4, 1, 2, 3).reshape(bs * ch, 2, m, lanes // ch)
    return fused_chain_power_reference(planar.to(torch.float32),
                                       plan).reshape(bs, ch, m // 2)


def fused_chain_power_wire(w32: torch.Tensor, plan: RadixPlan,
                           ch: int) -> torch.Tensor:
    """w32 [bs, m, ch*n] int32 wire words, rows in natural order -> pow
    [bs, ch, m/2] f32 (ops/device_codec.wire_words_i32 builds w32 from wire
    bytes).

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/fused_chain_wire.cu on the current stream or raises; the plan
    must carry the channel-tiled constants (build_plan(channels=ch))."""
    global WIRE_LAUNCHES
    if w32.device.type == "cpu":
        if w32.dtype != torch.int32:
            raise TypeError(f"w32 must be int32 wire words, got {w32.dtype}")
        return fused_chain_power_wire_reference(w32, plan, ch)
    if w32.device.type != "cuda":
        raise ValueError(f"fused_chain_power_wire: unsupported device {w32.device}")
    if plan.radix == 1:
        raise ValueError(f"m={plan.m} does not split into radix branches: the "
                         "wire path decodes first (wire_decode='xla')")
    if w32.dtype != torch.int32:
        raise TypeError(f"w32 must be int32 wire words, got {w32.dtype}")
    L = ch * plan.n
    if w32.dim() != 3 or tuple(w32.shape[1:]) != (plan.m, L):
        raise ValueError(f"w32 must be [bs, {plan.m}, {L}], got "
                         f"{tuple(w32.shape)}")
    if not w32.is_contiguous():
        raise ValueError("w32 must be contiguous")
    if plan.device != w32.device:
        raise ValueError(f"plan is on {plan.device}, w32 on {w32.device}")
    if plan.wd_il is None or plan.wd_il.shape[0] != L:
        raise ValueError(f"plan carries no channel-tiled constants for {ch} "
                         "channels: build it with build_plan(channels=ch)")
    bs = w32.shape[0]
    out = torch.empty((bs, ch, plan.m // 2), dtype=torch.float32,
                      device=w32.device)
    if bs == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(w32.device):
        stream = torch.cuda.current_stream(w32.device).cuda_stream
        rc = lib.wrp_fused_chain_wire(
            w32.data_ptr(), plan.a_kernel.data_ptr(), plan.fac_t.data_ptr(),
            plan.wd_il.data_ptr(), plan.ph_il.data_ptr(), out.data_ptr(), bs,
            plan.m, plan.n, ch, plan.radix, kernel_tile(plan), stream)
    _raise_on_error(lib, rc, "fused_chain_wire")
    WIRE_LAUNCHES += 1
    return out


def astage_tile(plan: RadixPlan) -> int:
    """Tallest tile of the A-stage kernel dividing M = m / R.  The block
    holds only its operator slice [M, T] (8 KB at T = 8, M = 128), so
    shared memory never binds; T = 8 measured fastest at 1024 x 512
    (tools/kernel_ab.py's tile sweep, PERF.md)."""
    M = plan.m // plan.radix
    for t in KERNEL_TILES:
        if M % t == 0:
            return t
    raise ValueError(f"no A-stage tile divides M={M}")


def fused_chain_astage_reference(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the A-stage kernel: x [bc, 2, m, w] int16/f32,
    natural row order, any pulse count w -> Y [bc, 2, m/2, w] f32."""
    yr, yi = _contract_reference(x, plan)
    return torch.stack([yr, yi], dim=1)


def fused_chain_astage(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """x [bc, 2, m, w] int16/f32 (natural row order, w = this rank's pulse
    lanes) -> Y [bc, 2, m/2, w] f32, the windowed half-spectrum range DFT.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/fused_chain_astage.cu on the current stream (`astage_tile` sub-DFT
    rows per block) or raises.  Needs a plan whose m
    splits into radix branches, as ``wrp_tpu``'s pallas-seq does."""
    global ASTAGE_LAUNCHES
    if plan.radix < 2:
        raise ValueError(f"the A-stage needs the radix plan (m={plan.m} "
                         "supports radix 1 only)")
    if x.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"fused_chain_astage: x must be int16 or float32, "
                        f"got {x.dtype}")
    if x.dim() != 4 or tuple(x.shape[1:3]) != (2, plan.m) or x.shape[3] < 1:
        raise ValueError(f"fused_chain_astage: x must be [bc, 2, {plan.m}, w], "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_chain_astage_reference(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"fused_chain_astage: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_chain_astage: x must be contiguous")
    if plan.device != x.device:
        raise ValueError(f"fused_chain_astage: plan is on {plan.device}, x on "
                         f"{x.device}")
    bc, w = x.shape[0], x.shape[3]
    y = torch.empty((bc, 2, plan.m // 2, w), dtype=torch.float32,
                    device=x.device)
    if bc == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.wrp_fused_chain_astage(
            x.data_ptr(), int(x.dtype == torch.int16), plan.a_kernel.data_ptr(),
            plan.fac_t.data_ptr(), y.data_ptr(), bc, plan.m, w, plan.radix,
            astage_tile(plan), stream)
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
