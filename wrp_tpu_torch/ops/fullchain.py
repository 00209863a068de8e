"""The fused chain (stages 01-08) as one hand-written CUDA kernel.

Counterpart of ``wrp_tpu/ops/pallas/fullchain.py::fused_chain_power_radix``:
per channel-sector, planar IQ [2, m, n] -> matched-filter power [m/2] via an
R-branch decimation-in-time half-spectrum range DFT followed by the closed-
form Parseval epilogue (``pipeline.stage_b_parseval``).

Three pieces, as for every kernel of the port:

* the host plan (`radix_for`, `radix_row_order`, `radix_plan`): branch
  operators A_p = F_M diag(w_r c)[p::R] diag(T_p) with the window row factor
  and the DIT twiddles folded in, plus the combine factors
  fac[s][p] = exp(-2 pi i p s / R);
* the plain version `fused_chain_power_reference`, in torch;
* the wrapper `fused_chain_power_radix`: a CPU tensor takes the plain
  version; a CUDA tensor launches csrc/fused_chain_radix.cu or raises.

Rows stay in NATURAL order everywhere: the kernel reads branch p's rows
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

#: kernel launches, counted where the wrapper launches the CUDA kernel and
#: nowhere else (chip_smoke.py resets and reads it around the stream run)
LAUNCHES = 0

RADIX = 8

#: tile heights (sub-DFT rows per block) the kernel is instantiated for
KERNEL_TILES = (8, 4, 2)

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


def build_plan(consts: PipelineConstants, device) -> RadixPlan:
    """The plan for `consts`' geometry, on `device`."""
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
    return RadixPlan(
        radix=radix, m=m, n=n,
        a=a_t,
        a_kernel=a_t.permute(0, 3, 2, 1).contiguous(),
        fac=fac,
        fac_t=torch.from_numpy(fac_np).to(device),
        wd=torch.from_numpy(np.asarray(consts.wd, np.float32)).to(device),
        phasors=torch.from_numpy(
            np.asarray(consts.clip_phasors, np.float32)).to(device),
    )


def fused_chain_power_reference(x: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Plain torch version of the kernel: x [bc, 2, m, n] int16/f32 in
    natural row order -> pow [bc, m/2] f32.  Per-branch fp32 matmuls on the
    strided row views x[..., p::R, :], the generic complex combine, then
    the Parseval epilogue.  R == 1 contracts the dense A_half."""
    xf = x.to(torch.float32)
    xr, xi = xf[:, 0], xf[:, 1]
    ar, ai = plan.a[:, 0], plan.a[:, 1]
    R = plan.radix
    if R == 1:
        yr = ar[0] @ xr - ai[0] @ xi
        yi = ar[0] @ xi + ai[0] @ xr
    else:
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
        yr = torch.cat(ys_r, dim=-2)
        yi = torch.cat(ys_i, dim=-2)
    return stage_b_parseval(yr, yi, plan.wd, plan.phasors)


def kernel_tile(plan: RadixPlan) -> int:
    """Tallest tile whose Y rows [S*T, n] and operator slice [M, T] fit in
    one block's shared memory (T = 8 at m = 1024, n = 512: 136 KB)."""
    S = plan.radix // 2
    M = plan.m // plan.radix
    for t in KERNEL_TILES:
        if M % t == 0 and (2 * S * t * plan.n + 2 * t * M) * 4 <= MAX_SMEM_BYTES:
            return t
    raise ValueError(f"no kernel tile fits m={plan.m}, n={plan.n} in "
                     f"{MAX_SMEM_BYTES} bytes of shared memory")


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
        raise NotImplementedError(
            f"m={plan.m} does not split into radix branches; the dense "
            "fused kernel (wrp_tpu fused_chain_power) is not ported yet "
            "(ROADMAP.md Queue 2)")
    if x.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"x must be int16 or float32, got {x.dtype}")
    if x.dim() != 4 or tuple(x.shape[1:]) != (2, plan.m, plan.n):
        raise ValueError(f"x must be [bc, 2, {plan.m}, {plan.n}], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if plan.device != x.device:
        raise ValueError(f"plan is on {plan.device}, x on {x.device}")
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
    if rc != 0:
        raise RuntimeError("fused_chain_radix launch failed: "
                           + lib.wrp_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return out


def build_fused_processor(consts: PipelineConstants, device):
    """fn(iq_planar [B, C, 2, m, n]) -> pow [B, C, m/2] through the fused
    kernel (the plan is built once, on `device`)."""
    plan = build_plan(consts, device)
    if plan.device.type == "cuda" and plan.radix == 1:
        raise NotImplementedError(
            f"m={plan.m} does not split into radix branches; the dense "
            "fused kernel is not ported yet (ROADMAP.md Queue 2)")

    def fn(iq_planar: torch.Tensor) -> torch.Tensor:
        b, c, two, m, n = iq_planar.shape
        p = fused_chain_power_radix(
            iq_planar.reshape(b * c, two, m, n).contiguous(), plan)
        return p.reshape(b, c, -1)

    return fn
