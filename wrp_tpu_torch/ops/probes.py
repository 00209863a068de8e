"""The TPU tools' three probe kernels as hand-written CUDA kernels.

Counterparts of the Pallas kernels in ``tools/kernel_breakdown.py``,
``tools/mxu_occupancy.py`` and ``tools/int_split_repro.py``; their entry
points are ``wrp_tpu_torch/tools/{kernel_breakdown,mxu_occupancy,
int_split_repro}.py``.  Each kernel has its wrapper, plain torch version
and launch counter:

* the in-kernel time breakdown, csrc/kernel_breakdown.cu:
  `radix_chain_ablation`, plain `radix_chain_ablation_reference`, and
  `radix_chain_astage`, plain `radix_chain_astage_reference`, all counted
  in `BREAKDOWN_LAUNCHES`.  The TPU algorithm's salted radix chain in its
  own arithmetic (bf16 hi/lo operands, the kcat operator of
  `kcat_operator`, bf16 wgmma with fp32 accumulation) whole ("full") and
  with work removed ("dots", "splits", "combine"), one body for every mode;
  beside it the matrix-form A-stage of csrc/radix_chain.cuh (fp32 SIMT) at
  its own or the breakdown body's shared memory.  Production runs the FFT
  form (csrc/fft_chain.cuh).
* the tensor-core occupancy probe, csrc/tc_occupancy.cu: `tc_dot_probe`,
  plain `tc_dot_probe_reference`, `TC_PROBE_LAUNCHES`.  bf16 x bf16 ->
  fp32 on the tensor cores (wgmma fed by TMA, a persistent grid that
  `tc_probe_plan` lays out).
* the int16 -> bf16 split check, csrc/int_split.cu: `int_split_dot`, plain
  `int_split_dot_reference`, `INT_SPLIT_LAUNCHES`; one block per tile of
  `int_split_tiles`; `split_planes` is the split alone (plain torch, any
  device).

Each wrapper sends a CPU tensor to the plain version; a CUDA tensor
launches the kernel on the current stream or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..pipeline import stage_b_parseval
from . import _build, fullchain

#: kernel launches, counted where each wrapper launches its CUDA kernel and
#: nowhere else
BREAKDOWN_LAUNCHES = 0      # kernel_breakdown.cu (every mode, the A-stage)
TC_PROBE_LAUNCHES = 0       # tc_occupancy.cu
INT_SPLIT_LAUNCHES = 0      # int_split.cu

#: the TPU tool's four modes, in its order (tools/kernel_breakdown.py)
ABLATION_MODES = ("dots", "splits", "combine", "full")
#: csrc/kernel_breakdown.cu's Mode values
_MODE = {"full": 0, "dots": 1, "splits": 2, "combine": 3}

#: lanes dotted per step by the tensor-core probe at every width: the
#: chain kernel's 24 dots x 512 pulses per channel-step
LANES_TOTAL = 24 * 512

SPLIT_VARIANTS = ("int", "f32")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_operands(name: str, *ts: torch.Tensor) -> None:
    """The mma kernels copy 16-byte chunks: operands on one device,
    contiguous, 16-byte aligned."""
    for t in ts:
        if t.device != ts[0].device:
            raise ValueError(f"{name}: operands on {ts[0].device} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte "
                             "aligned")


# ---------------------------------------------------------------------------
# the in-kernel time breakdown
# ---------------------------------------------------------------------------


#: csrc/kernel_breakdown.cu's geometry: pulses a block (two consumer
#: warpgroups of 32), operator slots in its ring (each a 64-deep K chunk of
#: the three Gauss products), the largest cluster (pulse tiles of a unit)
BD_TILE = 64
BD_STAGES = 4
BD_MAX_CLUSTER = 8
#: the Chan merge's tiles: one per warpgroup, BD_TILE / 2 pulses
BD_MERGE_COLS = 32
#: floats of one (tile, row) stat of the merge (kStat): mean re, im, the
#: sum of squares, eight phasor projections, one of padding for 16-byte loads
BD_STAT = 12


@dataclasses.dataclass(frozen=True)
class BreakdownPlan:
    """What the breakdown's kernel reads beside the radix plan: the TPU's
    K-concatenated operator and the phasor sums of the Chan merge's tiles.
    Built once per geometry (`breakdown_plan`); the production chain never
    reads it."""
    plan: fullchain.RadixPlan
    a_kcat: torch.Tensor     # [R, 3, M, 3M] bf16: per Gauss product [ah | ah | al]
    phi: torch.Tensor        # [n / BD_MERGE_COLS, 4] f32: sum of each phasor over a tile


def kcat_operator(consts, radix: int):
    """wrp_tpu's `radix_plan_host(consts, radix, layout="kcat")` in torch:
    (a [R, 3, M, 3M] bf16, fac [S][R] complex).  Per branch p and Gauss
    product (re, im, re + im of A_p in float64, cast to f32), the hi/lo
    split hi = bf16(a), lo = bf16(a - hi) (round to nearest even, as JAX
    casts) laid along K as [hi | hi | lo], matching x's [xh; xl; xh]."""
    a, fac = fullchain.radix_plan(consts, radix)
    per_branch = []
    for ap in a:
        products = []
        for mat in (ap.real, ap.imag, ap.real + ap.imag):
            f = torch.from_numpy(np.ascontiguousarray(mat).astype(np.float32))
            hi = f.to(torch.bfloat16)
            lo = (f - hi.to(torch.float32)).to(torch.bfloat16)
            products.append(torch.cat([hi, hi, lo], dim=1))
        per_branch.append(torch.stack(products))
    return torch.stack(per_branch), fac


def breakdown_plan(consts, device) -> BreakdownPlan:
    """The radix plan of `consts` with the breakdown's operator and tile
    phasor sums, on `device`."""
    plan = fullchain.build_plan(consts, device)
    if plan.radix < 2:
        raise ValueError(f"the breakdown needs the radix plan (m={plan.m} "
                         "splits into no radix branches)")
    a, _ = kcat_operator(consts, plan.radix)
    phi = fullchain.fft_round_phasor_sums(consts.clip_phasors, BD_MERGE_COLS)
    return BreakdownPlan(plan=plan, a_kcat=a.to(device),
                         phi=torch.from_numpy(phi).to(device))


def breakdown_refusal(m: int, n: int, radix: int) -> str | None:
    """Why csrc/kernel_breakdown.cu does not take the geometry, or None: it
    takes radix 8 with M = m / 8 of 64 or 128 (m = 512, 1024) and n a
    multiple of BD_TILE up to BD_TILE x BD_MAX_CLUSTER (512).  The plain
    versions take any radix geometry."""
    if radix != 8 or m % 8 or m // 8 not in (64, 128):
        return (f"the kernel takes radix 8 with m / 8 = 64 or 128, got m={m}, "
                f"radix {radix}")
    if n % BD_TILE or not BD_TILE <= n <= BD_TILE * BD_MAX_CLUSTER:
        return (f"the kernel takes n % {BD_TILE} == 0 and n <= "
                f"{BD_TILE * BD_MAX_CLUSTER}, got n={n}")
    return None


def fused_smem_bytes(plan) -> int:
    """The breakdown body's dynamic shared memory per block, every mode
    alike (226.5 KB at m = 1024): 1 KB of alignment, the operator ring
    (BD_STAGES slots of 24 KB, the three Gauss products' chunks of 64 rows
    t x 64 K columns), the x planes (hi and lo of re, im, re + im: 6 x [M,
    64] bf16), the int16 staging ([2, M, 64]), the tile's window and
    phasors (5 x 64 f32) and the barriers."""
    M = plan.m // plan.radix
    return 1024 + BD_STAGES * 3 * 8192 + 8 * M * BD_TILE * 2 + 5 * BD_TILE * 4 + 256


def _split_planes(v: torch.Tensor, lo: bool):
    """f32 v -> (hi, lo) as f32 values: hi = bf16(v), lo = bf16(v - hi)
    (wrp_tpu's _split_bf16), or lo = hi without lo planes (`dots`)."""
    hi = v.to(torch.bfloat16).to(torch.float32)
    if not lo:
        return hi, hi
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def radix_chain_ablation_reference(x_all: torch.Tensor, bp: BreakdownPlan,
                                   mode: str, offset: int, bc: int,
                                   salt: int) -> torch.Tensor:
    """Plain torch version of `radix_chain_ablation` on the slab x_all[offset:
    offset + bc] with `salt` added to every sample in f32 -> [bc, m/2] f32.

    The TPU kernel's arithmetic: per branch p (rows p::R) and Gauss product
    (re, im, re + im of x) the stack [xh; xl; xh] against the kcat
    operator [ah | ah | al] (products exact in fp32, summed in fp32), g_p =
    (m1 - m2, m3 - m1 - m2); `dots` without lo planes ([xh; xh; xh]).
    dots, splits: row s M + t holds sum_j (Re + Im)(g_s + g_{s+S})[t, j];
    combine: the row sums of Yr + Yi, Y_s = sum_p fac[s][p] g_p; full: the
    Parseval epilogue of Y (`pipeline.stage_b_parseval`)."""
    plan = bp.plan
    R, S = plan.radix, plan.radix // 2
    x = x_all[offset:offset + bc].to(torch.float32) + float(salt)
    xr, xi = x[:, 0], x[:, 1]
    a = bp.a_kcat.to(torch.float32)
    lo = mode != "dots"
    G = []
    for p in range(R):
        prods = []
        for g, v in enumerate((xr[:, p::R], xi[:, p::R], xr[:, p::R] + xi[:, p::R])):
            h, l = _split_planes(v, lo)
            prods.append(a[p, g] @ torch.cat([h, l, h], dim=-2))
        m1, m2, m3 = prods
        G.append((m1 - m2, m3 - m1 - m2))
    if mode in ("dots", "splits"):
        return torch.cat([(G[s][0] + G[s + S][0] + G[s][1] + G[s + S][1]).sum(-1)
                          for s in range(S)], dim=-1)
    ys_r, ys_i = [0.0] * S, [0.0] * S
    for p, (gr, gi) in enumerate(G):
        for s in range(S):
            f = plan.fac[s][p]
            ys_r[s] = ys_r[s] + (f.real * gr - f.imag * gi)
            ys_i[s] = ys_i[s] + (f.real * gi + f.imag * gr)
    yr, yi = torch.cat(ys_r, dim=-2), torch.cat(ys_i, dim=-2)
    if mode == "combine":
        return yr.sum(-1) + yi.sum(-1)
    return stage_b_parseval(yr, yi, plan.wd, plan.phasors)


def radix_chain_ablation(x_all: torch.Tensor, bp: BreakdownPlan, mode: str,
                         offset: int, bc: int, salt: int) -> torch.Tensor:
    """One mode of the TPU algorithm's salted radix chain (its matrix form
    on bf16 hi/lo operands) on `bc` channel-sectors of the staged x_all
    [BC, 2, m, n] int16 (natural row order) from channel-sector `offset`,
    with the int32 `salt` added to every sample -> [bc, m/2] f32 (see
    `radix_chain_ablation_reference`): dots, splits, combine, full, every
    mode one body of csrc/kernel_breakdown.cu on one grid at one shared
    memory.  A CPU tensor takes the plain version (any radix geometry); a
    CUDA tensor launches the kernel (`breakdown_refusal` says what it
    takes) or raises."""
    global BREAKDOWN_LAUNCHES
    plan = bp.plan
    name = f"radix_chain_ablation ({mode})"
    if mode not in ABLATION_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; modes "
                         f"{', '.join(ABLATION_MODES)}")
    if plan.radix < 2:
        raise ValueError(f"{name} needs the radix plan (m={plan.m} splits "
                         "into no radix branches)")
    start, count = fullchain._slab(x_all.shape[0], offset, bc, salt, name, "bc")
    if x_all.device.type == "cpu":
        return radix_chain_ablation_reference(x_all, bp, mode, start, count,
                                              salt)
    _check_cuda(x_all, name)
    if x_all.dtype != torch.int16:
        raise TypeError(f"{name}: the ablations are built for int16 input, "
                        f"got {x_all.dtype}")
    fullchain._check_planar(x_all, plan, name)
    why = breakdown_refusal(plan.m, plan.n, plan.radix)
    if why:
        raise ValueError(f"{name}: {why}")
    _check_operands(name, x_all, bp.a_kcat)
    if count > 65535:
        raise ValueError(f"{name}: bc {count} > 65535 (the grid's z extent)")
    out = torch.empty((count, plan.m // 2), dtype=torch.float32,
                      device=x_all.device)
    if count == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x_all.device):
        rc = lib.wrp_breakdown(
            x_all.data_ptr(), bp.a_kcat.data_ptr(), plan.fac_t.data_ptr(),
            plan.wd.data_ptr(), plan.phasors.data_ptr(), bp.phi.data_ptr(),
            out.data_ptr(), x_all.shape[0], count, plan.m, plan.n, start,
            int(salt), _MODE[mode], _stream(x_all))
    fullchain._raise_on_error(lib, rc, name)
    BREAKDOWN_LAUNCHES += 1
    return out


def radix_chain_astage_reference(x: torch.Tensor, plan) -> torch.Tensor:
    """Plain torch version of `radix_chain_astage`: the matrix form's
    contraction and combine, Y [bc, 2, m/2, w] f32."""
    yr, yi = fullchain._contract_reference(x, plan)
    return torch.stack([yr, yi], dim=1)


def radix_chain_astage(x: torch.Tensor, plan, min_smem: int = 0) -> torch.Tensor:
    """The matrix-form A-stage (csrc/kernel_breakdown.cu, radix_chain_kernel
    of csrc/radix_chain.cuh) on x [bc, 2, m, w] int16 -> Y [bc, 2, m/2, w] f32,
    with at least `min_smem` bytes of dynamic shared memory requested per
    block, which it does not use: at `fused_smem_bytes(plan)` it runs at
    the breakdown body's blocks per SM.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    global BREAKDOWN_LAUNCHES
    name = "radix_chain_astage"
    if x.device.type == "cpu":
        return radix_chain_astage_reference(x, plan)
    _check_cuda(x, name)
    if x.dtype != torch.int16 or x.dim() != 4 or x.shape[1:3] != (2, plan.m):
        raise ValueError(f"{name}: x must be int16 [bc, 2, {plan.m}, w], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if plan.radix < 2 or not x.is_contiguous() or plan.device != x.device:
        raise ValueError(f"{name}: needs a radix plan on {x.device} and a "
                         "contiguous x")
    bc, w = x.shape[0], x.shape[3]
    y = torch.empty((bc, 2, plan.m // 2, w), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.wrp_radix_chain_astage(
            x.data_ptr(), plan.a_kernel.data_ptr(), plan.fac_t.data_ptr(),
            y.data_ptr(), bc, plan.m, w, plan.radix, fullchain.astage_tile(plan),
            int(min_smem), _stream(x))
    fullchain._raise_on_error(lib, rc, name)
    BREAKDOWN_LAUNCHES += 1
    return y


def blocks_per_sm(plan, body: str, min_smem: int = 0) -> int:
    """Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    at the plan's geometry of the breakdown body in mode `body` (one of
    ABLATION_MODES, at its dynamic shared memory) or of "astage" (the
    matrix-form A-stage on all n pulses, at least `min_smem` bytes of
    dynamic shared memory).  Needs CUDA."""
    lib = _build.load_library()
    blocks = ctypes.c_int(0)
    if body == "astage":
        rc = lib.wrp_radix_chain_astage_blocks_per_sm(
            plan.radix, fullchain.astage_tile(plan), plan.m, int(min_smem),
            ctypes.addressof(blocks))
    elif body in ABLATION_MODES:
        rc = lib.wrp_breakdown_blocks_per_sm(_MODE[body], plan.m, plan.n,
                                             ctypes.addressof(blocks))
    else:
        raise ValueError(f"unknown body {body!r}")
    fullchain._raise_on_error(lib, rc, f"blocks_per_sm ({body})")
    return blocks.value

# ---------------------------------------------------------------------------
# the tensor-core occupancy probe
# ---------------------------------------------------------------------------


#: csrc/tc_occupancy.cu's geometry: rows of the stacked A a block holds,
#: columns a unit, the deepest K its row block fits in shared memory
TC_ROWS = 256
TC_COLS = 128
TC_KMAX = 384


def _probe_shape(a: torch.Tensor, x: torch.Tensor, width: int, steps: int,
                 distinct: int, lanes_total: int):
    """(ndots, wmax) of a probe call, after checking its arguments against
    what csrc/tc_occupancy.cu takes (on every device, so a shape the kernel
    refuses raises the same ValueError on the CPU)."""
    if a.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"tc_dot_probe: a and x must be bfloat16, got "
                        f"{a.dtype}, {x.dtype}")
    if a.dim() != 3 or x.dim() != 2 or x.shape[0] != a.shape[2]:
        raise ValueError(f"tc_dot_probe: a must be [ndots, M, K] and x [K, "
                         f"distinct * wmax], got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}")
    if distinct < 1 or x.shape[1] % distinct:
        raise ValueError(f"tc_dot_probe: x's {x.shape[1]} columns do not "
                         f"split into {distinct} slabs")
    wmax = x.shape[1] // distinct
    if width < 1 or lanes_total % width or width > wmax:
        raise ValueError(f"tc_dot_probe: width {width} must divide "
                         f"lanes_total {lanes_total} and be <= {wmax}")
    ndots = lanes_total // width
    if ndots > a.shape[0]:
        raise ValueError(f"tc_dot_probe: width {width} needs {ndots} dots, "
                         f"a holds {a.shape[0]}")
    if steps < 1:
        raise ValueError(f"tc_dot_probe: steps {steps} < 1")
    M, K = a.shape[1], a.shape[2]
    if M < 1 or K < 16 or K % 16 or K > TC_KMAX:
        raise ValueError(f"tc_dot_probe: the kernel takes K % 16 == 0 and 16 "
                         f"<= K <= {TC_KMAX} (M >= 1), got M {M}, K {K}")
    if width % 8 or wmax % 8:
        raise ValueError(f"tc_dot_probe: the kernel takes width and wmax "
                         f"multiples of 8, got {width}, {wmax}")
    if ndots * M > 2**31 - 1 or x.shape[1] > 2**31 - 1:
        raise ValueError("tc_dot_probe: ndots * M and x's columns must fit "
                         "in int32")
    return ndots, wmax


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The persistent grid of one `tc_dot_probe` call: units (row block rb
    of TC_ROWS rows of A[:ndots] stacked as [ndots M, K], step b, column
    tile ct of TC_COLS columns), ordered rb, b, ct; block i of `blocks`
    takes units [units i / blocks, units (i + 1) / blocks)."""
    row_blocks: int
    steps: int
    col_tiles: int
    blocks: int

    @property
    def units(self) -> int:
        return self.row_blocks * self.steps * self.col_tiles

    def block_units(self, i: int) -> range:
        return range(self.units * i // self.blocks,
                     self.units * (i + 1) // self.blocks)

    def unit(self, u: int):
        """(rb, b, ct) of unit u."""
        t, ct = divmod(u, self.col_tiles)
        rb, b = divmod(t, self.steps)
        return rb, b, ct


def tc_probe_plan(M: int, width: int, ndots: int, steps: int,
                  sms: int) -> TcPlan:
    """The grid of a call on a card of `sms` SMs: one block per SM, never
    more blocks than units."""
    row_blocks, col_tiles = -(-ndots * M // TC_ROWS), -(-width // TC_COLS)
    return TcPlan(row_blocks, steps, col_tiles,
                  max(1, min(sms, row_blocks * steps * col_tiles)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tc_dot_probe_reference(a: torch.Tensor, x: torch.Tensor, width: int,
                           steps: int, distinct: int,
                           lanes_total: int = LANES_TOTAL) -> torch.Tensor:
    """Plain torch version of `tc_dot_probe`: step b's rowsum(sum_d A_d @
    X[:, slab(b)]) in fp32 (bf16 values are exact in fp32) -> [steps, M]."""
    ndots, wmax = _probe_shape(a, x, width, steps, distinct, lanes_total)
    af, xf = a[:ndots].float(), x.float()
    out = torch.empty((steps, a.shape[1]), dtype=torch.float32, device=a.device)
    for b in range(steps):
        c0 = (b % distinct) * wmax
        out[b] = (af @ xf[:, c0:c0 + width]).sum(dim=(0, 2))
    return out


def tc_dot_probe(a: torch.Tensor, x: torch.Tensor, width: int, steps: int,
                 distinct: int, lanes_total: int = LANES_TOTAL) -> torch.Tensor:
    """The tensor-core occupancy probe: a [ndots_max, M, K] bf16, x [K,
    distinct * wmax] bf16 -> out [steps, M] f32, step b's
    rowsum(sum_{d < ndots} A_d @ X[:, slab(b)]) with ndots = lanes_total /
    width and slab(b) the `width` columns from (b mod distinct) * wmax
    (``tools/mxu_occupancy.py``'s kernel).

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/tc_occupancy.cu (bf16 wgmma fed by TMA, fp32 accumulation, the
    grid of `tc_probe_plan`; K % 16 == 0 and <= 384, width and wmax % 8 ==
    0, any M) or raises.  Its blocks add into `out` with atomics, so `out`
    is zeroed first (torch.zeros, a memset)."""
    global TC_PROBE_LAUNCHES
    ndots, wmax = _probe_shape(a, x, width, steps, distinct, lanes_total)
    if a.device.type == "cpu":
        return tc_dot_probe_reference(a, x, width, steps, distinct, lanes_total)
    _check_cuda(a, "tc_dot_probe")
    _check_operands("tc_dot_probe", a, x)
    M = a.shape[1]
    plan = tc_probe_plan(M, width, ndots, steps, _sm_count(a.device.index))
    out = torch.zeros((steps, M), dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        rc = lib.wrp_tc_dot_probe(a.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  M, a.shape[2], width, wmax, distinct, ndots,
                                  steps, plan.blocks, _stream(a))
    fullchain._raise_on_error(lib, rc, "tc_dot_probe")
    TC_PROBE_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# the int16 -> bf16 split check
# ---------------------------------------------------------------------------


def split_planes(x: torch.Tensor, variant: str):
    """int16 x -> (hi, lo) bf16 planes as the TPU kernel split them, rounding
    to nearest even: "int" masks (lo = v & 63, hi = v - lo), "f32" casts
    (h = bf16(float(v)), l = bf16(float(v) - h))."""
    if x.dtype != torch.int16:
        raise TypeError(f"split_planes: x must be int16, got {x.dtype}")
    if variant == "int":
        lo = x & 63
        return (x - lo).to(torch.bfloat16), lo.to(torch.bfloat16)
    if variant == "f32":
        f = x.to(torch.float32)
        h = f.to(torch.bfloat16)
        return h, (f - h.to(torch.float32)).to(torch.bfloat16)
    raise ValueError(f"unknown split variant {variant!r}; variants "
                     f"{', '.join(SPLIT_VARIANTS)}")


def split_inexact_count(x: torch.Tensor, variant: str) -> int:
    """How many samples of x the split does not reconstruct: hi + lo != v
    (evaluated exactly in fp32)."""
    hi, lo = split_planes(x, variant)
    return int((hi.float() + lo.float() != x.float()).sum())


def int_split_dot_reference(x: torch.Tensor, a: torch.Tensor,
                            variant: str) -> torch.Tensor:
    """Plain torch version of `int_split_dot`: the same split, then fp32
    products A @ hi + A @ lo."""
    hi, lo = split_planes(x, variant)
    af = a.to(torch.float32)
    return af @ hi.to(torch.float32) + af @ lo.to(torch.float32)


#: csrc/int_split.cu's tile of out per block, and the largest m its shared
#: memory takes
SPLIT_TILE = 32
SPLIT_MMAX = 1024


def int_split_tiles(m: int, n: int) -> list:
    """(row0, col0) of each block's SPLIT_TILE x SPLIT_TILE tile of out
    (csrc/int_split.cu's grid: ragged edge tiles store nothing past m, n)."""
    return [(r, c) for r in range(0, m, SPLIT_TILE)
            for c in range(0, n, SPLIT_TILE)]


def int_split_dot(x: torch.Tensor, a: torch.Tensor, variant: str) -> torch.Tensor:
    """x [m, n] int16, a [m, m] bf16 -> A @ hi + A @ lo [m, n] f32, with the
    split of `split_planes` (``tools/int_split_repro.py``'s kernel).  The
    shapes are those csrc/int_split.cu takes, on every device: m % 16 == 0
    and 16 <= m <= 1024, n % 8 == 0.

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/int_split.cu (one block per tile of `int_split_tiles`, the split in
    registers, the two dots on the tensor cores) or raises."""
    global INT_SPLIT_LAUNCHES
    if variant not in SPLIT_VARIANTS:
        raise ValueError(f"unknown split variant {variant!r}; variants "
                         f"{', '.join(SPLIT_VARIANTS)}")
    if x.dtype != torch.int16 or a.dtype != torch.bfloat16:
        raise TypeError(f"int_split_dot: x must be int16 and a bfloat16, got "
                        f"{x.dtype}, {a.dtype}")
    if x.dim() != 2 or a.dim() != 2 or a.shape != (x.shape[0], x.shape[0]):
        raise ValueError(f"int_split_dot: x must be [m, n] and a [m, m], got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}")
    m, n = x.shape
    if m < 16 or m % 16 or m > SPLIT_MMAX or n < 8 or n % 8:
        raise ValueError(f"int_split_dot: the kernel takes m % 16 == 0, 16 <= "
                         f"m <= {SPLIT_MMAX} and n % 8 == 0, got [{m}, {n}]")
    if x.device.type == "cpu":
        return int_split_dot_reference(x, a, variant)
    _check_cuda(x, "int_split_dot")
    _check_operands("int_split_dot", x, a)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.wrp_int_split_dot(x.data_ptr(), a.data_ptr(), out.data_ptr(),
                                   m, n, SPLIT_VARIANTS.index(variant),
                                   _stream(x))
    fullchain._raise_on_error(lib, rc, "int_split_dot")
    INT_SPLIT_LAUNCHES += 1
    return out
