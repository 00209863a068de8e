"""The TPU tools' three probe kernels as hand-written CUDA kernels.

Counterparts of the Pallas kernels in ``tools/kernel_breakdown.py``,
``tools/mxu_occupancy.py`` and ``tools/int_split_repro.py``; their entry
points are ``wrp_tpu_torch/tools/{kernel_breakdown,mxu_occupancy,
int_split_repro}.py``.  Each kernel has its wrapper, plain torch version
and launch counter:

* the in-kernel time breakdown, csrc/kernel_breakdown.cu:
  `radix_chain_ablation`, plain `radix_chain_ablation_reference`, and
  `radix_chain_astage`, plain `radix_chain_astage_reference`, all counted
  in `BREAKDOWN_LAUNCHES`.  The TPU algorithm's matrix-form salted radix
  chain (csrc/radix_chain.cuh, the port's first production body; production
  now runs the FFT form, csrc/fft_chain.cuh) whole ("full") and with work
  removed ("dots", "combine"), and its A-stage at its own or the full
  body's shared memory: every mode ablates that one body.
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

import torch

from . import _build, fullchain

#: kernel launches, counted where each wrapper launches its CUDA kernel and
#: nowhere else
BREAKDOWN_LAUNCHES = 0      # kernel_breakdown.cu (every mode, the A-stage)
TC_PROBE_LAUNCHES = 0       # tc_occupancy.cu
INT_SPLIT_LAUNCHES = 0      # int_split.cu

ABLATION_MODES = ("dots", "combine", "full")
#: the matrix-form bodies' wrp::Body values (csrc/radix_chain.cuh)
_BODY = {"full": 0, "astage": 1, "dots": 2, "combine": 3}
#: why the TPU tool's `splits` mode has no counterpart
SPLITS_REFUSAL = ("mode 'splits' has no counterpart in the port: its chain "
                  "kernel contracts in fp32 and does no bf16 hi/lo operand "
                  "split (csrc/radix_chain.cuh); the split's cost on the "
                  "tensor cores is what int_split_dot measures")

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


def radix_chain_ablation_reference(x_all: torch.Tensor, plan, mode: str,
                                   offset: int, bc: int, salt: int) -> torch.Tensor:
    """Plain torch version of `radix_chain_ablation` on the slab x_all[offset:
    offset + bc] with `salt` added to every sample -> [bc, m/2] f32:

    * full: the matrix-form chain's power (`fullchain.fused_chain_power_reference`);
    * combine: sum_j (Yr + Yi)[row, j] of the half-spectrum range DFT Y;
    * dots: row s M + t holds sum_j (Re + Im)(g_s + g_{s+S})[t, j], g_p =
      A_p x_p the branch contractions, without the combine."""
    slab = x_all[offset:offset + bc]
    if mode == "full":
        return fullchain.fused_chain_power_reference(slab, plan, salt)
    x = slab.to(torch.float32) + float(salt)
    if mode == "combine":
        yr, yi = fullchain._contract_reference(x, plan)
        return yr.sum(-1) + yi.sum(-1)
    if mode != "dots":
        raise ValueError(f"unknown ablation mode {mode!r}")
    R, S = plan.radix, plan.radix // 2
    xr, xi = x[:, 0], x[:, 1]
    ar, ai = plan.a[:, 0], plan.a[:, 1]
    blocks = [0.0] * S
    for p in range(R):
        vr, vi = xr[:, p::R, :], xi[:, p::R, :]
        gr = ar[p] @ vr - ai[p] @ vi
        gi = ar[p] @ vi + ai[p] @ vr
        blocks[p % S] = blocks[p % S] + gr.sum(-1) + gi.sum(-1)
    return torch.cat(blocks, dim=-1)


def radix_chain_ablation(x_all: torch.Tensor, plan, mode: str, offset: int,
                         bc: int, salt: int) -> torch.Tensor:
    """One mode of the TPU algorithm's matrix-form salted radix chain on
    `bc` channel-sectors of the staged x_all [BC, 2, m, n] int16 (natural
    row order) from channel-sector `offset`, with the int32 `salt` added to
    every sample -> [bc, m/2] f32 (see `radix_chain_ablation_reference`):
    "full" the whole chain, "dots" and "combine" with work removed, each
    launched from csrc/kernel_breakdown.cu at the full body's grid and
    shared memory.  "splits" (the TPU tool's bf16 hi/lo split) raises: the
    port's chain has no split.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    global BREAKDOWN_LAUNCHES
    name = f"radix_chain_ablation ({mode})"
    if mode == "splits":
        raise ValueError(SPLITS_REFUSAL)
    if mode not in ABLATION_MODES:
        raise ValueError(f"unknown ablation mode {mode!r}; modes "
                         f"{', '.join(ABLATION_MODES)}")
    if plan.radix < 2:
        raise ValueError(f"{name} needs the radix plan (m={plan.m} splits "
                         "into no radix branches)")
    start, count = fullchain._slab(x_all.shape[0], offset, bc, salt, name, "bc")
    if x_all.device.type == "cpu":
        return radix_chain_ablation_reference(x_all, plan, mode, start, count,
                                              salt)
    _check_cuda(x_all, name)
    if x_all.dtype != torch.int16:
        raise TypeError(f"{name}: the ablations are built for int16 input, "
                        f"got {x_all.dtype}")
    fullchain._check_planar(x_all, plan, name)
    out = torch.empty((count, plan.m // 2), dtype=torch.float32,
                      device=x_all.device)
    if count == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x_all.device):
        rc = lib.wrp_radix_chain_ablation(
            x_all.data_ptr(), plan.a_kernel.data_ptr(), plan.fac_t.data_ptr(),
            plan.wd.data_ptr(), plan.phasors.data_ptr(), out.data_ptr(), count,
            plan.m, plan.n, plan.radix, fullchain.kernel_tile(plan), start,
            int(salt), _BODY[mode], _stream(x_all))
    fullchain._raise_on_error(lib, rc, name)
    BREAKDOWN_LAUNCHES += 1
    return out


def fused_smem_bytes(plan) -> int:
    """The matrix-form fused kernel's dynamic shared memory per block: Y
    [2, S T, n] and the operator slice [M, T, 2] in f32 (136 KB at
    1024 x 512)."""
    S, M, T = plan.radix // 2, plan.m // plan.radix, fullchain.kernel_tile(plan)
    return (2 * S * T * plan.n + 2 * T * M) * 4


def radix_chain_astage_reference(x: torch.Tensor, plan) -> torch.Tensor:
    """Plain torch version of `radix_chain_astage`: the matrix form's
    contraction and combine, Y [bc, 2, m/2, w] f32."""
    yr, yi = fullchain._contract_reference(x, plan)
    return torch.stack([yr, yi], dim=1)


def radix_chain_astage(x: torch.Tensor, plan, min_smem: int = 0) -> torch.Tensor:
    """The matrix-form A-stage (csrc/kernel_breakdown.cu, Body::kAStage of
    csrc/radix_chain.cuh) on x [bc, 2, m, w] int16 -> Y [bc, 2, m/2, w] f32,
    with at least `min_smem` bytes of dynamic shared memory requested per
    block, which it does not use: at `fused_smem_bytes(plan)` it runs at
    the full matrix body's occupancy, the breakdown's test of whether
    shared memory sets that body's pace.  A CPU tensor takes the plain
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
    of the matrix-form int16 body `body` at the plan's geometry: a mode
    ("full", "dots", "combine": salted) or "astage" (the A-stage on all n
    pulses), at least `min_smem` bytes of dynamic shared memory.  Needs
    CUDA."""
    if body not in _BODY:
        raise ValueError(f"unknown body {body!r}")
    tile = (fullchain.astage_tile(plan) if body == "astage"
            else fullchain.kernel_tile(plan))
    lib = _build.load_library()
    blocks = ctypes.c_int(0)
    rc = lib.wrp_radix_chain_ablation_blocks_per_sm(
        _BODY[body], plan.radix, tile, plan.m, plan.n, int(min_smem),
        ctypes.addressof(blocks))
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
