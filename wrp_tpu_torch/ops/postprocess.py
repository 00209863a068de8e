"""The pulse-domain tail of the chain (stages 03b-08) as a hand-written CUDA
kernel.

Counterpart of ``wrp_tpu/ops/pallas/postprocess.py``: `fused_stage2` maps
the range-transformed rows Y [BC, rows, n] (planar f32) to the matched-filter
power [BC, rows] through the Doppler product Z = Y @ B, |Z|^2, the 7-tap
circular matched filter and the pulse sum.  The kernel is
csrc/fused_stage2.cu: the product on the TF32 tensor cores with each fp32
operand split into TF32 hi + lo (3 x TF32, the TPU kernel's bf16 x 3 in
TF32), one GEMM launch a call (`STAGE2_LAUNCHES`) after one launch that
writes the operator's real form (`STAGE2_OPERATOR_LAUNCHES`).  Its plain version, `fused_stage2_reference`,
is the literal chain in fp32 (four real matmuls, |Z|^2,
`pipeline.matched_filter_direct`, `pipeline.stage08_pulse_sum`), so the
kernel's folded filter (a circular filter keeps row sums: the filter and
the sum become one factor, the taps' sum) and its split are held against
the literal one.  `tf32x3_power_reference` emulates the kernel's split
arithmetic in torch (`tf32_round`, `split_tf32`), so the precision it gives
is checked before it reaches the card.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import _rmatmul, matched_filter_direct, stage08_pulse_sum
from . import _build
from .fullchain import _raise_on_error

#: kernel launches, counted where the wrapper launches csrc/fused_stage2.cu:
#: each call launches the real operator's kernel, then the GEMM
STAGE2_LAUNCHES = 0             # fused_stage2_kernel, the GEMM
STAGE2_OPERATOR_LAUNCHES = 0    # real_operator_kernel, B's real form

#: csrc/fused_stage2.cu's column and depth tiles (kBN, kBK), which size the
#: real operator's scratch
_STAGE2_BN, _STAGE2_BK = 128, 32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits, 11
    significant), ties away from zero: the kernel's cvt.rna.tf32.f32 on
    finite values, as bit arithmetic on the fp32 word."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> its top 19 bits, the TF32 value a tensor core reads from an
    fp32 word (the low 13 mantissa bits cleared)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor, truncate: bool = False):
    """(hi, lo) TF32 values with x ~ hi + lo: hi = tf32_round(x) (the
    kernel's split of Y), or tf32_truncate(x) with `truncate` (its split of
    B, whose fp32 words the tensor cores read as they are); lo =
    tf32_round(x - hi), x - hi being exact in fp32.  For normal x,
    |x - hi - lo| <= 2^-22 |x| rounded, 2^-21 |x| truncated."""
    hi = tf32_truncate(x) if truncate else tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_power_reference(yr: torch.Tensor, yi: torch.Tensor,
                           op_br: torch.Tensor, op_bi: torch.Tensor,
                           taps) -> torch.Tensor:
    """The kernel's arithmetic in torch: the real form [Yr | Yi] @ [[Br,
    Bi], [-Bi, Br]], each operand split as the kernel splits it
    (`split_tf32`: Y rounded, B truncated), Z = hi hi + hi lo + lo hi as
    three fp32 matmuls of TF32 values (exact products, fp32 sums), then
    sum(taps) sum_j |Z|^2 -> pow [BC, rows].  Its sums run in
    another order than the tensor cores', so it documents the split's
    precision, not the kernel's bits."""
    a = torch.cat([yr, yi], dim=-1)
    b = torch.cat([torch.cat([op_br, op_bi], dim=1),
                   torch.cat([-op_bi, op_br], dim=1)], dim=0)
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b, truncate=True)
    z = (al @ bh + ah @ bl) + ah @ bh
    tap_sum = float(np.sum(np.asarray(taps, np.float64)))
    return tap_sum * (z * z).sum(dim=-1)


def fused_stage2_reference(yr: torch.Tensor, yi: torch.Tensor,
                           op_br: torch.Tensor, op_bi: torch.Tensor,
                           taps) -> torch.Tensor:
    """Plain torch version: Z = Y @ B as four real fp32 matmuls, |Z|^2, the
    circular matched filter, the pulse sum -> pow [BC, rows]."""
    zr, zi = _rmatmul(yr, yi, op_br, op_bi)
    return stage08_pulse_sum(matched_filter_direct(zr * zr + zi * zi, taps))


def _check(yr, yi, op_br, op_bi, row_block: int) -> None:
    for name, t in (("yr", yr), ("yi", yi), ("op_br", op_br), ("op_bi", op_bi)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_stage2: {name} must be float32, got {t.dtype}")
    if yr.dim() != 3 or yi.shape != yr.shape:
        raise ValueError(f"fused_stage2: yr and yi must be one [BC, rows, n] "
                         f"shape, got {tuple(yr.shape)} and {tuple(yi.shape)}")
    n = yr.shape[2]
    if op_br.shape != (n, n) or op_bi.shape != (n, n):
        raise ValueError(f"fused_stage2: op_br and op_bi must be [{n}, {n}], got "
                         f"{tuple(op_br.shape)} and {tuple(op_bi.shape)}")
    rows = yr.shape[1]
    if row_block <= 0 or rows % row_block:
        raise ValueError(f"fused_stage2: rows={rows} must divide by "
                         f"row_block={row_block}")
    devs = {t.device for t in (yr, yi, op_br, op_bi)}
    if len(devs) != 1:
        raise ValueError(f"fused_stage2: operands on several devices {devs}")


def fused_stage2(yr: torch.Tensor, yi: torch.Tensor, op_br: torch.Tensor,
                 op_bi: torch.Tensor, taps, row_block: int = 128) -> torch.Tensor:
    """Planar Y [BC, rows, n] f32 -> matched-filter power [BC, rows] f32.

    op_br, op_bi: the Doppler operator B [n, n] (``consts.op_b``); taps: the
    matched filter's taps (``consts.ma_taps``).  row_block is checked as
    ``wrp_tpu`` checks it (rows must divide by it, else ValueError); it was
    the TPU kernel's block of rows, and the result does not depend on it
    (the CUDA kernel's block is its own fixed tile).

    A CPU tensor takes the plain version.  A CUDA tensor launches
    csrc/fused_stage2.cu on the current stream (no synchronisation) or
    raises; it needs contiguous operands and n divisible by 4.  The
    kernel's real operator [[Br, Bi], [-Bi, Br]], transposed, goes to a
    scratch tensor allocated here (4 MB at n = 512), written by its own
    kernel on every call: two launches, each counted."""
    global STAGE2_LAUNCHES, STAGE2_OPERATOR_LAUNCHES
    _check(yr, yi, op_br, op_bi, row_block)
    if yr.device.type == "cpu":
        return fused_stage2_reference(yr, yi, op_br, op_bi, taps)
    if yr.device.type != "cuda":
        raise ValueError(f"fused_stage2: unsupported device {yr.device}")
    if not all(t.is_contiguous() for t in (yr, yi, op_br, op_bi)):
        raise ValueError("fused_stage2: operands must be contiguous")
    bc, rows, n = yr.shape
    if n % 4:
        raise ValueError(f"fused_stage2: the kernel reads float4s; n={n} must "
                         "divide by 4")
    out = torch.empty((bc, rows), dtype=torch.float32, device=yr.device)
    if out.numel() == 0:
        return out
    tap_sum = float(np.sum(np.asarray(taps, np.float64)))
    lib = _build.load_library()
    # B's real form, [2n columns][2 halves of K], each rounded up to a tile
    cols = -(-2 * n // _STAGE2_BN) * _STAGE2_BN
    depth = 2 * (-(-n // _STAGE2_BK) * _STAGE2_BK)
    scratch = torch.empty(cols * depth, dtype=torch.float32, device=yr.device)
    with torch.cuda.device(yr.device):
        stream = torch.cuda.current_stream(yr.device).cuda_stream
        rc = lib.wrp_fused_stage2(yr.data_ptr(), yi.data_ptr(), op_br.data_ptr(),
                                  op_bi.data_ptr(), scratch.data_ptr(),
                                  scratch.numel(), out.data_ptr(), bc * rows, n,
                                  tap_sum, stream)
    _raise_on_error(lib, rc, "fused_stage2")
    STAGE2_OPERATOR_LAUNCHES += 1
    STAGE2_LAUNCHES += 1
    return out
