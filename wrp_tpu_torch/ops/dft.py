"""Cooley-Tukey split DFT operators for the `radix` method, in plain torch.

Counterpart of ``wrp_tpu/ops/dft.py`` (XLA einsums there, no Pallas, so
plain torch here).  Each DFT of length N = N1 N2 (N1 = 128) is one
Cooley-Tukey split,

  X[k1 + N1 k2] = sum_{i2} [ w_N^{i2 k1} (sum_{i1} x[N2 i1 + i2]
                  w_{N1}^{i1 k1}) ] w_{N2}^{i2 k2},

i.e. reshape -> inner 128-point DFT (a batched matmul) -> twiddle
(elementwise) -> outer N2-point DFT (a small matmul) -> index reshuffle,
~3.8x fewer multiply-adds than the dense operators of the `mxu` method.
The range transform keeps only k < m/2 (the stage-04 crop), halving the
outer stage.

Planar (real, imag) float32 pairs throughout, every contraction in full
fp32 (pipeline.py turns TF32 off).  The plans hold numpy arrays (held equal
to ``wrp_tpu``'s by the tests); `RadixStageOperators.to` makes the tensors
a processor keeps on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import RadarConfig
from ..constants import hamming_factors


def _dft(n: int, sign: float = -1.0) -> np.ndarray:
    j = np.arange(n)
    return np.exp(sign * 2.0j * np.pi * np.outer(j, j) / n)


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    """Precomputed factors for one split DFT of length N = n1 * n2.

    sign=-1 is the forward DFT; sign=+1 the conjugated (unnormalised
    inverse) transform of the Doppler stage's combined conj operator.
    half=True keeps only outer outputs k2 < n2/2 (the range-spectrum crop).
    The factor fields are numpy arrays, or tensors after `to`."""

    n: int
    n1: int
    n2: int
    f1r: np.ndarray   # [n1, n1] inner DFT
    f1i: np.ndarray
    f2r: np.ndarray   # [n2_keep, n2] outer DFT
    f2i: np.ndarray
    twr: np.ndarray   # [n1, n2] twiddles
    twi: np.ndarray

    @classmethod
    def build(cls, n: int, n1: int = 128, sign: float = -1.0,
              half: bool = False) -> "RadixPlan":
        if n % n1 or n // n1 < 2:
            raise ValueError(f"cannot split {n} with radix {n1}")
        n2 = n // n1
        if half and n2 % 2:
            raise ValueError(f"half-crop needs even n2, got {n2}")
        f1 = _dft(n1, sign)
        f2 = _dft(n2, sign)[: n2 // 2 if half else n2]
        k1 = np.arange(n1)[:, None]
        i2 = np.arange(n2)[None, :]
        tw = np.exp(sign * 2.0j * np.pi * (k1 * i2) / n)
        return cls(
            n=n, n1=n1, n2=n2,
            f1r=f1.real.astype(np.float32), f1i=f1.imag.astype(np.float32),
            f2r=f2.real.astype(np.float32), f2i=f2.imag.astype(np.float32),
            twr=tw.real.astype(np.float32), twi=tw.imag.astype(np.float32),
        )

    def to(self, device) -> "RadixPlan":
        """The plan with its factors as float32 tensors on `device`."""
        return dataclasses.replace(self, **{
            f: torch.as_tensor(np.asarray(getattr(self, f)), device=device)
            for f in ("f1r", "f1i", "f2r", "f2i", "twr", "twi")})


def _t(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def _cdot(ar, ai, br, bi, contract: str):
    """Complex contraction as four real fp32 einsums."""
    return (torch.einsum(contract, ar, br) - torch.einsum(contract, ai, bi),
            torch.einsum(contract, ar, bi) + torch.einsum(contract, ai, br))


def radix_dft_rows(xr, xi, plan: RadixPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFT along axis -2 (the range axis of [..., m, n]).

    Input [..., n1*n2, cols]; output [..., keep*n1, cols] where row
    k = k1 + n1*k2."""
    *lead, m, cols = xr.shape
    assert m == plan.n, (m, plan.n)
    # i = n2*i1 + i2 -> [..., i1, i2, cols]
    xr = xr.reshape(*lead, plan.n1, plan.n2, cols)
    xi = xi.reshape(*lead, plan.n1, plan.n2, cols)
    # inner DFT over i1: [n1, n1] @ [..., n1, n2*cols]
    tr, ti = _cdot(_t(plan.f1r, xr), _t(plan.f1i, xr), xr, xi,
                   "ab,...bcd->...acd")
    twr = _t(plan.twr, xr)[:, :, None]
    twi = _t(plan.twi, xr)[:, :, None]
    ur = tr * twr - ti * twi
    ui = tr * twi + ti * twr
    # outer DFT over i2: out[..., k1, k2, cols]
    vr, vi = _cdot(ur, ui, _t(plan.f2r, xr).T, _t(plan.f2i, xr).T,
                   "...acd,ce->...aed")
    # k = k1 + n1*k2: order rows as (k2, k1)
    keep = plan.f2r.shape[0]
    vr = torch.swapaxes(vr, -3, -2).reshape(*lead, keep * plan.n1, cols)
    vi = torch.swapaxes(vi, -3, -2).reshape(*lead, keep * plan.n1, cols)
    return vr, vi


def radix_dft_cols(xr, xi, plan: RadixPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFT along axis -1 (the pulse axis of [..., rows, n])."""
    *lead, rows, n = xr.shape
    assert n == plan.n, (n, plan.n)
    # j = n2*j1 + j2 -> [..., rows, j1, j2]
    xr = xr.reshape(*lead, rows, plan.n1, plan.n2)
    xi = xi.reshape(*lead, rows, plan.n1, plan.n2)
    # inner DFT over j1 (right-multiply by F1^T = F1, symmetric)
    tr, ti = _cdot(xr, xi, _t(plan.f1r, xr), _t(plan.f1i, xr),
                   "...rbc,bk->...rkc")
    twr = _t(plan.twr, xr)
    twi = _t(plan.twi, xr)
    ur = tr * twr - ti * twi
    ui = tr * twi + ti * twr
    # outer DFT over j2
    vr, vi = _cdot(ur, ui, _t(plan.f2r, xr).T, _t(plan.f2i, xr).T,
                   "...rkc,ce->...rke")
    keep = plan.f2r.shape[0]
    # k = k1 + n1*k2 -> order cols as (k2, k1)
    vr = torch.swapaxes(vr, -2, -1).reshape(*lead, rows, keep * plan.n1)
    vi = torch.swapaxes(vi, -2, -1).reshape(*lead, rows, keep * plan.n1)
    return vr, vi


@dataclasses.dataclass(frozen=True)
class RadixStageOperators:
    """Constants for the radix formulation of stages 01-04."""

    range_plan: RadixPlan       # length-m forward DFT, half-cropped
    doppler_plan: RadixPlan     # length-n conjugated DFT (stage 03's
                                # combined conj fold, constants.py)
    w_range: np.ndarray         # [m] window * c (applied before the range DFT)
    w_doppler: np.ndarray       # [n] window (applied before the Doppler DFT)

    @classmethod
    def build(cls, cfg: RadarConfig, radix: int = 128) -> "RadixStageOperators":
        wr, wd, c = hamming_factors(cfg)
        return cls(
            range_plan=RadixPlan.build(cfg.num_range_cells, radix,
                                       sign=-1.0, half=True),
            # stage 03's double conjugation folds to x @ conj(F_n), the
            # sign=+1 transform
            doppler_plan=RadixPlan.build(cfg.num_pulses, radix, sign=+1.0),
            w_range=(wr * c).astype(np.float32),
            w_doppler=wd.astype(np.float32),
        )

    @staticmethod
    def supports(cfg: RadarConfig, radix: int = 128) -> bool:
        m, n = cfg.num_range_cells, cfg.num_pulses
        return (m % radix == 0 and m // radix >= 2 and (m // radix) % 2 == 0
                and n % radix == 0 and n // radix >= 2)

    def to(self, device) -> "RadixStageOperators":
        """The operators as tensors on `device`."""
        return dataclasses.replace(
            self, range_plan=self.range_plan.to(device),
            doppler_plan=self.doppler_plan.to(device),
            w_range=torch.as_tensor(np.asarray(self.w_range), device=device),
            w_doppler=torch.as_tensor(np.asarray(self.w_doppler), device=device))


def stage01_04_radix(xr, xi, ops: RadixStageOperators) -> torch.Tensor:
    """Planar IQ [..., m, n] -> power [..., m/2, n] through the split DFTs;
    the same math as pipeline.stage01_04_mxu_planar, with factored
    operators."""
    n = ops.doppler_plan.n
    # stage 01 window, range part (w_doppler applied before the Doppler DFT)
    wr = _t(ops.w_range, xr)[:, None]
    xr = xr * wr
    xi = xi * wr
    # stage 02: forward range DFT, the half-spectrum crop in the plan
    yr, yi = radix_dft_rows(xr, xi, ops.range_plan)
    # stage 03a: Doppler window and mean subtraction over pulses (the conj
    # is folded into the sign=+1 Doppler plan, constants.py)
    wd = _t(ops.w_doppler, xr)
    yr = yr * wd
    yi = yi * wd
    yr = yr - yr.mean(dim=-1, keepdim=True)
    yi = yi - yi.mean(dim=-1, keepdim=True)
    # stage 03b: conjugated Doppler DFT
    zr, zi = radix_dft_cols(yr, yi, ops.doppler_plan)
    # stage 03c: fftshift and clip the two highest post-shift bins
    zr = torch.roll(zr, n // 2, dims=-1)
    zi = torch.roll(zi, n // 2, dims=-1)
    zr = torch.cat([zr[..., : n - 2], torch.zeros_like(zr[..., :2])], dim=-1)
    zi = torch.cat([zi[..., : n - 2], torch.zeros_like(zi[..., :2])], dim=-1)
    # stage 04
    return zr * zr + zi * zi
