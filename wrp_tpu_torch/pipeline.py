"""The 11-stage polarimetric radar chain in PyTorch.

Counterpart of ``wrp_tpu/pipeline.py``.  Methods of `SectorProcessor`:

* ``"fft"``      — the literal chain: window, torch.fft range FFT, Doppler
  processing, power, matched filter (stage-parity path, `all_stages`).
* ``"mxu"``      — stages 01-04 as two constant complex matmuls
  A_half @ X @ B (constants.stage1_operators), then the matched filter.
* ``"parseval"`` — the A matmul in Gauss 3-multiply form plus the
  closed-form Parseval stages 03b-08 (`stage_b_parseval`).
* ``"pallas"``   — the flagship: the whole of stages 01-08 in one
  hand-written CUDA kernel (ops/fullchain.py: csrc/fused_chain_radix.cu,
  or csrc/fused_chain_dense.cu when m does not split into radix branches).
  The name is kept from ``wrp_tpu`` so flags and tests carry over.  With
  ``wire_input=True`` it takes raw wire bytes and decodes them on the
  device (`stream --device-decode`).
* ``"radix"``    — the `mxu` chain with Cooley-Tukey split DFTs as torch
  einsums (ops/dft.py, ~3.8x fewer multiply-adds); falls back to "mxu"
  (and `proc.method` says so) for a geometry that does not split.

Numerics policy, stated once here: float32 throughout, and every fp32
matmul and convolution runs in full fp32 — never TF32 — as the JAX
reference runs Precision.HIGHEST off the TPU.  Products are zdb with bin 0
= -inf (zero range gain) and zdr as the log of the hh/vv power ratio.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .config import RadarConfig, DEFAULT_CONFIG
from .constants import PipelineConstants

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

METHODS = ("mxu", "parseval", "pallas", "fft", "radix")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request on a host without CUDA
    raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run the plain torch versions")
    return dev


# --------------------------------------------------------------------------
# Stage ops (method="fft").  All take [..., m, n] and broadcast.
# --------------------------------------------------------------------------


def stage01_window(iq: torch.Tensor, hamming: torch.Tensor) -> torch.Tensor:
    return iq * hamming


def stage02_range_fft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x, dim=-2)


def stage03_doppler(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    y = torch.conj_physical(x - x.mean(dim=-1, keepdim=True))
    y = torch.fft.fft(y, dim=-1)
    y = torch.conj_physical(torch.roll(y, n // 2, dims=-1))
    y[..., n - 2:] = 0.0
    return y


def stage04_power(x: torch.Tensor) -> torch.Tensor:
    half = x[..., : x.shape[-2] // 2, :]
    return half.real ** 2 + half.imag ** 2


def matched_filter_direct(p: torch.Tensor, ma_taps) -> torch.Tensor:
    """Stages 05-07 as a circular convolution along the pulse axis:
    conv[j] = sum_k ma[k] * p[(j - k) mod n]."""
    taps = [float(t) for t in np.asarray(ma_taps)]
    out = taps[0] * p
    for k in range(1, len(taps)):
        out = out + taps[k] * torch.roll(p, k, dims=-1)
    return out


def matched_filter_spectral(p: torch.Tensor, fft_ma: torch.Tensor) -> torch.Tensor:
    """Stages 05-07 in the reference's spectral form (read.cc:272-327)."""
    spec = torch.fft.fft(p.to(fft_ma.dtype), dim=-1) * fft_ma
    return torch.fft.ifft(spec, dim=-1).real


def stage08_pulse_sum(conv: torch.Tensor) -> torch.Tensor:
    return conv.sum(dim=-1)


def log10(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) / float(np.log(10.0))


def stage09_10_products(pow_hh: torch.Tensor, pow_vv: torch.Tensor,
                        gain: torch.Tensor):
    """zdb = 10 log10(gain pow_hh) (bin 0: gain 0 -> -inf); zdr as the log
    of the power RATIO, better conditioned in fp32 than a difference of
    logs (vv = 0 -> +inf, hh = vv = 0 -> NaN)."""
    zdb = 10.0 * log10(gain * pow_hh)
    zdr = 10.0 * log10(pow_hh / pow_vv)
    return zdb, zdr


# --------------------------------------------------------------------------
# Matmul formulations (methods "mxu" and "parseval").
# --------------------------------------------------------------------------


def _rmatmul(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) as four real fp32 matmuls."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _rmatmul_gauss(ar, ai, asum, br, bi):
    """Gauss 3-multiply complex matmul; `asum = ar + ai` precomputed."""
    m1 = ar @ br
    m2 = ai @ bi
    m3 = asum @ (br + bi)
    return m1 - m2, m3 - m1 - m2


def stage_b_parseval(yr: torch.Tensor, yi: torch.Tensor, wd: torch.Tensor,
                     phasors: torch.Tensor) -> torch.Tensor:
    """Stages 03b-08 in closed form (constants.parseval_vectors):

        pow[i] = n * sum_j |q_ij - qbar_i|^2 - |q_i . f_k1|^2 - |q_i . f_k2|^2

    with q = y * w_d.  The mean is subtracted BEFORE the clip-bin
    projections (f_k is orthogonal to the ones vector, so this is exact)
    to avoid catastrophic cancellation when the DC/clutter line dominates."""
    n = yr.shape[-1]
    qr = yr * wd
    qi = yi * wd
    qr = qr - qr.mean(dim=-1, keepdim=True)
    qi = qi - qi.mean(dim=-1, keepdim=True)
    s = n * (qr * qr + qi * qi).sum(dim=-1)
    dr = qr @ phasors.T             # [..., 4]
    di = qi @ phasors.T
    for c, sn in ((0, 1), (2, 3)):
        re = dr[..., c] - di[..., sn]
        im = dr[..., sn] + di[..., c]
        s = s - (re * re + im * im)
    return s


def stage01_04_mxu_planar(xr, xi, op_a: tuple, op_b: tuple) -> torch.Tensor:
    """Planar IQ [..., m, n] -> power [..., m/2, n] via A_half @ X @ B."""
    yr, yi = _rmatmul(*op_a, xr, xi)
    zr, zi = _rmatmul(yr, yi, *op_b)
    return zr * zr + zi * zi


# --------------------------------------------------------------------------
# Full chain.
# --------------------------------------------------------------------------


class _DeviceConstants:
    """PipelineConstants as tensors on one device."""

    def __init__(self, consts: PipelineConstants, device: torch.device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.hamming = put(consts.hamming)
        self.ma_taps = np.asarray(consts.ma_taps)
        self.fft_ma = put(consts.fft_ma)
        self.gain = put(consts.gain)
        self.ar = put(consts.op_a_half.real)
        self.ai = put(consts.op_a_half.imag)
        self.asum = put(consts.op_a_half.real + consts.op_a_half.imag)
        self.br = put(consts.op_b.real)
        self.bi = put(consts.op_b.imag)
        self.wd = put(consts.wd)
        self.phasors = put(consts.clip_phasors)
        #: ops/dft.RadixStageOperators on the device (method "radix")
        self.radix_ops = None


def channel_power_planar(xr: torch.Tensor, xi: torch.Tensor,
                         dc: _DeviceConstants, method: str = "mxu",
                         matched_filter: str = "direct") -> torch.Tensor:
    """Stages 01-08 on planar f32 IQ: (real, imag) [..., m, n] -> pow [..., m/2]."""
    if method == "parseval":
        yr, yi = _rmatmul_gauss(dc.ar, dc.ai, dc.asum, xr, xi)
        return stage_b_parseval(yr, yi, dc.wd, dc.phasors)
    if method == "mxu":
        p = stage01_04_mxu_planar(xr, xi, (dc.ar, dc.ai), (dc.br, dc.bi))
    elif method == "radix":
        from .ops.dft import stage01_04_radix

        p = stage01_04_radix(xr, xi, dc.radix_ops)
    elif method == "fft":
        x = stage01_window(torch.complex(xr, xi), dc.hamming)
        p = stage04_power(stage03_doppler(stage02_range_fft(x)))
    else:
        raise ValueError(f"unknown method {method!r}")
    if matched_filter == "direct":
        return stage08_pulse_sum(matched_filter_direct(p, dc.ma_taps))
    if matched_filter == "fold":
        # a circular convolution preserves row sums: sum_j (p (*) ma)[j]
        # = sum_j p[j] * sum_k ma[k]
        return stage08_pulse_sum(p) * float(np.sum(dc.ma_taps))
    if matched_filter == "spectral":
        return stage08_pulse_sum(matched_filter_spectral(p, dc.fft_ma))
    raise ValueError(f"unknown matched_filter {matched_filter!r}")


def all_stages(iq: torch.Tensor, consts: PipelineConstants,
               matched_filter: str = "direct") -> Dict[str, torch.Tensor]:
    """Every stage boundary of the fft path on complex IQ [C, m, n], keyed
    like the reference's golden files."""
    dc = _DeviceConstants(consts, iq.device)
    out = {"00iq": iq}
    out["01hamm"] = stage01_window(iq, dc.hamming)
    out["02fft1"] = stage02_range_fft(out["01hamm"])
    out["03fft2"] = stage03_doppler(out["02fft1"])
    out["04abs"] = stage04_power(out["03fft2"])
    if matched_filter == "direct":
        out["07conv"] = matched_filter_direct(out["04abs"], dc.ma_taps)
    else:
        out["07conv"] = matched_filter_spectral(out["04abs"], dc.fft_ma)
    out["08pow"] = stage08_pulse_sum(out["07conv"])
    out["09zdb"], out["10zdr"] = stage09_10_products(
        out["08pow"][..., 0, :], out["08pow"][..., 1, :], dc.gain)
    return out


def to_planar(iq) -> torch.Tensor:
    """Complex [..., m, n] (numpy or torch) -> planar f32 [..., 2, m, n]."""
    t = torch.as_tensor(iq)
    return torch.stack([t.real.to(torch.float32), t.imag.to(torch.float32)],
                       dim=-3)


class SectorProcessor:
    """Batch processor bound to one config, method and device.

    Accepts complex IQ [B, C, m, n], planar float32 or int16 IQ
    [B, C, 2, m, n] (the codec's layout), or one unbatched sector
    [C, 2, m, n] / [C, m, n]; numpy arrays or tensors.  Returns (zdb, zdr)
    as float32 tensors [B, m/2] (or [m/2]) on the processor's device, with
    the device work enqueued, not waited for.

    device defaults to "cuda" and never silently becomes the CPU: without
    CUDA the constructor raises.  Pass device="cpu" to run the plain torch
    versions (the fused method's kernel then takes its plain version).

    With wire_input=True (method "pallas" only) it takes raw wire bytes
    instead: uint8 [B, nbytes] or [nbytes] (nbytes = cfg.sector_nbytes_wire),
    or, with wire_decode="fused", the same bytes viewed as int32 words
    [B, nbytes/4] (`wire_dtype` names the form the processor prefers), and
    decodes them on its device.

    Usage::

        proc = SectorProcessor(cfg, method="pallas")
        zdb, zdr = proc(iq_batch)
    """

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG, method: str = "mxu",
                 matched_filter: str = "direct", device="cuda",
                 consts: PipelineConstants | None = None,
                 wire_input: bool = False, wire_decode: str | None = None):
        """consts: the chain's constants (default: built from cfg) — e.g.
        PipelineConstants.from_numpy of the JAX package's.

        wire_decode (with wire_input): "fused" decodes inside the wire
        kernel (csrc/fused_chain_wire.cu: the channel deinterleave never
        happens; needs m that splits into radix branches); "xla" is a
        standalone decode pass (ops/device_codec.decode_wire_i16) feeding
        the planar kernel (the name is kept from ``wrp_tpu``).  None picks
        "fused" when radix_for(m) > 1, else "xla".  Rows stay in natural
        order, so ``wrp_tpu``'s `layout` and `wire_order` have no
        counterpart."""
        if matched_filter not in ("direct", "fold", "spectral"):
            raise ValueError(
                f"unknown matched_filter {matched_filter!r}: use "
                "'direct', 'fold', or 'spectral'")
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}: use one of {METHODS}")
        if method == "radix" and matched_filter == "spectral":
            raise ValueError(
                "method='radix' implements 'direct' and 'fold' matched "
                "filters; use method='mxu' or 'fft' for the spectral "
                "parity path")
        if method == "pallas" and matched_filter != "direct":
            raise ValueError(
                "method='pallas' fuses the whole chain; its output is "
                "exactly the direct/fold matched-filter result and the "
                "spectral variant does not exist there — pass "
                "matched_filter='direct' (the default)")
        if wire_input and method != "pallas":
            raise ValueError("wire_input (on-device decode of raw wire "
                             "bytes) requires method='pallas'")
        if wire_decode is not None and not wire_input:
            raise ValueError("wire_decode applies with wire_input=True")
        if wire_decode not in (None, "fused", "xla"):
            raise ValueError(f"unknown wire_decode {wire_decode!r}: use "
                             "'fused' or 'xla'")
        self.cfg = cfg
        self.method = method
        self.matched_filter = matched_filter
        self.device = resolve_device(device)
        self.wire_input = wire_input
        #: the wire form the processor prefers: int32 words for the fused
        #: decode (the host views its bytes as '<i4', free), else uint8
        self.wire_dtype = np.uint8
        self.wire_decode = None
        consts = consts if consts is not None else PipelineConstants.build(cfg)
        self._dc = _DeviceConstants(consts, self.device)
        if method == "radix":
            from .ops.dft import RadixStageOperators

            if RadixStageOperators.supports(cfg):
                self._dc.radix_ops = RadixStageOperators.build(cfg).to(
                    self.device)
            else:
                self.method = "mxu"     # geometry too small to split
        if method == "pallas":
            from .ops import fullchain

            if wire_input:
                fused_ok = fullchain.radix_for(cfg.m) > 1
                if wire_decode is None:
                    wire_decode = "fused" if fused_ok else "xla"
                elif wire_decode == "fused" and not fused_ok:
                    raise ValueError(
                        "wire_decode='fused' needs the radix kernel (an m "
                        f"that splits into radix branches); got m={cfg.m}")
                self.wire_decode = wire_decode
            if wire_decode == "fused":
                self.wire_dtype = np.int32
                self._wire_plan = fullchain.build_plan(consts, self.device)
            else:
                self._power_fn = fullchain.build_fused_processor(consts,
                                                                 self.device)

    def _planar(self, iq) -> torch.Tensor:
        if (torch.is_tensor(iq) and iq.is_complex()) or (
                isinstance(iq, np.ndarray) and np.iscomplexobj(iq)):
            iq = to_planar(iq)
        x = torch.as_tensor(iq)
        expect = (self.cfg.num_channels, 2, self.cfg.m, self.cfg.n)
        if x.dim() not in (4, 5) or tuple(x.shape[-4:]) != expect:
            raise ValueError(
                f"planar IQ must be [B, channels, 2, m, n] or [channels, 2, "
                f"m, n] with [channels, 2, m, n] = {expect}, got "
                f"{tuple(x.shape)}")
        if x.dtype not in (torch.int16, torch.float32):
            raise TypeError(f"planar IQ must be int16 or float32, got {x.dtype}")
        return x.to(self.device, non_blocking=True)

    def _power(self, x: torch.Tensor) -> torch.Tensor:
        """Batched planar IQ on the device -> power [B, C, m/2]."""
        if self.method == "pallas":
            return self._power_fn(x)
        xf = x.to(torch.float32)
        return channel_power_planar(xf[..., 0, :, :], xf[..., 1, :, :],
                                    self._dc, self.method, self.matched_filter)

    def _wire(self, wire) -> torch.Tensor:
        """Wire bytes (or, fused, int32 words) [B, ...] or [...] -> on the
        device, after the input contract of wrp_tpu's wire processor."""
        x = torch.as_tensor(wire)
        nb = self.cfg.sector_nbytes_wire
        ok = x.dim() in (1, 2) and (
            (x.dtype == torch.uint8 and x.shape[-1] == nb)
            or (x.dtype == torch.int32 and x.shape[-1] == nb // 4
                and self.wire_decode == "fused"))
        if not ok:
            raise ValueError(
                f"wire_input processor expects uint8 [..., {nb}] raw wire "
                "bytes (or, with wire_decode='fused', int32 "
                f"[..., {nb // 4}] LE-viewed words); got {x.dtype} "
                f"{tuple(x.shape)}")
        return x.to(self.device, non_blocking=True)

    def _wire_power(self, x: torch.Tensor) -> torch.Tensor:
        """Batched wire input on the device -> power [B, C, m/2]."""
        from .ops import device_codec, fullchain

        if self.wire_decode == "fused":
            w32 = device_codec.wire_words_i32(x, self.cfg).contiguous()
            return fullchain.fused_chain_power_wire(w32, self._wire_plan,
                                                    self.cfg.num_channels)
        return self._power_fn(device_codec.decode_wire_i16(x, self.cfg))

    def __call__(self, iq) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.wire_input:
            x = self._wire(iq)
            unbatched = x.dim() == 1
            pw = self._wire_power(x[None] if unbatched else x)
        else:
            x = self._planar(iq)
            unbatched = x.dim() == 4
            pw = self._power(x[None] if unbatched else x)
        zdb, zdr = stage09_10_products(pw[:, 0], pw[:, 1], self._dc.gain)
        if unbatched:
            return zdb[0], zdr[0]
        return zdb, zdr
