"""On-device wire decode: raw interleaved big-endian int16 wire bytes on the
device, in plain torch.

Counterpart of ``wrp_tpu/ops/device_codec.py`` (XLA ops there, not Pallas
kernels, so plain torch here).  With `stream --device-decode` the host only
reassembles datagrams and copies wire bytes; the device decodes them.  The
H2D traffic is unchanged: the wire IS int16, 4 bytes per channel-sample
either way.

Wire format (reference sector.cpp:52-62, read_single.cc:15): one sector =
m*n samples x (4 * channels) bytes, each sample interleaved big-endian
int16 ``hhI hhQ vvI vvQ vhI vhQ``.

Rows stay in natural order: the kernels read radix branch rows by index,
so ``wrp_tpu``'s `radix` row-reorder argument has no counterpart.
"""

from __future__ import annotations

import torch

from ..config import RadarConfig, DEFAULT_CONFIG


def decode_wire_i16(wire_u8, cfg: RadarConfig = DEFAULT_CONFIG,
                    num_pulses: int | None = None) -> torch.Tensor:
    """uint8 [..., m*n*ch*4] wire bytes -> int16 [..., ch, 2, m, n] on the
    same device, bit-exact with io/codec.decode_iq_i16.  The standalone
    decode pass of `wire_decode="xla"` (geometries without a radix split)
    and of the pulse-sharded wire input.

    num_pulses overrides cfg's pulse count: a pulse-sharded rank holds only
    its n/N pulse-byte columns of each wire row (the wire interleaves the
    channels per sample, so a column slice of a row is self-contained)."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if num_pulses is not None:
        n = num_pulses
    nbytes = m * n * cfg.bytes_per_sample
    w = torch.as_tensor(wire_u8)
    if w.dtype != torch.uint8 or w.dim() < 1 or w.shape[-1] != nbytes:
        raise ValueError(f"expected uint8 [..., {nbytes}] wire bytes; got "
                         f"{w.dtype} {tuple(w.shape)}")
    lead = tuple(w.shape[:-1])
    b = w.reshape(*lead, m, n, ch, 2, 2).to(torch.int32)
    v = (b[..., 0] << 8) | b[..., 1]               # 0..65535, big-endian
    v = v - ((v >> 15) << 16)                      # sign per int16
    k = len(lead)
    # [..., m, n, ch, 2] -> [..., ch, 2, m, n]
    perm = (*range(k), k + 2, k + 3, k, k + 1)
    return v.to(torch.int16).permute(perm).contiguous()


def wire_words_i32(wire, cfg: RadarConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Wire bytes -> int32 words [..., m, ch*n] for the wire-fused kernel
    (ops/fullchain.fused_chain_power_wire): word ch*j + c of row i is
    channel c / pulse j's 4 wire bytes read little-endian (I big-endian in
    the low 16 bits, Q in the high 16).

    Accepts uint8 [..., m*n*ch*4] bytes (a bitcast view, no copy) or int32
    [..., m*n*ch] words (the host views its staging buffer as '<i4'); any
    other dtype or size raises ValueError."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    words = m * n * ch
    w = torch.as_tensor(wire)
    lead = tuple(w.shape[:-1])
    if w.dtype == torch.uint8:
        if w.dim() < 1 or w.shape[-1] != words * 4:
            raise ValueError(f"expected uint8 [..., {words * 4}] wire "
                             f"bytes; got {tuple(w.shape)}")
        w32 = w.contiguous().view(torch.int32)
    elif w.dtype == torch.int32:
        if w.dim() < 1 or w.shape[-1] != words:
            raise ValueError(f"expected int32 [..., {words}] wire words; "
                             f"got {tuple(w.shape)}")
        w32 = w
    else:
        raise ValueError(f"wire must be uint8 bytes or int32 words; got "
                         f"{w.dtype}")
    return w32.reshape(*lead, m, n * ch)
