"""The device wire-decode formulations on the card, A against B, beside the
wire-fused kernel at the same batch.  Counterpart of ``tools/decode_ab.py``.

Each variant maps raw wire bytes uint8 [B, m*n*ch*4] (interleaved
big-endian int16 hhI hhQ vvI vvQ vhI vhQ per sample) to planar int16
[B, ch, 2, m, n] in torch, and is pinned bit-exact to the host codec
(io/codec.decode_iq_i16) before it is timed:

  v0_current        ops/device_codec.decode_wire_i16 as shipped: compose
                    every int16 in int32, then one permute to planes
  v1_byteslice      a strided byte slice per plane (its high and low bytes),
                    the compose fused into each plane, then one stack
  v2_bitcast_slice  the bytes viewed as little-endian int16 once, then a
                    strided lane slice per plane with a byte swap
  v3_flat           compose, then one [S, 2 ch] -> [2 ch, S] transpose

  k_wire            the wire kernel (#7, csrc/fused_chain_wire.cu) on the
                    same bytes viewed as int32 words: the decode inside the
                    chain, for scale

Every step XOR-salts the bytes with the step index (so no two steps decode
the same data; the salt's own pass is timed alone as `salt_only`) and a
reduction of each step's output feeds the result.  ``wrp_tpu``'s radix row
take has no counterpart (the port keeps rows in natural order).  A parity
miss prints {"error": ...} and exits 1; any exception ends the run with a
traceback and a non-zero exit.

    python -m wrp_tpu_torch.tools.decode_ab [--batch 32] [--steps 16]
    python -m wrp_tpu_torch.tools.decode_ab --smoke --device cpu   # plumbing
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, tiny_config
from ..constants import PipelineConstants
from ..io import codec
from ..ops import device_codec, fullchain
from ._common import best_of, device_of


def _signed(v: torch.Tensor) -> torch.Tensor:
    """int32 0..65535 -> its int16 value."""
    return (v - ((v >> 15) << 16)).to(torch.int16)


def variants(cfg) -> dict:
    """{name: fn(wire uint8 [B, nbytes]) -> int16 [B, ch, 2, m, n]}."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    lanes = 2 * ch

    def v0_current(w):
        return device_codec.decode_wire_i16(w, cfg)

    def v1_byteslice(w):
        b = w.reshape(-1, m, n, lanes, 2)
        planes = [_signed((b[..., k, 0].to(torch.int32) << 8)
                          | b[..., k, 1].to(torch.int32))
                  for k in range(lanes)]
        return torch.stack(planes, dim=1).reshape(-1, ch, 2, m, n)

    def v2_bitcast_slice(w):
        le = w.reshape(-1, m, n * lanes * 2).view(torch.int16)  # [B, m, n*lanes]
        planes = []
        for k in range(lanes):
            v = le[..., k::lanes].to(torch.int32) & 0xFFFF
            planes.append(_signed(((v & 0xFF) << 8) | (v >> 8)))
        return torch.stack(planes, dim=1).reshape(-1, ch, 2, m, n)

    def v3_flat(w):
        b = w.reshape(-1, m * n, lanes, 2).to(torch.int32)
        v = _signed((b[..., 0] << 8) | b[..., 1])              # [B, S, lanes]
        return v.transpose(1, 2).contiguous().reshape(-1, ch, 2, m, n)

    return {"v0_current": v0_current, "v1_byteslice": v1_byteslice,
            "v2_bitcast_slice": v2_bitcast_slice, "v3_flat": v3_flat}


def run(cfg=DEFAULT_CONFIG, batch: int = 32, steps: int = 16, reps: int = 5,
        device="cuda") -> dict:
    """The result line: each variant's us per sector, effective GB/s (bytes
    read and written) and span times; or {"error": ...} on a parity miss."""
    dev = torch.device(device)
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    nbytes = cfg.sector_nbytes_wire
    B = batch
    rng = np.random.default_rng(7)
    wire_host = rng.integers(0, 256, size=(B, nbytes), dtype=np.uint8)
    wire = torch.from_numpy(wire_host).to(dev)
    want = torch.from_numpy(np.stack([
        codec.decode_iq_i16(wire_host[i].tobytes(), cfg) for i in range(B)]))
    out = {"batch": B, "steps": steps, "geometry": f"{ch}x{m}x{n}",
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else str(dev))}

    fns = variants(cfg)
    bad = [name for name, fn in fns.items()
           if not torch.equal(fn(wire).cpu(), want)]
    if bad:
        out["error"] = f"parity failed: {bad} differ from the host codec"
        return out
    out["parity"] = "bit-exact vs io/codec.decode_iq_i16"

    plan = fullchain.build_plan(PipelineConstants.build(cfg), dev)

    def k_wire(w):
        return fullchain.fused_chain_power_wire(
            device_codec.wire_words_i32(w, cfg), plan, ch)

    timed = {"salt_only": lambda w: w, **fns, "k_wire": k_wire}
    for name, fn in timed.items():
        def span():
            acc = torch.zeros((), dtype=torch.float64, device=dev)
            for i in range(steps):
                d = fn(wire ^ (i & 0xFF))
                acc = acc + d.reshape(B, -1)[:, 0].double().sum()
            return acc

        best, runs = best_of(span, dev, reps)
        dt = best / steps
        out[name] = {"us_per_sector": round(dt / B * 1e6, 2),
                     "eff_gbps": round(2 * B * nbytes / dt / 1e9, 1),
                     "runs_s": [round(r, 6) for r in runs]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="decode_ab")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits 2 without CUDA) or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry, batch 2, 2 steps: every variant's "
                         "parity pin and the JSON contract; the times mean "
                         "nothing")
    args = ap.parse_args(argv)
    dev = device_of(ap, args.device)
    cfg = DEFAULT_CONFIG
    if args.smoke:
        cfg = tiny_config(m=64, n=32)
        args.batch, args.steps, args.reps = 2, 2, 1
    out = run(cfg, args.batch, args.steps, args.reps, dev)
    print(json.dumps(out), flush=True)
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main())
