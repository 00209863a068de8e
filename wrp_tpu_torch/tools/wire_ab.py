"""The wire-fused path's cost per sector on the card, piece by piece.
Counterpart of ``tools/wire_ab.py``.

Each piece is timed alone in one call, `steps` steps a span (CUDA events,
best of `reps` spans after a warm one), every step salted so no two steps
read the same data, and pinned for parity at salt 0 before it is timed:

  k_i16         the salted planar radix entry (#4, csrc/fused_chain_radix_
                salted.cu) on staged int16 sectors: the floor
  k_wire        the salted wire entry (#8, csrc/fused_chain_wire_salted.cu)
                on staged wire words, its slab by offset (no copy)
  slice+k_wire  the bench's slab slice of the staged words, salted by an
                XOR (a copy of the slab), then the wire kernel (#7)
  view          the byte slab's slice, XOR-salted, viewed as int32 words
                (`device_codec.wire_words_i32`'s view) and consumed by one
                reduction: an upper bound, the reduction rides along

``wrp_tpu``'s `take` (its radix row gather) and strided-rows pieces have
no counterpart: the port keeps rows in natural order and its kernels read
radix branches by index.  A parity miss prints {"error": ...} and exits 1;
any exception ends the run with a traceback and a non-zero exit.

    python -m wrp_tpu_torch.tools.wire_ab [--batch 32] [--steps 64]
    python -m wrp_tpu_torch.tools.wire_ab --smoke --device cpu   # plumbing
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
from ..oracle import relative_l2
from ..ops import device_codec, fullchain
from ._common import best_of, device_of

PARITY_TOL = 1e-5        # the wire kernel vs the planar kernel, as there


def run(cfg=DEFAULT_CONFIG, batch: int = 32, distinct: int = 2,
        steps: int = 64, reps: int = 5, device="cuda") -> dict:
    """The result line: each piece's us per sector and its span times, the
    parity errors, or {"error": ...} when a parity pin misses."""
    dev = torch.device(device)
    c, m, n = cfg.sector_shape
    B, D = batch, distinct
    mh = m // 2
    plan = fullchain.build_plan(PipelineConstants.build(cfg), dev)

    rng = np.random.default_rng(5)
    iq = rng.integers(-8192, 8192, (D * B, c, 2, m, n), dtype=np.int16)
    wire = np.stack([np.frombuffer(codec.encode_iq(
        (iq[k, :, 0] + 1j * iq[k, :, 1]).astype(np.complex64), cfg), np.uint8)
        for k in range(D * B)])
    d_iq = torch.from_numpy(iq.reshape(D * B * c, 2, m, n)).to(dev)
    d_u8 = torch.from_numpy(wire).to(dev)
    d_w32 = device_codec.wire_words_i32(d_u8, cfg)        # [D B, m, c n]

    def k_i16(i):
        return fullchain.fused_chain_power_radix(
            d_iq, plan, offset=(i % D) * B * c, bc=B * c, salt=i
        ).reshape(B, c, mh)

    def k_wire(i):
        return fullchain.fused_chain_power_wire(d_w32, plan, c,
                                                offset=(i % D) * B, bs=B,
                                                salt=i)

    def slice_k_wire(i):
        w = (d_w32[(i % D) * B:(i % D + 1) * B] ^ i).contiguous()
        return fullchain.fused_chain_power_wire(w, plan, c)

    def view(i):
        w = d_u8[(i % D) * B:(i % D + 1) * B] ^ (i & 0xFF)
        return device_codec.wire_words_i32(w, cfg)

    out = {"batch": B, "distinct": D, "steps": steps,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else str(dev)),
           "geometry": f"{c}x{m}x{n}"}
    # parity at salt 0: the wire kernel vs the planar kernel on the same
    # samples; the salted entries at salt 0 and the slab copy vs their
    # unsalted forms bit for bit; the view vs the words the kernels read
    p_i16, p_wire = k_i16(0), k_wire(0)
    parity = {"wire_vs_i16_rel_l2": relative_l2(p_i16.cpu().numpy(),
                                                p_wire.cpu().numpy())}
    bits = {
        "k_i16": torch.equal(p_i16, fullchain.fused_chain_power_radix(
            d_iq[:B * c], plan).reshape(B, c, mh)),
        "k_wire": torch.equal(p_wire, fullchain.fused_chain_power_wire(
            d_w32[:B].contiguous(), plan, c)),
        "slice+k_wire": torch.equal(slice_k_wire(0), p_wire),
        "view": torch.equal(view(0), d_w32[:B]),
    }
    parity["bit_identical_at_salt_0"] = bits
    out["parity"] = parity
    if not (parity["wire_vs_i16_rel_l2"] < PARITY_TOL and all(bits.values())):
        out["error"] = "parity failed"
        return out

    def consume_power(pw):
        return pw[..., 0, :].sum(0) - pw[..., 1, :].sum(0)

    pieces = {
        "k_i16": lambda i: consume_power(k_i16(i)),
        "k_wire": lambda i: consume_power(k_wire(i)),
        "slice+k_wire": lambda i: consume_power(slice_k_wire(i)),
        "view": lambda i: (view(i).float() * 1e-30).sum(),
    }
    for name, piece in pieces.items():
        def span():
            acc = torch.zeros((), device=dev)
            for i in range(steps):
                acc = acc + piece(i).sum()
            return acc

        best, runs = best_of(span, dev, reps)
        out[name] = {"us_per_sector": round(best / steps / B * 1e6, 2),
                     "runs_s": [round(r, 6) for r in runs]}
    out["k_wire_minus_k_i16_us"] = round(
        out["k_wire"]["us_per_sector"] - out["k_i16"]["us_per_sector"], 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wire_ab")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--distinct", type=int, default=2)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits 2 without CUDA) or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry, batch 2, 2 steps: plumbing and "
                         "parity only, the times mean nothing")
    args = ap.parse_args(argv)
    dev = device_of(ap, args.device)
    cfg = DEFAULT_CONFIG
    if args.smoke:
        cfg = tiny_config(m=64, n=32)
        args.batch, args.steps, args.reps = 2, 2, 1
    out = run(cfg, args.batch, args.distinct, args.steps, args.reps, dev)
    print(json.dumps(out), flush=True)
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main())
