"""Numerics parity on the card: every method of the port against the fp64
oracle, each line with the launches of the port's kernels it made.
Counterpart of ``tools/hw_parity.py``.

The CPU tests hold each kernel's plain version against ``wrp_tpu``; this
holds the kernels themselves, compiled for the card, against the oracle.
Rows (one JSON line each; the tool exits 1 if any fails):

  mxu, parseval, radix, pallas, fft   SectorProcessor(method=...)
  mxu/fused-stage2                    the mxu method's range stage, then
                                      fused_stage2 (#9) for the pulse stages
  pallas/wire-decode-xla, -fused      raw wire bytes decoded on the device:
                                      a decode pass and the planar kernel
                                      (#3), or the wire kernel (#7)
  pallas-seq/astage+epilogue          the A-stage (#5) and row-epilogue
                                      (#6) kernels on a 1 x 1 mesh
  pallas/clip-bin-adversarial         the radix kernel on a sector whose
                                      Doppler energy sits in the clipped
                                      bins (the Parseval subtraction cancels)

Thresholds are the JAX tool's: zdb 1e-5, zdr 5e-4 relative L2 (zdr of
noise is a near-zero field, so its relative error divides by a small
norm), the adversarial power 2e-5.  ``wrp_tpu``'s int-split, pair and quad
variants have no counterpart in the port.

    python -m wrp_tpu_torch.tools.hw_parity [--batch 2] [--methods ...]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import oracle
from ..config import DEFAULT_CONFIG
from ..constants import PipelineConstants, hamming_factors
from ..io import codec
from ..ops import fullchain, postprocess
from ..pipeline import SectorProcessor, _DeviceConstants, _rmatmul, stage09_10_products
from ._common import device_of

THRESHOLDS = {"zdb": 1e-5, "zdr": 5e-4}
POWER_THRESHOLD = 2e-5
METHODS = ("mxu", "parseval", "radix", "pallas", "fft")


def _launches() -> dict:
    """The port's kernel counters (ops/fullchain.py, ops/postprocess.py)."""
    return {"radix": fullchain.LAUNCHES, "wire": fullchain.WIRE_LAUNCHES,
            "dense": fullchain.DENSE_LAUNCHES,
            "astage": fullchain.ASTAGE_LAUNCHES,
            "rows": fullchain.PARSEVAL_ROWS_LAUNCHES,
            "stage2": postprocess.STAGE2_LAUNCHES,
            "stage2_operator": postprocess.STAGE2_OPERATOR_LAUNCHES}


def _row(method, dev, before, kernels, errors, passed) -> dict:
    """One line: the errors, the kernel launches the row made (the
    counters' growth) and its verdict.  On the card the row passes only if
    each of `kernels` launched: the hand-written kernel ran, not its plain
    version (which the CPU takes)."""
    after = _launches()
    launches = {k: after[k] - before[k] for k in after}
    if dev.type == "cuda":
        passed = passed and all(launches[k] > 0 for k in kernels)
    return {"method": method, "device": str(dev), **errors,
            "kernels": list(kernels), "launches": launches,
            "pass": bool(passed)}


def _products_row(method, dev, before, kernels, truth, zdb, zdr) -> dict:
    """_row with the worst sector's zdb/zdr errors against the oracle."""
    zdb, zdr = zdb.cpu().numpy(), zdr.cpu().numpy()
    ez = max(oracle.relative_l2(t[0], z) for t, z in zip(truth, zdb))
    er = max(oracle.relative_l2(t[1], z) for t, z in zip(truth, zdr))
    return _row(method, dev, before, kernels,
                {"zdb_rel_l2": float(f"{ez:.3e}"),
                 "zdr_rel_l2": float(f"{er:.3e}")},
                ez < THRESHOLDS["zdb"] and er < THRESHOLDS["zdr"])


def adversarial_sector(cfg, rng) -> np.ndarray:
    """A sector whose Doppler energy sits in the clipped bins (pre-shift
    k = n/2 - 2, scaled by the inverse Doppler window) over small noise,
    rounded to integers: where the Parseval subtraction n sum|q|^2 -
    |clip|^2 cancels most (``tools/hw_parity.py``'s case)."""
    m, n = cfg.m, cfg.n
    _, wd, _ = hamming_factors(cfg)
    j = np.arange(n)
    k = n // 2 - 2
    ph0 = rng.uniform(0, 2 * np.pi, (cfg.num_channels, m, 1))
    base = np.cos(2 * np.pi * k * j / n + ph0) / wd[None, None, :]
    adv = (6000 * base / np.abs(base).max()
           + 1j * rng.integers(-50, 50, (cfg.num_channels, m, n)))
    return (np.round(adv.real) + 1j * np.round(adv.imag)).astype(np.complex64)


def run(batch: int = 2, methods=METHODS, seed: int = 42, device="cuda",
        cfg=DEFAULT_CONFIG) -> list:
    """The rows, in order; each a dict with "pass"."""
    dev = torch.device(device)
    iq = np.stack([oracle.synthetic_iq(cfg, kind="noise", seed=seed + k)
                   for k in range(batch)])
    truth = [oracle.process_sector(iq[k], cfg) for k in range(batch)]
    consts = PipelineConstants.build(cfg)
    rows = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fused = ("radix",) if fullchain.radix_for(cfg.m) > 1 else ("dense",)
    for method in methods:
        before = _launches()
        proc = SectorProcessor(cfg, method=method, device=dev)
        zdb, zdr = proc(np.asarray(iq, np.complex64))
        sync()
        rows.append(_products_row(method, dev, before,
                                  fused if method == "pallas" else (),
                                  truth, zdb, zdr))

    # the mxu method's range stage, then the pulse stages in fused_stage2
    dc = _DeviceConstants(consts, dev)
    x = torch.from_numpy(np.asarray(iq, np.complex64)).to(dev)
    mh, n = cfg.m // 2, cfg.n
    before = _launches()
    yr, yi = _rmatmul(dc.ar, dc.ai, x.real.contiguous(), x.imag.contiguous())
    pw = postprocess.fused_stage2(yr.reshape(-1, mh, n).contiguous(),
                                  yi.reshape(-1, mh, n).contiguous(),
                                  dc.br, dc.bi, consts.ma_taps)
    pw = pw.reshape(batch, cfg.num_channels, mh)
    zdb, zdr = stage09_10_products(pw[:, 0], pw[:, 1], dc.gain)
    sync()
    rows.append(_products_row("mxu/fused-stage2", dev, before,
                              ("stage2", "stage2_operator"), truth, zdb, zdr))

    # raw wire bytes decoded on the device, both formulations
    wire = np.stack([np.frombuffer(codec.encode_iq(iq[k], cfg), np.uint8)
                     for k in range(batch)])
    for wdec in ("xla", "fused"):
        before = _launches()
        proc = SectorProcessor(cfg, method="pallas", device=dev,
                               wire_input=True, wire_decode=wdec)
        win = wire.view("<i4") if proc.wire_dtype == np.int32 else wire
        zdb, zdr = proc(torch.from_numpy(np.ascontiguousarray(win)))
        sync()
        rows.append(_products_row(
            f"pallas/wire-decode-{wdec}", dev, before,
            ("wire",) if proc.wire_decode == "fused" else fused, truth, zdb,
            zdr))

    # the pulse-sharded kernels (A-stage, row epilogue) on a 1 x 1 mesh
    from ..parallel import build_sharded_processor, make_mesh, shard_batch

    mesh = make_mesh(device=dev)
    before = _launches()
    step = build_sharded_processor(cfg, mesh, method="pallas-seq", device=dev)
    zdb, zdr = step(shard_batch(np.asarray(iq, np.complex64), mesh,
                                step.layout))
    sync()
    rows.append(_products_row("pallas-seq/astage+epilogue", dev, before,
                              ("astage", "rows"), truth, zdb, zdr))

    # the clip-bin adversarial sector through the radix kernel, power only
    adv = adversarial_sector(cfg, np.random.default_rng(seed))
    pow64 = oracle.channel_power(adv, cfg)
    planar = np.stack([adv.real, adv.imag], 1).astype(np.float32)
    before = _launches()
    got = fullchain.build_fused_processor(consts, dev)(
        torch.from_numpy(planar[None]).to(dev))[0]
    sync()
    ea = oracle.relative_l2(pow64, got.cpu().numpy())
    rows.append(_row("pallas/clip-bin-adversarial", dev, before, fused,
                     {"pow_rel_l2": float(f"{ea:.3e}")}, ea < POWER_THRESHOLD))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hw_parity")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--methods", default=",".join(METHODS))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits 2 without CUDA) or 'cpu' "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = device_of(ap, args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr)
    rows = run(args.batch, args.methods.split(","), args.seed, dev)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if all(r["pass"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
