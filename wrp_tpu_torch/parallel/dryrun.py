"""A dry run of every sharded step on N ranks, at tiny shapes.

    python -m wrp_tpu_torch.parallel.dryrun N                 # N GPUs, NCCL
    python -m wrp_tpu_torch.parallel.dryrun N --device cpu    # N gloo ranks

Counterpart of ``__graft_entry__.dryrun_multichip``: the ranks form the
[data, seq] mesh it would choose (the deepest seq split up to 8 that
divides N, the rest data-parallel) on its tiny geometry, and check what it
checks, with its bounds: the mxu step's shape and finiteness, the halo step
against it (< 1e-4), the data-parallel pallas step against mxu (< 1e-3),
pallas-seq against pallas (< 1e-5), and the device wire decode of every
rank's sectors bit-exact against the host decoder.  Rank 0 prints the same
OK line; any failed check exits non-zero.  The ranks run on the GPUs, one
each over NCCL, so N must not exceed the GPU count; without CUDA the dry
run exits 2 unless `--device cpu` asks for gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..config import tiny_config
from ..io import codec
from ..ops import device_codec
from ..oracle import relative_l2
from .halo import build_halo_processor
from .launch import ROOT, end_rank, module_env, run_ranks
from .mesh import init_distributed, make_mesh
from .sharded import build_sharded_processor, gather_batch, shard_batch

#: the time limit of the ranks, and of their group's collectives
TIMEOUT_S = 600.0


def choose_seq(n_ranks: int) -> int:
    """The deepest seq split (up to 8) that divides n_ranks, as
    ``__graft_entry__.py`` chooses it."""
    seq = 1
    while seq * 2 <= n_ranks and n_ranks % (seq * 2) == 0 and seq * 2 <= 8:
        seq *= 2
    return seq


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_config(seq: int):
    """The dry run's tiny geometry for a mesh of `seq` pulse shards
    (``__graft_entry__.py:62``)."""
    return tiny_config(m=16 * max(seq, 2), n=8 * max(seq, 2))


def run_checks(mesh) -> str:
    """The dry run's checks on this rank's place in `mesh` (every rank of
    the group calls it); returns the OK line.  Raises if a check fails."""
    rank, n_ranks, data, seq = mesh.rank, mesh.world, mesh.data, mesh.seq
    dev = mesh.device
    cfg = dryrun_config(seq)

    def host(t):
        return t.cpu().numpy()

    def run(step, x):
        zdb, zdr = step(shard_batch(x, mesh, step.layout))
        return (host(gather_batch(zdb, mesh, step.layout)),
                host(gather_batch(zdr, mesh, step.layout)))

    rng = np.random.default_rng(0)
    shape = (2 * data, *cfg.sector_shape)
    iq = (rng.integers(-2048, 2048, shape)
          + 1j * rng.integers(-2048, 2048, shape)).astype(np.complex64)
    step = build_sharded_processor(cfg, mesh, method="mxu")
    zdb, zdr = run(step, iq)
    _require(zdb.shape == (2 * data, cfg.num_output_bins), f"zdb {zdb.shape}")
    _require(bool(np.isfinite(zdr).any()), "no finite zdr")

    # end-to-end pulse sharding with the overlap-save halo (parallel/halo.py)
    halo_step = build_halo_processor(cfg, mesh)
    zdb_h, zdr_h = run(halo_step, iq)
    err = relative_l2(zdb, zdb_h)
    _require(err < 1e-4, f"halo vs transpose formulation diverge: {err}")

    # the fused kernel data-parallel over every rank, 2 sectors a rank
    pal_step = build_sharded_processor(cfg, mesh, method="pallas")
    shape_p = (2 * n_ranks, *cfg.sector_shape)
    iq_p = (rng.integers(-2048, 2048, shape_p)
            + 1j * rng.integers(-2048, 2048, shape_p)).astype(np.complex64)
    zdb_p, _ = run(pal_step, iq_p)
    _require(zdb_p.shape == (2 * n_ranks, cfg.num_output_bins),
             f"pallas zdb {zdb_p.shape}")
    mxu_zdb, _ = run(step, iq_p[:2 * data])
    err_p = relative_l2(mxu_zdb, zdb_p[:2 * data])
    _require(err_p < 1e-3, f"pallas vs mxu sharded paths diverge: {err_p}")

    # the fused chain split at its transpose point (A-stage kernel per
    # pulse slice, all_to_all, row-epilogue kernel per row shard)
    seq_step = build_sharded_processor(cfg, mesh, method="pallas-seq")
    zdb_ps, _ = run(seq_step, iq_p[:2 * data])
    err_ps = relative_l2(zdb_p[:2 * data], zdb_ps)
    _require(err_ps < 1e-5, f"pallas-seq vs pallas diverge: {err_ps}")

    # the device wire decode of this rank's sectors (the batch over every
    # rank) against the host decoder, bit for bit
    rows = slice(2 * rank, 2 * rank + 2)
    wires = np.stack([np.frombuffer(codec.encode_iq(x, cfg), np.uint8)
                      for x in iq_p[rows]])
    dec = host(device_codec.decode_wire_i16(torch.from_numpy(wires).to(dev),
                                            cfg))
    want = np.stack([codec.decode_iq_i16(w, cfg) for w in wires])
    same = torch.tensor([int(dec.shape == want.shape
                             and bool((dec == want).all()))],
                        dtype=torch.int32, device=dev)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    _require(bool(same.item()), "sharded device decode != host decoder")

    return (f"dryrun_multichip OK: mesh {data}x{seq} ({n_ranks} devices), "
            f"batch {iq.shape} -> zdb {zdb.shape}; halo-vs-transpose rel "
            f"err {err:.2e}; pallas sharded batch {iq_p.shape} OK, "
            f"pallas-vs-mxu rel err {err_p:.2e}; pallas-seq (pulse-sharded "
            f"fused kernel) rel err {err_ps:.2e}; sharded wire decode "
            f"bit-exact over {n_ranks} devices")


def _rank(n_ranks: int, rank: int, port: int, device: str) -> str:
    dev = init_distributed(f"127.0.0.1:{port}", n_ranks, rank, device,
                           timeout_s=TIMEOUT_S)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    seq = choose_seq(n_ranks)
    return run_checks(make_mesh(data=n_ranks // seq, seq=seq, device=dev))


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> str:
    """Start n_ranks ranks (NCCL, one GPU each; gloo with device="cpu"),
    run the dry run's checks and return rank 0's OK line; raises if any
    rank failed.  A CUDA run without CUDA, or with fewer GPUs than ranks,
    raises ValueError: nothing falls back to the CPU or to fewer ranks."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("CUDA is not available; pass --device cpu "
                             "(device='cpu') for gloo ranks on the CPU")
        if n_ranks > torch.cuda.device_count():
            raise ValueError(f"{n_ranks} ranks need {n_ranks} GPUs, this "
                             f"host has {torch.cuda.device_count()} (NCCL "
                             "takes one rank a GPU)")

    def argv(rank, port):
        return [sys.executable, "-m", "wrp_tpu_torch.parallel.dryrun",
                str(n_ranks), "--device", device, "--rank", str(rank),
                "--port", str(port)]

    results = run_ranks(argv, n_ranks, TIMEOUT_S, env=module_env(), cwd=ROOT)
    failed = [r for r in results if r.rc != 0]
    if failed:
        raise RuntimeError("dryrun_multichip: " + "; ".join(
            f"rank {r.rank} exit {r.rc}: {r.err[-3000:]}" for r in failed))
    return results[0].out.strip().splitlines()[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wrp_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("ranks", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): one GPU a rank over NCCL; cpu: "
                         "gloo ranks running the plain versions")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        line = _rank(args.ranks, args.rank, args.port, args.device)
        if args.rank == 0:
            print(line, flush=True)
        end_rank(0)
    try:
        print(dryrun_multichip(args.ranks, args.device), flush=True)
    except ValueError as e:
        ap.error(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
