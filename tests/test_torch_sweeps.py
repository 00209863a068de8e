"""The port's ab_sweep and multihost_bench tools on the CPU, and the bounded
ending every rank process goes through (parallel/launch.end_rank).

`ab_sweep --smoke --device cpu` is held to the JAX tool's smoke contract
(tests/test_bench.py) and its i16 row to wrp_tpu's pallas processor
(interpret mode); `multihost_bench` runs real gloo ranks, one torch thread
a rank, each world with a time limit and a fresh port.  Their numbers on
the card come from chip_smoke.py (phase_last_tools)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wrp_tpu import pipeline as jpipe
from wrp_tpu.config import tiny_config as jtiny
from wrp_tpu_torch import bench
from wrp_tpu_torch.config import tiny_config
from wrp_tpu_torch.oracle import relative_l2
from wrp_tpu_torch.ops import fullchain
from wrp_tpu_torch.parallel.launch import run_ranks
from wrp_tpu_torch.tools import ab_sweep, multihost_bench

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMOKE = ["--smoke", "--device", "cpu"]
RANK_TIMEOUT_S = 240
#: the keys of tools/multihost_bench.py's JSON line
JAX_MULTIHOST_KEYS = [
    "metric", "method", "hosts", "devices_per_host", "per_host_batch",
    "sectors_per_second_1host", "sectors_per_second_nhost",
    "efficiency_raw", "physical_cpus", "shared_cpu_ceiling",
    "efficiency_vs_ceiling", "backend"]


def _env():
    from conftest import cpu_subprocess_env

    return cpu_subprocess_env(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")


def _smoke_sweep():
    """ab_sweep's Sweep at its --smoke size (tiny_config(256, 128), batch
    4, 2 slabs, 2 repeats) on the CPU."""
    return ab_sweep.Sweep(tiny_config(m=256, n=128), 4, 2, 2, "cpu")


def test_ab_sweep_smoke_contract(capsys):
    """The JAX smoke test's contract: one row per variant then a summary,
    each gate under 1e-4 / 1e-3, a positive rate; the CPU launches no
    kernel."""
    assert ab_sweep.main(SMOKE) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(ab_sweep.VARIANTS) + 1
    rows, summary = lines[:-1], lines[-1]
    assert [r["variant"] for r in rows] == list(ab_sweep.VARIANTS)
    for r in rows:
        assert r["parity_ok"], r
        e0, e1 = r["parity_rel_l2"]
        assert e0 < 1e-4 and e1 < 1e-3
        assert r["sectors_per_second"] > 0 and r["vs_baseline"] > 0
        assert len(r["timed_runs_s"]) == 3 and r["build_s"] >= 0
        assert r["batch"] == 4 and r["steps"] == 4
        assert not any(r["launches"].values())
    assert summary["best"] in ab_sweep.VARIANTS
    assert summary["summary"] == {r["variant"]: r["sectors_per_second"]
                                  for r in rows}
    assert summary["best_sectors_per_second"] == max(
        r["sectors_per_second"] for r in rows)
    assert summary["device"] == "cpu"


@pytest.mark.parametrize("variant", ["f32", "wire", "wire_xla"])
def test_ab_sweep_stagings_equal_the_bench(variant):
    """Each staging made on the device is bit-equal to what the bench stages
    from the host for that --in-dtype / --wire-decode."""
    sweep = _smoke_sweep()
    c, m, n = sweep.cfg.sector_shape
    host = np.random.default_rng(0).integers(
        -8192, 8192, (2, 4, c, 2, m, n), dtype=np.int16)
    assert torch.equal(sweep.x, torch.from_numpy(host))
    if variant == "f32":
        want = host.astype(np.float32)
    else:
        want = bench._wire_bytes(host.reshape(8, c, 2, m, n))
        if variant == "wire":
            want = want.view("<i4")
    got = sweep.staging(variant)
    assert got.dtype == torch.from_numpy(want).dtype
    assert np.array_equal(got.numpy(), want)


def test_ab_sweep_i16_matches_wrp_tpu():
    """The i16 row's harness at salt 0 on slab 0 against wrp_tpu's
    SectorProcessor(method="pallas") (interpret mode) on the same int16
    sectors."""
    sweep = _smoke_sweep()
    step = sweep.step_power("i16", sweep.staging("i16"))
    zdb = sweep.products(step(0, 0))[0].numpy()
    jproc = jpipe.SectorProcessor(jtiny(m=256, n=128), method="pallas")
    want = np.asarray(jproc(sweep.x[0].numpy())[0])
    assert relative_l2(want, zdb) < 1e-5


def test_ab_sweep_parity_miss_exits_1(capsys, monkeypatch):
    """A harness that disagrees with the processor misses its gate: the
    variant is not timed, the others are, and the tool exits 1."""
    real = fullchain.fused_chain_power_radix

    def skewed(*a, **kw):       # the harness's offset entry only
        return real(*a, **kw) * (1.01 if "offset" in kw else 1.0)
    monkeypatch.setattr(fullchain, "fused_chain_power_radix", skewed)
    assert ab_sweep.main(SMOKE + ["--variants", "i16,wire"]) == 1
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows[0]["variant"] == "i16" and not rows[0]["parity_ok"]
    assert rows[0]["timed_runs_s"] == [] and rows[0]["sectors_per_second"] == 0
    assert rows[1]["variant"] == "wire" and rows[1]["parity_ok"]
    assert rows[2]["best"] == "wire"


def test_ab_sweep_exception_propagates(monkeypatch):
    """Unlike the JAX tool, which records a failing variant and sweeps on,
    an exception ends the run."""
    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(fullchain, "fused_chain_power_wire", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ab_sweep.main(SMOKE)


def test_ab_sweep_unknown_variant_exits_1():
    """As the JAX tool's sys.exit(str): the message, exit status 1."""
    with pytest.raises(SystemExit) as e:
        ab_sweep.main(SMOKE + ["--variants", "i16,kcat"])
    assert isinstance(e.value.code, str) and "unknown variant" in e.value.code


@pytest.mark.parametrize("tool", [ab_sweep, multihost_bench])
def test_exit_2_without_cuda(tool, monkeypatch):
    """The default device is cuda: nothing quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert e.value.code == 2


@pytest.mark.parametrize("method", multihost_bench.METHODS)
def test_multihost_bench_two_gloo_hosts(method):
    """--hosts 2 --device cpu: a 1-rank world then a 2-rank world over gloo;
    the JAX tool's JSON line, key for key, and each rank's launches."""
    out = subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.tools.multihost_bench",
         "--hosts", "2", "--device", "cpu", "--method", method, "--m", "64",
         "--n", "32", "--per-host-batch", "2", "--steps", "2", "--timeout",
         str(RANK_TIMEOUT_S)],
        cwd=REPO, capture_output=True, text=True, env=_env(),
        timeout=3 * RANK_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-500:], out.stderr[-3000:])
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert list(r) == JAX_MULTIHOST_KEYS
    assert r["metric"] == "multihost_weak_scaling" and r["method"] == method
    assert r["hosts"] == 2 and r["devices_per_host"] == 1
    assert r["efficiency_raw"] > 0 and r["backend"] == "gloo on cpu"
    assert r["sectors_per_second_1host"] > 0
    launches = [ln for ln in out.stderr.splitlines()
                if ln.startswith("launches: ")]
    per_rank = json.loads(launches[-1][len("launches: "):])
    assert len(per_rank["1host"]) == 1 and len(per_rank["nhost"]) == 2


@pytest.mark.parametrize("flags,match", [
    (["--hosts", "2"], "2 ranks need 2 GPUs"),
    (["--hosts", "1", "--devices-per-host", "2"], "2 ranks need 2 GPUs"),
    (["--per-host-batch", "3", "--devices-per-host", "2", "--device", "cpu"],
     "must divide"),
])
def test_multihost_bench_refusals_exit_2(flags, match, monkeypatch, capsys):
    """A world larger than the GPUs (NCCL takes one rank a GPU; one card
    here, stood in for) and a per-host batch that does not divide by the
    host's devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        multihost_bench.main(flags)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


# Two gloo ranks ending through end_rank: rank 1 either tears the group down
# a second after the barrier (rank 0, the store's host, leaves at once) or
# is gone before it.
END_WORKER = r"""
import os, sys, time
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from wrp_tpu_torch.parallel.launch import end_rank
from wrp_tpu_torch.parallel.mesh import init_distributed

rank, port, case = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_distributed(f"127.0.0.1:{port}", 2, rank, "cpu", timeout_s=60)
t = torch.ones(1)
dist.all_reduce(t)
assert t.item() == 2
if rank == 1 and case == "gone":
    os._exit(0)
if rank == 1:
    real = dist.destroy_process_group

    def late():
        time.sleep(1.0)
        real()
    dist.destroy_process_group = late
print(f"rank {rank} done", flush=True)
end_rank(0, 5.0)
"""


@pytest.mark.parametrize("case", ["late", "gone"])
def test_end_rank_is_bounded(case):
    """Both ranks exit 0 within the bound (a barrier of 5 s, then the
    teardown under a timer), whether the peer leaves late or is gone."""
    t0 = time.monotonic()
    results = run_ranks(
        lambda rank, port: [sys.executable, "-c", END_WORKER, str(rank),
                            str(port), case],
        2, 60, env=_env(), cwd=str(REPO))
    took = time.monotonic() - t0
    for r in results:
        assert r.rc == 0, (r.rank, r.rc, r.out, r.err[-2000:])
    assert "rank 0 done" in results[0].out
    assert took < 40, took
