"""The port's benchmark entry point, `python -m wrp_tpu_torch.bench`, on the
CPU at --smoke size: its JSON contract (the JAX bench's, tests/test_bench.py),
its parity gate across methods and input forms, the launches it makes, and
its refusals.  Its numbers on the card come from chip_smoke.py
(phase_bench)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from wrp_tpu_torch import bench
from wrp_tpu_torch.ops import fullchain

# few CPU threads per worker: the suite runs 6 workers beside tests that
# assert CPU-time floors (tests/test_native_codec.py)
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMOKE = ["--smoke", "--device", "cpu"]


def _cli(*flags, device_cpu=True):
    from conftest import cpu_subprocess_env

    env = cpu_subprocess_env(OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    argv = [sys.executable, "-m", "wrp_tpu_torch.bench", "--smoke", *flags]
    if device_cpu:
        argv += ["--device", "cpu"]
    return subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)


def _gate_ok(r):
    e0, e1 = r["parity_rel_l2"]
    return e0 < 1e-4 and e1 < 1e-3


def test_cli_prints_one_json_line_with_the_contract():
    out = _cli()
    assert out.returncode == 0, (out.stdout[-500:], out.stderr[-2000:])
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "sectors_per_second_3ch"
    assert r["value"] > 0 and r["unit"] == "sectors/s"
    assert r["vs_baseline"] > 0
    assert _gate_ok(r)
    assert r["sectors_per_second_with_h2d"] > 0
    assert r["sectors_per_second_with_h2d_pipelined"] > 0
    # the calibration probe is a card yardstick: null on the CPU
    assert "calib_tflops" in r and "value_normalized" in r
    assert r["calib_tflops"] is None and r["value_normalized"] is None
    assert r["device"] == "cpu" and r["geometry"] == "3x256x256"
    assert r["method"] == "pallas" and r["in_dtype"] == "i16"
    assert r["steps"] == 4 and len(r["timed_runs_s"]) == 3
    # the TPU formulation knobs are not ported, nor their fields
    for k in ("a_layout", "clip", "xsplit", "xpair", "wire_order"):
        assert k not in r


def _counts():
    return (fullchain.RADIX_OFFSET_LAUNCHES, fullchain.WIRE_OFFSET_LAUNCHES,
            fullchain.DENSE_OFFSET_LAUNCHES)


@pytest.mark.parametrize("flags,method,in_dtype,wire_decode", [
    (["--in-dtype", "wire"], "pallas", "wire", "fused"),
    (["--in-dtype", "wire", "--wire-decode", "xla"], "pallas", "wire", "xla"),
    (["--in-dtype", "f32"], "pallas", "f32", None),
    (["--range-cells", "200"], "pallas", "i16", None),
    (["--channels", "2"], "pallas", "i16", None),
    (["--method", "parseval"], "parseval", "f32", None),
    (["--method", "radix"], "radix", "f32", None),
    (["--method", "radix", "--matched-filter", "fold"], "radix", "f32", None),
    (["--method", "mxu"], "mxu", "f32", None),
    (["--method", "fft", "--matched-filter", "spectral"], "fft", "f32", None),
])
def test_methods_and_input_forms_pass_the_gate(flags, method, in_dtype,
                                               wire_decode):
    """In process (the entry chip_smoke.py calls): every form passes the
    parity gate; the CPU runs the plain versions, so no kernel launch is
    counted."""
    before = _counts()
    r = bench.run(SMOKE + flags)
    assert _counts() == before
    assert r["method"] == method and r["in_dtype"] == in_dtype
    assert r["wire_decode"] == wire_decode
    assert r["value"] > 0 and _gate_ok(r)
    assert r["sectors_per_second_with_h2d_pipelined"] > 0
    if "--channels" in flags:
        assert r["metric"] == "sectors_per_second_2ch"
    if "--range-cells" in flags:
        assert r["geometry"] == "3x200x256"


@pytest.mark.parametrize("flags,match", [
    (["--method", "mxu", "--in-dtype", "wire"], "pallas method only"),
    (["--in-dtype", "wire", "--distinct", "1"], "distinct >= 2"),
    (["--matched-filter", "fold"], "non-fused methods"),
    (["--method", "radix", "--matched-filter", "spectral"], "spectral"),
    (["--range-cells", "200", "--in-dtype", "wire"], "dense kernel"),
], ids=["flags1-pallas method only", "flags2-distinct >= 2",
        "flags3-non-fused methods", "flags4-spectral", "flags5-dense kernel"])
def test_refusals_exit_2(flags, match, capsys):
    with pytest.raises(SystemExit) as e:
        bench.run(SMOKE + flags)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_profile_writes_a_trace(tmp_path):
    r = bench.run(SMOKE + ["--profile", str(tmp_path)])
    assert _gate_ok(r)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_no_cuda_without_device_cpu_exits_2():
    """Nothing quietly runs on the CPU: the default device is cuda."""
    out = _cli(device_cpu=False)
    assert out.returncode == 2, (out.stdout[-500:], out.stderr[-1000:])
    assert "CUDA is not available" in out.stderr and out.stdout == ""


def test_failed_gate_prints_an_error_and_exits_1(monkeypatch, capsys):
    """A harness that disagrees with the processor stops the bench before
    any timed span: one {"error": ...} line, exit 1."""
    real = fullchain.fused_chain_power_radix

    def skewed(*a, **kw):       # the harness's offset entry only
        return real(*a, **kw) * (1.01 if "offset" in kw else 1.0)
    monkeypatch.setattr(fullchain, "fused_chain_power_radix", skewed)
    with pytest.raises(SystemExit) as e:
        bench.run(SMOKE)
    assert e.value.code == 1
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["error"] == "salted-harness parity check failed"
    assert r["salt0_rel_l2"] > 1e-4


def _sharded(*flags):
    """`--sharded 2 --device cpu` through the CLI: two gloo ranks, one torch
    thread each, through parallel/launch.run_ranks."""
    from conftest import cpu_subprocess_env

    return subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.bench", *SMOKE, "--sharded",
         "2", *flags], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=cpu_subprocess_env(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""))


def _sharded_contract(done) -> dict:
    """The line of a `--sharded 2` run, after the contract's checks."""
    assert done.returncode == 0, (done.stdout[-500:], done.stderr[-3000:])
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "sectors_per_second_3ch" and r["value"] > 0
    assert r["sharded_devices"] == 2 and r["sharded_backend"] == "gloo"
    par = r["sharded_parity_rel_l2"]
    assert sorted(par) == ["halo", "mxu", "pallas"]
    assert par["pallas"] < 1e-4 and par["mxu"] < 1e-3 and par["halo"] < 1e-3
    # the worst rank's salted harness on its own share, salt 0 and 7
    assert r["parity_rel_l2"][0] < 1e-4 and r["parity_rel_l2"][1] < 1e-3
    # one card's secondary metrics are not measured under --sharded
    assert r["h2d_gbps"] > 0
    assert r["sectors_per_second_with_h2d"] is None
    assert r["sectors_per_second_with_h2d_pipelined"] is None
    assert r["calib_tflops"] is None and r["value_normalized"] is None
    assert len(r["sharded_rank_span_s"]) == 2
    assert r["sharded_launches"] == [0, 0]       # the CPU: plain versions
    # the slowest rank's span, best of 3, over all B sectors of a step
    assert max(r["sharded_rank_span_s"]) <= min(r["timed_runs_s"]) + 1e-3
    assert r["batch"] == 4 and r["steps"] == 4 and r["device"] == "cpu"
    return r


def test_sharded_two_ranks_cli_contract():
    """`--sharded 2 --device cpu`: two gloo ranks (one torch thread each),
    exit 0, one JSON line with the contract, the three parity keys under
    their limits (pallas 1e-4, mxu and halo 1e-3), each rank's salted
    harness under the salted gate's, each rank's span, `value` over the
    whole batch, and no one-card secondary metric."""
    _sharded_contract(_sharded())


@pytest.fixture(scope="module")
def sharded_profile(tmp_path_factory):
    """One `--sharded 2 --profile DIR` run for the tests that read it."""
    out = tmp_path_factory.mktemp("sharded_profile")
    return _sharded("--profile", str(out)), out


def test_sharded_profile_writes_one_trace_a_rank(sharded_profile):
    """Under --sharded each rank traces its own pass into
    DIR/rank{r}/trace.json; the line is the sharded contract's, with no
    profile keys (the JAX bench adds none), and nothing is written to
    DIR/trace.json."""
    done, out = sharded_profile
    r = _sharded_contract(done)
    assert not any("profile" in k or "busy" in k for k in r)
    for rank in (0, 1):
        trace = json.loads((out / f"rank{rank}" / "trace.json").read_text())
        assert trace["traceEvents"]
    assert not (out / "trace.json").exists()


def test_trace_summary_reads_a_sharded_profile(sharded_profile):
    """trace_summary over DIR finds both ranks' traces and lists one
    process a rank, labelled by its rank folder, with its device time."""
    from wrp_tpu_torch.tools import trace_summary

    done, out = sharded_profile
    assert done.returncode == 0, done.stderr[-3000:]
    assert trace_summary.find_traces(str(out)) == [
        str(out / "rank0" / "trace.json"), str(out / "rank1" / "trace.json")]
    summary = trace_summary.run(str(out))
    procs = summary["processes"]
    assert len(procs) == 2
    assert sorted(p.split(":")[0] for p in procs) == ["rank0", "rank1"]
    assert sorted(summary["device"]) == ["rank0", "rank1"]
    # the CPU: no device work in either rank's pass
    assert all(p["device"]["kernel_ms"] == 0.0 for p in procs.values())


def test_a_failed_rank_ends_non_zero(monkeypatch, capsys):
    """A rank whose pass raises (its profiler, a launch) ends through
    end_rank with code 1, its traceback on stderr; it never returns 0."""
    def fail(argv=None):
        raise RuntimeError("profiler failed")

    def end_rank(code=0, timeout_s=30.0):
        raise SystemExit(code)
    monkeypatch.setattr(bench, "run", fail)
    monkeypatch.setattr(bench, "end_rank", end_rank)
    monkeypatch.setattr(bench.dist, "is_initialized", lambda: True)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
    assert "RuntimeError: profiler failed" in capsys.readouterr().err


def test_sharded_refusals_as_wrp_tpu(monkeypatch, capsys):
    """The JAX bench's --sharded refusals with its exit code, sys.exit with
    the message, status 1 (bench.py:162-165, 312-313, 503-505); and on
    cuda, N above the GPU count exits 2 before any rank starts (it does
    not run fewer ranks)."""
    for flags, match in ((["--sharded", "2", "--method", "mxu"],
                          "flagship kernel"),
                         (["--sharded", "2", "--in-dtype", "wire"],
                          "does not support --sharded"),
                         (["--sharded", "3"], "must divide by --sharded 3")):
        with pytest.raises(SystemExit) as e:
            bench.run(SMOKE + flags)
        assert isinstance(e.value.code, str) and match in e.value.code
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        bench.run(["--smoke", "--sharded", "2"])
    assert e.value.code == 2
    assert "needs 2 GPUs, this host has 1" in capsys.readouterr().err
