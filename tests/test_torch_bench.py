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
    (["--sharded", "2"], "not yet ported"),
    (["--method", "mxu", "--in-dtype", "wire"], "pallas method only"),
    (["--in-dtype", "wire", "--distinct", "1"], "distinct >= 2"),
    (["--matched-filter", "fold"], "non-fused methods"),
    (["--method", "radix", "--matched-filter", "spectral"], "spectral"),
    (["--range-cells", "200", "--in-dtype", "wire"], "dense kernel"),
])
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
