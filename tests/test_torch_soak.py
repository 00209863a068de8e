"""The port's consolidation_soak on the CPU: N feeds (UDP and ZMQ, each a
`cli produce` process of the port) through one StreamingExecutor, held to
the JAX tool's smoke contract (tests/test_bench.py), its contamination
check with teeth, the host stub, and its refusals.  Every run takes free
ports.  Its numbers on the card come from chip_smoke.py
(phase_last_tools)."""

import builtins
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from wrp_tpu_torch.tools import consolidation_soak as soak

pytest.importorskip("zmq")

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMOKE = ["--smoke", "--device", "cpu"]


@pytest.fixture
def producer_env(monkeypatch):
    """The producers inherit this process's environment: the CPU one, one
    thread each."""
    from conftest import cpu_subprocess_env

    monkeypatch.setenv("PYTHONPATH", cpu_subprocess_env()["PYTHONPATH"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _run(capsys, flags):
    """(rc, per-feed rows, record) of the tool run in this process."""
    rc = soak.main(flags)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return rc, lines[:-1], lines[-1]


def test_soak_smoke_contract(producer_env, capsys, tmp_path):
    """A UDP feed and a ZMQ feed: per-feed rows with processed sectors,
    p99 and a zdb within the CPU's fp32 floor of each feed's own oracle;
    no contamination failure; --out appends the record."""
    out = tmp_path / "rec.json"
    rc, rows, record = _run(capsys, SMOKE + ["--out", str(out)])
    assert rc == 0
    assert record["metric"] == "consolidation_soak"
    assert record["kinds"] == ["udp", "zmq"]
    assert record["contamination_failures"] == []
    assert len(record["per_feed"]) == 2 and rows == record["per_feed"]
    for row in record["per_feed"]:
        assert row["processed_sectors"] > 0
        assert row["coverage_sectors"] == row["processed_sectors"]
        assert row["verify_labels"] == 2
        assert row["verify_rel_l2_max"] < 1e-6
        assert row["p99_ms"] is not None
    assert record["method"] == "pallas" and record["backend"] == "cpu"
    assert record["executor_cpu_s"] > 0 and record["duration_s"] > 0
    assert not any(record["kernel_launches"].values())
    assert json.loads(out.read_text()) == [record]


def test_soak_swapped_volumes_fail_the_check(producer_env, capsys,
                                             monkeypatch):
    """Each feed's products checked against the other feed's oracle: the
    check records the failures and the tool exits 1."""
    real = soak.check_feeds

    def swapped(volumes, *a, **kw):
        return real(volumes[::-1], *a, **kw)
    monkeypatch.setattr(soak, "check_feeds", swapped)
    rc, _, record = _run(capsys, SMOKE)
    assert rc == 1
    feeds = {f["feed"] for f in record["contamination_failures"]}
    assert feeds == {0, 1}
    assert all(f.get("rel_l2", 1.0) > 1e-3
               for f in record["contamination_failures"])


def test_soak_stub_device(producer_env, capsys, tmp_path):
    """--stub-device: the host path alone, egress on; every sector covered,
    rates and no drops, no oracle; --trace writes the trace and the host
    intervals."""
    trace = tmp_path / "trace"
    rc, rows, record = _run(capsys, SMOKE + ["--stub-device", "--trace",
                                             str(trace)])
    assert rc == 0
    assert record["method"] == "stub" and record["backend"] == "stub"
    assert record["decode"] == "host-i16"
    for row in rows:
        assert row["processed_sectors"] == row["sent_sectors"] == 12
        assert row["coverage_sectors"] == 12 and row["drops"] == 0
        assert row["sectors_per_second"] > 0
        assert row["verify_labels"] == 0 and row["verify_rel_l2_max"] is None
    assert record["total_sectors_per_second"] > 0
    assert record["timers"]["egress/send"]["count"] > 0
    assert (trace / "trace.json").exists()
    assert json.loads((trace / "host_intervals.json").read_text())


@pytest.mark.parametrize("flags", [
    ["--feeds", "1"],
    ["--stub-device", "--device-decode"],
])
def test_soak_refusals_exit_2(flags):
    with pytest.raises(SystemExit) as e:
        soak.main(["--device", "cpu"] + flags)
    assert e.value.code == 2


def test_soak_exits_2_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        soak.main(["--smoke"])
    assert e.value.code == 2


def test_soak_writes_nothing_under_proc(producer_env, capsys, monkeypatch):
    """Unlike the JAX tool, which raises net.core.rmem_max for the host,
    the soak only reads it."""
    real_open = builtins.open
    read = []

    def guarded(file, mode="r", *a, **kw):
        if str(file).startswith("/proc"):
            if any(c in mode for c in "wax+"):
                raise AssertionError(f"write under /proc: {file}")
            read.append(str(file))
        return real_open(file, mode, *a, **kw)
    monkeypatch.setattr(builtins, "open", guarded)
    rc, _, record = _run(capsys, SMOKE + ["--stub-device"])
    assert rc == 0 and record["total_sectors"] == 24
    assert "/proc/sys/net/core/rmem_max" in read


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_consolidation_soak", REPO / "tools" / "consolidation_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sent", [1, 143, 1286, 1287, 1288, 3000])
def test_last_k_for_label_matches_the_jax_tool(sent):
    """The label arithmetic of the oracle check, label by label."""
    jax_last_k = _jax_tool().last_k_for_label
    for s in range(0, 143, 7):
        for e in range(9):
            assert soak.last_k_for_label(s, e, sent) == jax_last_k(s, e, sent)
    assert soak.REAL_RADAR_RATE == _jax_tool().REAL_RADAR_RATE
