"""The port's tools that read or check the CLI's output, on the CPU:
trace_summary (against tools/trace_summary.py), hw_parity, wire_ab and
decode_ab (their --device cpu / --smoke contracts; the card runs them in
chip_smoke.py)."""

import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from wrp_tpu_torch.tools import decode_ab, hw_parity, trace_summary, wire_ab

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _jax_trace_summary():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_summary", REPO / "tools" / "trace_summary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _intervals(seed):
    """Executor-like [name, thread, t0, t1] rows: batches in flight, the
    ingest thread's recv/decode overlapping some of them, the compute
    thread's stages, and a stage that never overlaps."""
    rng = np.random.default_rng(seed)
    rows, t = [], 0.0
    for _ in range(40):
        d0 = t + rng.uniform(0.0, 2e-3)
        d1 = d0 + rng.uniform(1e-3, 6e-3)
        rows.append(["compute/in_flight", "MainThread", d0, d1])
        rows.append(["compute/dispatch", "MainThread", d0, d0 + 2e-4])
        rows.append(["compute/fetch", "MainThread", d1 - 5e-4, d1])
        r0 = t + rng.uniform(0.0, 8e-3)
        rows.append(["ingest/recv", "wrp-ingest-0", r0, r0 + 3e-3])
        rows.append(["ingest/decode", "wrp-ingest-0", r0 + 3e-3,
                     r0 + 3e-3 + rng.uniform(5e-4, 2e-3)])
        t = d1 + rng.uniform(1e-3, 5e-3)
    rows.append(["checkpoint/save", "MainThread", t + 1.0, t + 1.2])
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_summarise_overlap_matches_jax(seed):
    rows = _intervals(seed)
    got = trace_summary.summarise_overlap(rows)
    assert got == _jax_trace_summary().summarise_overlap(rows)
    assert set(got) == {"busy_s", "in_flight_s", "overlap_with_in_flight"}
    assert set(got["overlap_with_in_flight"]["ingest/decode"]) == {
        "of_stage", "of_in_flight", "overlap_s"}
    assert got["overlap_with_in_flight"]["checkpoint/save"]["of_stage"] == 0.0
    # without an in-flight span only the busy totals, as there
    rest = [r for r in rows if r[0] != "compute/in_flight"]
    assert trace_summary.summarise_overlap(rest) == \
        _jax_trace_summary().summarise_overlap(rest) == {
            "busy_s": trace_summary.summarise_overlap(rest)["busy_s"]}


def _profile(trace_dir: Path):
    """A CPU torch.profiler trace in the form `stream --trace` writes: the
    executor's spans from a second thread and the main thread."""
    from wrp_tpu_torch.cli import TRACE_FILE, _start_trace

    from wrp_tpu_torch.runtime.metrics import StageTimers

    timers = StageTimers()
    timers.enable_intervals(annotate=True)

    def ingest():
        for _ in range(3):
            with timers.time("ingest/decode"):
                torch.ones(64).sum()

    prof = _start_trace(torch.device("cpu"))
    t = threading.Thread(target=ingest, name="wrp-ingest-0")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    for _ in range(2):
        with timers.time("compute/dispatch"):
            torch.ones(64).sum()
    prof.stop()
    trace_dir.mkdir()
    prof.export_chrome_trace(str(trace_dir / TRACE_FILE))
    (trace_dir / "host_intervals.json").write_text(json.dumps(timers.intervals))
    return timers.intervals


def test_trace_summary_json_on_a_trace(tmp_path, capsys):
    intervals = _profile(tmp_path / "tr")
    assert trace_summary.main([str(tmp_path / "tr"), "--json", "--overlap",
                               "--top", "5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"traces", "processes", "device", "overlap"}
    assert [Path(p).name for p in out["traces"]] == ["trace.json"]
    assert out["overlap"] == trace_summary.summarise_overlap(intervals)
    # the host process holds both threads' spans, each under its thread
    host = [info for info in out["processes"].values()
            if any(op["name"] == "ingest/decode" for op in info["ops"])]
    assert len(host) == 1
    by_thread = {th: {op["name"]: op["calls"] for op in ti["ops"]}
                 for th, ti in host[0]["threads"].items()}
    assert sorted(c.get("ingest/decode", 0) for c in by_thread.values()
                  if "ingest/decode" in c) == [3]
    assert any(c.get("compute/dispatch") == 2 for c in by_thread.values())
    assert all(len(info["ops"]) <= 5 for info in out["processes"].values())
    # no device in a CPU trace: nothing busy
    dev = out["device"]["trace"]
    assert dev["kernel_ms"] == 0.0 and dev["busy_share"] == 0.0
    # the text form, and the refusals
    assert trace_summary.main([str(tmp_path / "tr"), "--overlap"]) == 0
    text = capsys.readouterr().out
    assert "ingest/decode" in text and "device (trace)" in text
    (tmp_path / "none").mkdir()
    assert trace_summary.main([str(tmp_path / "none")]) == 1
    assert trace_summary.main([str(tmp_path / "none"), "--overlap"]) == 1


def test_device_busy_counts_the_union_of_device_work():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "a", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 50, "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "u", "ts": 90,
           "dur": 110}]
    d = trace_summary.device_busy(ev)
    assert d["window_ms"] == 0.2 and d["kernel_ms"] == 0.03
    assert d["busy_ms"] == 0.04 and d["busy_share"] == pytest.approx(0.2)
    assert d["kernel_share"] == pytest.approx(0.15)
    assert d["kernel_launches"] == {"k": 2}
    # clipped to a window: the parts of the device work inside it
    w = trace_summary.device_busy(ev, span=(15, 55))
    assert w["window_ms"] == 0.04 and w["kernel_ms"] == 0.025
    assert w["busy_ms"] == 0.03 and w["busy_share"] == pytest.approx(0.75)


def test_stream_span_is_first_decode_to_last_fetch():
    def span(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur}

    ev = [span("compute/warmup", 0, 50), span("ingest/recv", 60, 5),
          span("ingest/decode", 70, 3), span("compute/fetch", 80, 4),
          span("ingest/decode", 90, 3), span("compute/fetch", 95, 6),
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 96, "dur": 1}]
    assert trace_summary.stream_span(ev) == (70.0, 101.0)
    assert trace_summary.stream_span(ev[:2]) is None


def test_summarise_counts_the_device_as_threads_of_its_process(tmp_path):
    """A CUDA trace in torch.profiler's form: the host process (labels
    "CPU"), the device under its index (labels "GPU 1", named after the
    program too) and the profiler's own rows (pids "Spans" and -1, no
    process name).  One process,
    the device's stream among its threads; two such traces in rank folders
    stay two processes, each with its own device time, though they share
    the device index and the pid."""
    def meta(pid, name, labels):
        return [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": name}},
                {"ph": "M", "name": "process_labels", "pid": pid, "tid": 0,
                 "args": {"labels": labels}}]

    def trace(kernel_us):
        return {"traceEvents": meta(4242, "python3", "CPU") + meta(
            1, "python3", "GPU 1") + [
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 7,
             "args": {"name": "stream 7"}},
            {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 4242,
             "tid": 4242, "ts": 0, "dur": 100},
            {"ph": "X", "cat": "kernel", "name": "fft_chain_kernel",
             "pid": 1, "tid": 7, "ts": 10, "dur": kernel_us},
            {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler",
             "pid": "Spans", "tid": 0, "ts": 0, "dur": 200},
            {"ph": "X", "cat": "overhead", "name": "Activity Buffer Request",
             "pid": -1, "tid": 0, "ts": 5, "dur": 3}]}

    procs = trace_summary.summarise(trace(20)["traceEvents"])
    assert list(procs) == ["python3 [pid 4242]"]
    threads = procs["python3 [pid 4242]"]["threads"]
    assert sorted(threads) == ["4242", "GPU 1: stream 7 [tid 7]"]
    for rank, us in ((0, 20), (1, 50)):
        (tmp_path / f"rank{rank}").mkdir()
        (tmp_path / f"rank{rank}" / "trace.json").write_text(
            json.dumps(trace(us)))
        if rank == 0:      # one rank (--sharded 1): still labelled by rank
            assert list(trace_summary.run(str(tmp_path))["device"]) == [
                "rank0"]
    out = trace_summary.run(str(tmp_path))
    assert {k: v["device"]["kernel_ms"] for k, v in
            out["processes"].items()} == {"rank0: python3 [pid 4242]": 0.02,
                                          "rank1: python3 [pid 4242]": 0.05}
    assert sorted(out["device"]) == ["rank0", "rank1"]
    assert out["device"]["rank1"]["kernel_launches"] == {
        "fft_chain_kernel": 1}


def test_find_traces_takes_the_port_names(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "w.1.pt.trace.json").write_text("{}")
    assert trace_summary.find_traces(str(tmp_path)) == [
        str(tmp_path / "a" / "w.1.pt.trace.json")]
    (tmp_path / "trace.json").write_text("{}")
    assert trace_summary.find_traces(str(tmp_path)) == [
        str(tmp_path / "trace.json")]


def test_hw_parity_every_method_passes_on_cpu(capsys):
    assert hw_parity.main(["--device", "cpu", "--batch", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    methods = [r["method"] for r in rows]
    assert methods[:5] == list(hw_parity.METHODS)
    assert {"mxu/fused-stage2", "pallas/wire-decode-xla",
            "pallas/wire-decode-fused", "pallas-seq/astage+epilogue",
            "pallas/clip-bin-adversarial"} <= set(methods)
    for r in rows:
        assert r["pass"] is True and r["device"] == "cpu"
        # the plain versions run on the CPU: no kernel launched
        assert not any(r["launches"].values())
        if "zdb_rel_l2" in r:
            assert r["zdb_rel_l2"] < 1e-5 and r["zdr_rel_l2"] < 5e-4
    kernels = {r["method"]: r["kernels"] for r in rows}
    assert kernels["pallas"] == ["radix"] and kernels["mxu"] == []
    assert kernels["pallas/wire-decode-fused"] == ["wire"]
    assert kernels["mxu/fused-stage2"] == ["stage2", "stage2_operator"]


def test_hw_parity_row_fails_on_the_card_without_its_kernel():
    """On a CUDA device a row passes only if its kernels launched."""
    before = hw_parity._launches()
    row = hw_parity._row("pallas", torch.device("cuda"), before, ("radix",),
                         {}, True)
    assert row["pass"] is False
    assert hw_parity._row("pallas", torch.device("cpu"), before, ("radix",),
                          {}, True)["pass"] is True


@pytest.mark.parametrize("tool", [hw_parity, wire_ab, decode_ab])
def test_tools_exit_2_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert e.value.code == 2


@pytest.mark.parametrize("tool", [wire_ab, decode_ab])
def test_ab_smoke_contract(tool, capsys):
    assert tool.main(["--smoke", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "error" not in out and out["device"] == "cpu"
    timed = {k: v for k, v in out.items()
             if isinstance(v, dict) and "us_per_sector" in v}
    want = ({"k_i16", "k_wire", "slice+k_wire", "view"} if tool is wire_ab
            else {"salt_only", "v0_current", "v1_byteslice",
                  "v2_bitcast_slice", "v3_flat", "k_wire"})
    assert set(timed) == want
    assert all(v["us_per_sector"] > 0 for v in timed.values())
    if tool is wire_ab:
        assert all(out["parity"]["bit_identical_at_salt_0"].values())
        assert out["parity"]["wire_vs_i16_rel_l2"] < wire_ab.PARITY_TOL
    else:
        assert out["parity"].startswith("bit-exact")


@pytest.mark.parametrize("tool", [wire_ab, decode_ab])
def test_ab_parity_miss_exits_1(tool, capsys, monkeypatch):
    from wrp_tpu_torch.ops import device_codec, fullchain

    if tool is wire_ab:
        real = fullchain.fused_chain_power_wire
        monkeypatch.setattr(fullchain, "fused_chain_power_wire",
                            lambda *a, **k: real(*a, **k) * 1.01)
    else:
        real = device_codec.decode_wire_i16
        monkeypatch.setattr(device_codec, "decode_wire_i16",
                            lambda *a, **k: real(*a, **k) ^ 1)
    assert tool.main(["--smoke", "--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert "parity failed" in out["error"]


@pytest.mark.parametrize("tool", [wire_ab, decode_ab])
def test_ab_exception_is_not_caught(tool, monkeypatch):
    """Unlike the JAX tools, whose catch-all records every exception as a
    skipped row, an exception ends the run: a non-zero exit."""
    from wrp_tpu_torch.ops import fullchain

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(fullchain, "fused_chain_power_wire", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tool.main(["--smoke", "--device", "cpu"])
