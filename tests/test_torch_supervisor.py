"""The port's supervisor (wrp_tpu_torch/runtime/supervisor.py) and `cli
supervise`: the state-machine tests of tests/test_supervisor.py driven by
scripted fake workers, each on the port and, with the same fake spawn, on
wrp_tpu's Supervisor (equal event sequences and summaries; worker argv
equal apart from the module name and the port's `--device`); the CLI's
refusals; and real worker processes on the CPU: a 2-host gloo regroup
over UDP, an interrupted and resumed single host over TCP, and a single
host over ZMQ.  Ephemeral ports, one torch thread a worker, and a timeout
on every subprocess and every wait."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from conftest import cpu_subprocess_env

from wrp_tpu.runtime import supervisor as jsup
from wrp_tpu_torch import cli
from wrp_tpu_torch.config import DEFAULT_CONFIG
from wrp_tpu_torch.runtime import VolumeScan
from wrp_tpu_torch.runtime import supervisor as tsup

REPO = Path(__file__).resolve().parent.parent
IMPLS = {"port": tsup, "jax": jsup}


def _free_port(kind=socket.SOCK_STREAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# ---------------------------------------------------------------------------
# Scripted workers, and the same scenario on both packages.
# ---------------------------------------------------------------------------


class _FakeProc:
    """Scripted worker: 'die1' exits rc 1 at once (warmup crash);
    'ready_exit0' touches its ready file and exits 0 shortly after;
    'ready_die9' touches ready then dies as if SIGKILLed; 'ready_hang'
    / 'hang' run until the supervisor SIGTERMs them."""

    _next_pid = [90000]

    def __init__(self, plan, ready_file):
        self.plan = plan
        self.signals = []
        self._t0 = time.monotonic()
        self.pid = self._next_pid[0]
        self._next_pid[0] += 1
        if plan.startswith("ready"):
            ready_file.touch()

    def poll(self):
        dt = time.monotonic() - self._t0
        if self.plan == "die1":
            return 1
        if "SIGTERM" in self.signals:
            return 0
        if self.plan == "ready_exit0":
            return 0 if dt > 0.3 else None
        if self.plan == "ready_die9":
            return -9 if dt > 0.3 else None
        return None               # ready_hang / hang

    def send_signal(self, signo):
        self.signals.append("SIGTERM" if signo == signal.SIGTERM
                            else signo)

    def wait(self, timeout=None):
        deadline = time.monotonic() + (timeout or 5)
        while self.poll() is None:
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(self.plan, timeout)
            time.sleep(0.01)
        return self.poll()

    def kill(self):
        self.signals.append("KILL")
        self.plan = "die1"


def _extra(impl):
    return ["--device", "cpu"] if impl == "port" else []


def _fake_supervisor(tmp_path, impl, plans, hosts=2, nfeeds=2, **kw):
    """`impl`'s Supervisor whose spawn pops scripted plans in launch
    order; its files under tmp_path/impl."""
    mod = IMPLS[impl]
    root = tmp_path / impl
    root.mkdir(exist_ok=True)
    feeds = [mod.FeedSpec(port=20000 + i, checkpoint=root / f"f{i}.npz")
             for i in range(nfeeds)]
    spawned = []
    queue = list(plans)

    def spawn(host_id, argv, env, log_file):
        if "--host-id" in argv:
            assert host_id == int(argv[argv.index("--host-id") + 1])
        else:
            assert host_id == 0
        ready = Path(argv[argv.index("--ready-file") + 1])
        p = _FakeProc(queue.pop(0), ready)
        spawned.append((p, argv))
        return p

    kw.setdefault("extra_args", _extra(impl))
    sup = mod.Supervisor(feeds, hosts=hosts, poll_s=0.02, spawn=spawn,
                         state_file=root / "state.jsonl", **kw)
    return sup, spawned


def _norm_events(events):
    """Events without wall times, pids and paths; a coordinator or a PUB
    endpoint as present/absent (their ports are fresh each run)."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k != "t"}
        if e["event"] == "launch":
            e["coordinator"] = e["coordinator"] is not None
            e["workers"] = [{"host_id": w["host_id"], "feeds": w["feeds"],
                             "zmq_pub": w["zmq_pub"] is not None}
                            for w in e["workers"]]
        out.append(e)
    return out


def _norm_argv(argv, root):
    """A worker's argv with the module name, the port's --device, the
    scenario's directory, the ready files' temp directory and fresh ports
    taken out."""
    a = list(argv)
    a[a.index("-m") + 1] = "MODULE"
    if "--device" in a:
        i = a.index("--device")
        del a[i:i + 2]
    out = []
    for x in a:
        x = x.replace(str(root), "ROOT")
        if "wrp_supervise_" in x:
            x = "READY/" + Path(x).name
        out.append(re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT", x))
    return out


def _run_both(tmp_path, plans, **kw):
    """The scenario on the port and on wrp_tpu: equal summaries, event
    sequences and (normalised) worker argv; returns the port's
    (supervisor, spawned, summary)."""
    got = {}
    for impl in IMPLS:
        sup, spawned = _fake_supervisor(tmp_path, impl, plans, **kw)
        got[impl] = (sup, spawned, sup.run())
    (psup, pspawn, pout), (jsup_, jspawn, jout) = got["port"], got["jax"]
    assert pout == jout
    assert _norm_events(psup._events) == _norm_events(jsup_._events)
    assert ([_norm_argv(a, tmp_path / "port") for _, a in pspawn]
            == [_norm_argv(a, tmp_path / "jax") for _, a in jspawn])
    for _, a in pspawn:
        assert a[a.index("-m") + 1] == "wrp_tpu_torch.cli"
        assert a[a.index("--device") + 1] == "cpu"
    for _, a in jspawn:
        assert a[a.index("-m") + 1] == "wrp_tpu.cli"
    return got["port"]


def _kinds(sup):
    return [e["event"] for e in sup._events]


def _launch(sup, generation):
    return [e for e in sup._events
            if e["event"] == "launch" and e["generation"] == generation][0]


# ---------------------------------------------------------------------------
# The state machine.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_assign_round_robin(impl):
    mod = IMPLS[impl]
    feeds = [mod.FeedSpec(port=1000 + i, checkpoint=Path(f"/f{i}"))
             for i in range(5)]
    sup = mod.Supervisor(feeds, hosts=2)
    shares = sup._assign(2)
    assert [[f.port for f in s] for s in shares] == [[1000, 1002, 1004],
                                                     [1001, 1003]]
    # a host with nothing to ingest would starve a lock-step group
    with pytest.raises(ValueError, match="hosts but only"):
        mod.Supervisor(feeds[:1], hosts=2)


def test_warmup_death_retries_same_host_count(tmp_path):
    """A crash BEFORE the generation is ready is infra flake: relaunch
    with the SAME host count (no accepted work was lost)."""
    sup, spawned, out = _run_both(
        tmp_path, ["ready_hang", "die1", "ready_exit0", "ready_exit0"])
    assert out["ok"] and out["reason"] == "workers_done"
    assert out["generations"] == 2
    assert "warmup_retry" in _kinds(sup) and "regroup" not in _kinds(sup)
    assert len(_launch(sup, 1)["workers"]) == 2
    assert "SIGTERM" in spawned[0][0].signals      # no orphans


def test_postready_death_shrinks_and_folds_feeds(tmp_path):
    sup, _, out = _run_both(tmp_path,
                            ["ready_hang", "ready_die9", "ready_exit0"])
    assert out["ok"] and out["generations"] == 2
    regroup = [e for e in sup._events if e["event"] == "regroup"][0]
    assert regroup["to_hosts"] == 1 and regroup["dead"] == [1]
    launch1 = _launch(sup, 1)
    assert len(launch1["workers"]) == 1
    assert sorted(launch1["workers"][0]["feeds"]) == [20000, 20001]
    assert launch1["coordinator"] is None         # 1 host: no group


def test_regrow_probes_back_up_after_shrink(tmp_path):
    """After a post-ready death shrinks 2 -> 1, a healthy window triggers
    a growth probe back to 2 hosts, which runs to completion."""
    sup, _, out = _run_both(
        tmp_path, ["ready_hang", "ready_die9", "ready_hang",
                   "ready_exit0", "ready_exit0"], regrow_after_s=0.4)
    assert out["ok"] and out["reason"] == "workers_done"
    assert out["generations"] == 3
    assert "regroup" in _kinds(sup) and "grow" in _kinds(sup)
    launch2 = _launch(sup, 2)
    assert len(launch2["workers"]) == 2
    assert launch2["coordinator"] is not None
    assert sorted(len(w["feeds"]) for w in launch2["workers"]) == [1, 1]


def test_regrow_failed_probe_falls_back(tmp_path):
    """A growth probe that dies during warmup falls back to the proven
    host count, not a warmup retry at the grown size."""
    sup, _, out = _run_both(
        tmp_path, ["ready_hang", "ready_die9", "ready_hang",
                   "ready_hang", "die1", "ready_exit0"], regrow_after_s=0.4)
    assert out["ok"] and out["generations"] == 4
    failed = [e for e in sup._events if e["event"] == "grow_failed"][0]
    assert failed["back_to_hosts"] == 1
    assert "warmup_retry" not in _kinds(sup)
    assert len(_launch(sup, 3)["workers"]) == 1


@pytest.mark.parametrize("max_generations", [2, 3])
def test_grow_budgets_probe_and_fallback(tmp_path, max_generations):
    """Growth never spends the last generation, and leaves room for the
    probe AND its warmup-death fallback: with 2 or 3 generations no probe
    fires and the shrunk fleet runs to completion."""
    sup, _, out = _run_both(
        tmp_path, ["ready_hang", "ready_die9", "ready_exit0"],
        regrow_after_s=0.05, max_generations=max_generations)
    assert out["ok"] and out["reason"] == "workers_done"
    assert "grow" not in _kinds(sup)


def test_ready_timeout_fails_loudly_and_stops_the_fleet(tmp_path):
    sup, spawned, out = _run_both(tmp_path, ["hang", "hang"],
                                  ready_timeout_s=0.5)
    assert not out["ok"] and out["reason"] == "ready_timeout"
    for p, _ in spawned:
        assert "SIGTERM" in p.signals


def test_max_generations_bounds_the_crash_loop(tmp_path):
    _, _, out = _run_both(tmp_path, ["ready_hang", "die1"],
                          max_generations=1)
    assert not out["ok"] and out["reason"] == "max_generations"
    assert out["generations"] == 1


def test_workers_done_still_emits_stopped_event(tmp_path):
    sup, _, out = _run_both(tmp_path, ["ready_exit0", "ready_exit0"])
    assert out["ok"] and out["reason"] == "workers_done"
    assert _kinds(sup)[-2:] == ["stopped", "done"]


@pytest.mark.parametrize("impl", IMPLS)
def test_midspawn_failure_stops_started_workers(tmp_path, impl):
    """A spawn that raises mid-generation must not orphan the workers
    already started."""
    mod = IMPLS[impl]
    feeds = [mod.FeedSpec(port=20000 + i, checkpoint=tmp_path / f"f{i}.npz")
             for i in range(2)]
    spawned = []

    def spawn(host_id, argv, env, log_file):
        if spawned:
            raise OSError("ENOMEM")
        p = _FakeProc("ready_hang", Path(argv[argv.index("--ready-file") + 1]))
        spawned.append(p)
        return p

    sup = mod.Supervisor(feeds, hosts=2, poll_s=0.02, spawn=spawn,
                         extra_args=_extra(impl))
    with pytest.raises(OSError):
        sup.run()
    assert "SIGTERM" in spawned[0].signals


@pytest.mark.parametrize("impl", IMPLS)
def test_interrupt_stops_fleet_before_reporting(tmp_path, impl):
    """SIGTERM/Ctrl-C: the fleet is drained BEFORE the summary reads
    coverage; the state file ends stopped(interrupted), done."""
    sup, spawned = _fake_supervisor(tmp_path, impl,
                                    ["ready_hang", "ready_hang"])

    def interrupted_monitor(workers, hosts):
        raise KeyboardInterrupt

    sup._monitor = interrupted_monitor
    out = sup.run()
    assert not out["ok"] and out["reason"] == "interrupted"
    for p, _ in spawned:
        assert "SIGTERM" in p.signals
    assert _kinds(sup)[-2:] == ["stopped", "done"]
    assert sup._events[-2]["why"] == "interrupted"


class _RemoteHandle:
    """A worker 'on a remote machine': ONLY the Popen surface the launcher
    contract names; ready after the machine's launch latency."""

    _next_pid = [70000]

    def __init__(self, machine, ready_file, delay_s):
        self.machine = machine
        self._ready_file = ready_file
        self._ready_at = time.monotonic() + delay_s
        self._rc = None
        self.signals = []
        self.pid = self._next_pid[0]
        self._next_pid[0] += 1

    def poll(self):
        if self._rc is None and "SIGTERM" in self.signals:
            self._rc = 0
        if self._rc is None and time.monotonic() >= self._ready_at:
            self._ready_file.touch()
        return self._rc

    def finish(self, rc=0):
        self._rc = rc

    def send_signal(self, signo):
        self.signals.append("SIGTERM" if signo == signal.SIGTERM
                            else signo)

    def wait(self, timeout=None):
        deadline = time.monotonic() + (timeout or 5)
        while self.poll() is None:
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("remote", timeout)
            time.sleep(0.01)
        return self._rc

    def kill(self):
        self.signals.append("KILL")
        self._rc = -9


class _RemoteFleet:
    """Named machines, rank -> machine placement keyed on host_id, launch
    latency, and whole-machine loss."""

    def __init__(self, machines, launch_delay_s=0.2):
        self.machines = list(machines)
        self.delay_s = launch_delay_s
        self.placements = []
        self.handles = []

    def spawn(self, host_id, argv, env, log_file):
        machine = self.machines[host_id % len(self.machines)]
        h = _RemoteHandle(machine, Path(argv[argv.index("--ready-file") + 1]),
                          self.delay_s)
        self.placements.append((host_id, machine))
        self.handles.append(h)
        return h

    def lose_machine(self, name):
        self.machines.remove(name)
        for h in self.handles:
            if h.machine == name and h.poll() is None:
                h.finish(rc=-9)


@pytest.mark.parametrize("impl", IMPLS)
def test_remote_launcher_full_regroup(tmp_path, impl):
    """The launcher seam drives a full regroup: two remote machines, one
    lost after ready, generation 1 relaunched through the same launcher on
    the survivor with the dead rank's feeds folded in; the supervisor
    touches workers only through the handles."""
    mod = IMPLS[impl]
    feeds = [mod.FeedSpec(port=21000 + i, checkpoint=tmp_path / f"rf{i}.npz")
             for i in range(2)]
    fleet = _RemoteFleet(["gpu-a", "gpu-b"], launch_delay_s=0.25)
    sup = mod.Supervisor(feeds, hosts=2, poll_s=0.02, spawn=fleet.spawn,
                         extra_args=_extra(impl))
    errors = []

    def script():
        try:
            deadline = time.monotonic() + 30
            while not (len(fleet.handles) == 2 and all(
                    h._ready_file.exists() for h in fleet.handles)):
                assert time.monotonic() < deadline
                time.sleep(0.02)
            fleet.lose_machine("gpu-b")
            while len(fleet.handles) < 3 or not (
                    fleet.handles[2]._ready_file.exists()):
                assert time.monotonic() < deadline
                time.sleep(0.02)
            fleet.handles[2].finish(rc=0)
        except AssertionError as e:
            errors.append(e)

    driver = threading.Thread(target=script)
    driver.start()
    out = sup.run()
    driver.join(timeout=30)
    assert not driver.is_alive() and not errors
    assert out["ok"] and out["reason"] == "workers_done"
    assert out["generations"] == 2
    assert fleet.placements == [(0, "gpu-a"), (1, "gpu-b"), (0, "gpu-a")]
    evs = {e["event"]: e for e in sup._events}
    assert evs["regroup"]["to_hosts"] == 1
    assert evs["host_death"]["rc"] == -9
    assert sorted(_launch(sup, 1)["workers"][0]["feeds"]) == [21000, 21001]
    launches = [e for e in sup._events if e["event"] == "launch"]
    readies = [e for e in sup._events if e["event"] == "ready"]
    assert all(r["t"] - l["t"] >= 0.2 for l, r in zip(launches, readies))
    assert "SIGTERM" in fleet.handles[0].signals


@pytest.mark.parametrize("impl", IMPLS)
def test_supervisor_refusals(tmp_path, impl):
    """Duplicate feed ports or checkpoints, a non-positive regrow window,
    and a feed of the wrong kind for the transport."""
    mod = IMPLS[impl]
    f = mod.FeedSpec
    with pytest.raises(ValueError, match="duplicate feed ports"):
        mod.Supervisor([f(port=1, checkpoint=tmp_path / "a.npz"),
                        f(port=1, checkpoint=tmp_path / "b.npz")], hosts=1)
    with pytest.raises(ValueError, match="duplicate feed checkpoints"):
        mod.Supervisor([f(port=1, checkpoint=tmp_path / "a.npz"),
                        f(port=2, checkpoint=tmp_path / "a.npz")], hosts=1)
    with pytest.raises(ValueError, match="regrow_after_s"):
        mod.Supervisor([f(port=1, checkpoint=tmp_path / "a.npz")], hosts=1,
                       regrow_after_s=0.0)
    with pytest.raises(ValueError, match="endpoint="):
        mod.Supervisor([f(port=1, checkpoint=tmp_path / "a.npz")], hosts=1,
                       transport="zmq")
    with pytest.raises(ValueError, match="need port="):
        mod.Supervisor([f(port=None, endpoint="tcp://127.0.0.1:1",
                          checkpoint=tmp_path / "a.npz")], hosts=1,
                       transport="tcp")


@pytest.mark.parametrize("impl", IMPLS)
def test_state_file_truncated_per_run(tmp_path, impl):
    mod = IMPLS[impl]
    state = tmp_path / "state.jsonl"
    state.write_text('{"event": "done", "generation": 0}\n')   # stale run
    mod.Supervisor([mod.FeedSpec(port=1, checkpoint=tmp_path / "a.npz")],
                   hosts=1, state_file=state)
    assert state.read_text() == ""


@pytest.mark.parametrize("transport", ["udp", "tcp", "zmq"])
def test_worker_argv_equal_to_wrp_tpu(tmp_path, transport):
    """The worker command of every transport, 1 and 2 hosts: wrp_tpu's
    argv with the port's module and the passed --device (pallas, device
    decode and the result ports ride along)."""
    argvs = {}
    for impl, mod in IMPLS.items():
        root = tmp_path / impl
        if transport == "zmq":
            feeds = [mod.FeedSpec(port=None, endpoint=f"tcp://127.0.0.1:{p}",
                                  checkpoint=root / f"f{p}.npz")
                     for p in (5001, 5002)]
        else:
            feeds = [mod.FeedSpec(port=p, checkpoint=root / f"f{p}.npz")
                     for p in (5001, 5002)]
        sup = mod.Supervisor(feeds, hosts=2, transport=transport,
                             method="pallas", zdb_port=7001, zdr_port=7002,
                             result_port=7003,
                             extra_args=_extra(impl) + ["--device-decode"])
        argvs[impl] = [
            _norm_argv(sup._worker_argv(h, hosts, sup._assign(hosts)[h],
                                        root / "ready", coord), root)
            for hosts, coord in ((1, None), (2, "127.0.0.1:1234"))
            for h in range(hosts)]
    assert argvs["port"] == argvs["jax"]
    one = argvs["port"][0]
    assert one[one.index("--transport") + 1] == transport
    assert "--device-decode" in one and "pallas" in one


def test_pulse_shard_mode_validation(tmp_path):
    def f(i):
        return tsup.FeedSpec(port=22000 + i, checkpoint=tmp_path / f"w{i}.npz")

    with pytest.raises(ValueError, match="exactly one"):
        tsup.Supervisor([f(0), f(1)], hosts=2, pulse_shard=True)
    with pytest.raises(ValueError, match="fan-out"):
        tsup.Supervisor([f(0)], hosts=2, transport="tcp", pulse_shard=True)
    with pytest.raises(ValueError, match="mxu, fft"):
        tsup.Supervisor([f(0)], hosts=2, method="parseval", pulse_shard=True)
    tsup.Supervisor([f(0)], hosts=2, method="pallas", pulse_shard=True)
    tsup.Supervisor([f(0)], hosts=3, pulse_shard=True)


def test_pulse_shard_fleet_shape_and_shrink(tmp_path):
    """Redundant fleet: every worker ingests the one broadcast wire, runs
    --pulse-shard and keeps its own slot copy of the volume; a post-ready
    death shrinks to a plain 1-host stream on the same wire."""
    sup, spawned, out = _run_both(
        tmp_path, ["ready_hang", "ready_die9", "ready_exit0"], nfeeds=1,
        pulse_shard=True)
    assert out["ok"] and out["generations"] == 2
    a0, a1, a2 = (a for _, a in spawned)
    for a in (a0, a1):
        assert "--pulse-shard" in a and "--coordinator" in a
        assert a[a.index("--ingest-port") + 1] == "20000"
        assert "--feed-checkpoint" not in a
    assert a0[a0.index("--checkpoint") + 1].endswith("f0.h0.npz")
    assert a1[a1.index("--checkpoint") + 1].endswith("f0.h1.npz")
    assert "--pulse-shard" not in a2 and "--coordinator" not in a2
    assert a2[a2.index("--checkpoint") + 1].endswith("f0.h0.npz")


def test_pulse_shard_checkpoint_seeding_and_coverage(tmp_path):
    """Each generation's slots start from the FRESHEST surviving copy,
    and the feed's coverage is the max over slots."""
    feeds = [tsup.FeedSpec(port=22200, checkpoint=tmp_path / "wire.npz")]
    sup = tsup.Supervisor(feeds, hosts=3, pulse_shard=True,
                          spawn=lambda *a: 0)
    zeros = np.zeros(512, np.float32)
    stale = VolumeScan(DEFAULT_CONFIG, sup._host_ckpt(0))
    stale.store(0, 0, zeros, zeros)
    stale.save()
    time.sleep(0.05)                 # distinct mtimes
    fresh = VolumeScan(DEFAULT_CONFIG, sup._host_ckpt(2))
    for s in range(3):
        fresh.store(s, 0, zeros, zeros)
    fresh.save()
    assert sup._feed_coverage(feeds[0]) == 3
    sup._seed_host_ckpts(hosts=2)
    for k in range(2):
        assert int(VolumeScan.load(
            str(sup._host_ckpt(k))).coverage.sum()) == 3


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv, message", [
    (["--transport", "zmq", "--feed-endpoint", "tcp://127.0.0.1:5563",
      "--feed-port", "9001"], "udp and tcp transports only"),
    (["--transport", "udp", "--feed-port", "9001",
      "--feed-endpoint", "tcp://127.0.0.1:5563"], "zmq transport only"),
    (["--transport", "zmq"], "--feed-endpoint"),
    (["--transport", "tcp"], "--feed-port"),
    (["--feed-port", "9000", "--device-decode"], "--method pallas"),
    (["--feed-port", "9000", "--feed-port", "9000"], "duplicate feed ports"),
    (["--feed-port", "9000", "--hosts", "2"], "hosts but only"),
], ids=["port-with-zmq", "endpoint-with-udp", "zmq-without-endpoint",
        "tcp-without-port", "device-decode-mxu", "duplicate-port",
        "hosts-over-feeds"])
def test_supervise_refusals(tmp_path, capsys, argv, message):
    """Exit 2, before any worker starts."""
    rc = cli.main(["supervise", "--checkpoint-dir", str(tmp_path / "ck"),
                   *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


def test_feed_checkpoint_count_mismatch_is_an_error(tmp_path, capsys):
    rc = cli.main(["stream", "--device", "cpu", "--transport", "tcp",
                   "--feed-port", "9000", "--feed-port", "9001",
                   "--feed-checkpoint", str(tmp_path / "only-one.npz")])
    assert rc == 2
    assert "one path per --feed-port" in capsys.readouterr().err


@pytest.mark.parametrize("ok, rc", [(True, 0), (False, 4)])
def test_supervise_passes_device_and_exit_code(tmp_path, monkeypatch,
                                               capsys, ok, rc):
    """The workers get --device (with the other worker flags) from the
    supervise command; a summary that is not ok exits 4.  Zmq checkpoint
    names derive from the sanitised endpoint."""
    seen = {}

    def fake_run(self):
        seen["sup"] = self
        return {"ok": ok, "reason": "target" if ok else "exhausted",
                "generations": 1, "coverage": {}}

    monkeypatch.setattr(tsup.Supervisor, "run", fake_run)
    assert cli.main(["supervise", "--device", "cuda:1", "--transport", "zmq",
                     "--feed-endpoint", "tcp://127.0.0.1:5563",
                     "--method", "pallas", "--device-decode",
                     "--channels", "2", "--checkpoint-dir",
                     str(tmp_path / "ck")]) == rc
    assert json.loads(capsys.readouterr().out)["ok"] is ok
    sup = seen["sup"]
    argv = sup._worker_argv(0, 1, sup.feeds, tmp_path / "r", None)
    assert argv[argv.index("--device") + 1] == "cuda:1"
    assert "--device-decode" in argv
    assert argv[argv.index("--channels") + 1] == "2"
    assert [f.checkpoint.name for f in sup.feeds] == [
        "feed-tcp-127.0.0.1-5563.npz"]


# ---------------------------------------------------------------------------
# Real worker processes on the CPU.
# ---------------------------------------------------------------------------


def _env():
    # one torch thread a process: the suite runs beside CPU-time floors
    return cpu_subprocess_env(OMP_NUM_THREADS="1")


def _events(state):
    if not state.exists():
        return []
    out = []
    for line in state.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass  # mid-write tail
    return out


def _await_event(state, sup, pred, what, timeout=180):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        evs = [e for e in _events(state) if pred(e)]
        if evs:
            return evs[-1]
        assert sup.poll() is None, (what, sup.poll(),
                                    sup.communicate()[1][-3000:])
        time.sleep(0.25)
    raise AssertionError(f"never saw event: {what}; got "
                         f"{[e['event'] for e in _events(state)]}")


def _coverage(path):
    try:
        return int(VolumeScan.load(str(path)).coverage.sum())
    except Exception:
        return 0


def _await_coverage(paths, n, sup, timeout=120):
    deadline = time.monotonic() + timeout
    while any(_coverage(p) < n for p in paths):
        assert time.monotonic() < deadline, [_coverage(p) for p in paths]
        assert sup.poll() is None
        time.sleep(0.25)


def _supervise(args, state):
    return subprocess.Popen(
        [sys.executable, "-m", "wrp_tpu_torch.cli", "supervise",
         "--device", "cpu", "--batch", "2", "--timeout", "5",
         "--state-file", str(state), *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())


def _produce(transport, target, sectors, start=0):
    where = (["--zmq-bind", target, "--connect-delay", "1"]
             if transport == "zmq" else ["--ingest-port", str(target)])
    subprocess.run(
        [sys.executable, "-m", "wrp_tpu_torch.cli", "produce",
         "--transport", transport, *where, "--sectors", str(sectors),
         "--start-sector", str(start), "--headers", "--rate", "4"],
        cwd=REPO, check=True, capture_output=True, timeout=120, env=_env())


def _reap(sup, state):
    """Never orphan a worker: kill the supervisor, then every launched
    worker by its exact pid."""
    if sup.poll() is None:
        sup.kill()
        sup.wait(timeout=30)
    for ev in _events(state):
        if ev["event"] == "launch":
            for w in ev["workers"]:
                try:
                    os.kill(w["pid"], signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass


def _finish(sup, timeout=180):
    out, err = sup.communicate(timeout=timeout)
    return sup.returncode, json.loads(out), err


def test_supervise_two_host_gloo_regroup_over_udp(tmp_path):
    """2 hosts x 1 feed in a gloo group -> SIGKILL the host of feed p1
    after ready -> the supervisor regroups to 1 host x 2 feeds -> both
    feeds reach the target from their checkpoints, exit 0."""
    p0, p1 = _free_port(socket.SOCK_DGRAM), _free_port(socket.SOCK_DGRAM)
    state, ckdir = tmp_path / "state.jsonl", tmp_path / "ck"
    sup = _supervise(
        ["--feed-port", str(p0), "--feed-port", str(p1),
         "--checkpoint-dir", str(ckdir), "--target-sectors", "4",
         "--collective-timeout", "15",
         "--zdb-port", str(_free_port(socket.SOCK_DGRAM)),
         "--zdr-port", str(_free_port(socket.SOCK_DGRAM))], state)
    try:
        launch0 = _await_event(state, sup, lambda e: e["event"] == "launch"
                               and e["generation"] == 0, "gen-0 launch")
        assert [w["feeds"] for w in launch0["workers"]] == [[p0], [p1]]
        assert launch0["coordinator"] is not None
        _await_event(state, sup, lambda e: e["event"] == "ready"
                     and e["generation"] == 0, "gen-0 ready")
        for port in (p0, p1):
            _produce("udp", port, 2)
        ck = [ckdir / f"feed{p}.npz" for p in (p0, p1)]
        _await_coverage(ck, 2, sup)
        victim = next(w for w in launch0["workers"] if w["feeds"] == [p1])
        os.kill(victim["pid"], signal.SIGKILL)
        regroup = _await_event(state, sup, lambda e: e["event"] == "regroup",
                               "regroup")
        assert regroup["to_hosts"] == 1 and regroup["dead"] == [1]
        launch1 = _await_event(state, sup, lambda e: e["event"] == "launch"
                               and e["generation"] == 1, "gen-1 launch")
        assert [sorted(w["feeds"]) for w in launch1["workers"]] == [
            sorted([p0, p1])]
        assert launch1["coordinator"] is None
        _await_event(state, sup, lambda e: e["event"] == "ready"
                     and e["generation"] == 1, "gen-1 ready")
        for port in (p0, p1):
            _produce("udp", port, 2, start=2)
        rc, summary, err = _finish(sup)
        assert rc == 0, err[-3000:]
        assert summary["ok"] and summary["reason"] == "target"
        assert summary["generations"] == 2
        assert summary["coverage"] == {str(p0): 4, str(p1): 4}
        assert _events(state)[-1]["event"] == "done"
    finally:
        _reap(sup, state)


def test_supervise_tcp_interrupt_then_resume(tmp_path):
    """One host, two TCP feeds: SIGTERM after both checkpoints hold 2
    sectors -> exit 4, reason interrupted, checkpoints on disk; the same
    command relaunched (rebinding the feed ports) resumes from them and
    reaches the target with the next sectors, exit 0 — the one-card form
    of a regroup."""
    p0, p1 = _free_port(), _free_port()
    state, ckdir = tmp_path / "state.jsonl", tmp_path / "ck"
    args = ["--transport", "tcp", "--hosts", "1",
            "--feed-port", str(p0), "--feed-port", str(p1),
            "--checkpoint-dir", str(ckdir), "--target-sectors", "4",
            "--result-port", str(_free_port())]
    ck = [ckdir / f"feed{p}.npz" for p in (p0, p1)]
    sup = _supervise(args, state)
    try:
        _await_event(state, sup, lambda e: e["event"] == "ready", "ready")
        for port in (p0, p1):
            _produce("tcp", port, 2)
        _await_coverage(ck, 2, sup)
        sup.send_signal(signal.SIGTERM)
        rc, summary, err = _finish(sup, timeout=90)
        assert rc == 4, err[-3000:]
        assert summary["reason"] == "interrupted"
        assert summary["coverage"] == {str(p0): 2, str(p1): 2}
        assert [_coverage(p) for p in ck] == [2, 2]
    finally:
        _reap(sup, state)
    state.unlink()           # never read the first run's "ready" as the second's
    sup = _supervise(args, state)
    try:
        _await_event(state, sup, lambda e: e["event"] == "ready", "ready")
        for port in (p0, p1):
            _produce("tcp", port, 2, start=2)
        rc, summary, err = _finish(sup)
        assert rc == 0, err[-3000:]
        assert summary["ok"] and summary["reason"] == "target"
        assert summary["coverage"] == {str(p0): 4, str(p1): 4}
        for p in ck:
            vol = VolumeScan.load(p)
            assert vol.coverage[:4, 0].all()
            assert np.isfinite(vol.data[:, 1:, :4, 0]).all()
    finally:
        _reap(sup, state)


def test_supervise_zmq_feeds(tmp_path):
    """Supervised v2 wire: feeds are endpoints the worker's SUB sockets
    connect to; `produce --headers` labels the sectors; checkpoints are
    named by the sanitised endpoint."""
    pytest.importorskip("zmq")
    e0, e1 = (f"tcp://127.0.0.1:{_free_port()}" for _ in range(2))
    state, ckdir = tmp_path / "state.jsonl", tmp_path / "ck"
    sup = _supervise(["--transport", "zmq", "--hosts", "1",
                      "--feed-endpoint", e0, "--feed-endpoint", e1,
                      "--checkpoint-dir", str(ckdir),
                      "--target-sectors", "2"], state)
    try:
        launch0 = _await_event(state, sup, lambda e: e["event"] == "launch",
                               "launch")
        assert launch0["workers"][0]["feeds"] == [e0, e1]
        assert launch0["workers"][0]["zmq_pub"]
        _await_event(state, sup, lambda e: e["event"] == "ready", "ready")
        for endpoint in (e0, e1):
            _produce("zmq", endpoint, 2)
        rc, summary, err = _finish(sup)
        assert rc == 0, err[-3000:]
        assert summary["ok"] and summary["coverage"] == {e0: 2, e1: 2}
        assert len(list(ckdir.glob("feed-tcp-127.0.0.1-*.npz"))) == 2
    finally:
        _reap(sup, state)
