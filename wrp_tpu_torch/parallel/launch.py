"""The ranks of one host as processes: N copies of a command, each told its
rank and a rendezvous port, waited for together and stopped together.

    results = run_ranks(lambda rank, port: [sys.executable, "-m", "x",
                                            "--rank", str(rank),
                                            "--port", str(port)],
                        n=4, timeout_s=600)

The port is found by binding port 0 and closing the socket; rank 0 binds it
again when it starts the group's store, and another process may take it in
between.  So when a rank reports that the store could not bind
(EADDRINUSE), the whole set runs once more on a fresh port.  Any other
failure is returned as it is.

A rank ends through `end_rank(code)`: a barrier with a timeout, a flush,
the group's teardown under a hard-exit timer, then `os._exit(code)`.  The
interpreter's own exit is never reached with a process group behind it:
its static destructors can abort the process ("terminate called without an
active exception") after the rank's work is done.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, NoReturn, Optional, Sequence

#: a rank's stderr when the rendezvous store could not bind its port
BIND_FAILURE = re.compile(r"EADDRINUSE|address already in use", re.I)

#: the directory that holds the wrp_tpu_torch package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def module_env() -> dict:
    """This process's environment with ROOT first on PYTHONPATH, so a rank
    started as `python -m wrp_tpu_torch...` imports this package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


@dataclasses.dataclass
class RankResult:
    rank: int
    rc: int          # 124: the rank was stopped at the time limit
    out: str
    err: str


def free_port(kind: int = socket.SOCK_STREAM) -> int:
    """A port that was free on 127.0.0.1 a moment ago: TCP, or UDP with
    kind=socket.SOCK_DGRAM."""
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_once(argv_of, n, timeout_s, env, cwd, grace_s) -> List[RankResult]:
    port = free_port()
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in range(n)]
    procs = []
    try:
        for k in range(n):
            procs.append(subprocess.Popen(
                argv_of(k, port), cwd=cwd, env=env, stdin=subprocess.DEVNULL,
                stdout=files[k][0], stderr=files[k][1], text=True))
        deadline = time.monotonic() + timeout_s
        stopped = set()
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                break
            if any(rc not in (None, 0) for rc in rcs):
                # a failed rank leaves its peers blocked in a collective
                deadline = min(deadline, time.monotonic() + grace_s)
            if time.monotonic() >= deadline:
                for k, p in enumerate(procs):
                    if p.poll() is None:
                        p.kill()
                        stopped.add(k)
                for p in procs:
                    p.wait(timeout=30)
                break
            time.sleep(0.05)
        results = []
        for k, (p, (fo, fe)) in enumerate(zip(procs, files)):
            fo.seek(0)
            fe.seek(0)
            results.append(RankResult(k, 124 if k in stopped else p.returncode,
                                      fo.read(), fe.read()))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for fo, fe in files:
            fo.close()
            fe.close()


def leave_group(timeout_s: float = 30.0, code_on_hang: int = 1) -> None:
    """Leave the process group within a bound, for a process that goes on
    after it: a barrier that waits at most `timeout_s` for the peers (a
    dead or late peer is passed over), a flush of stdout and stderr, then
    `destroy_process_group` under a timer that ends the process with
    `code_on_hang` if the barrier and the teardown together block for
    2 x `timeout_s` (a dead peer can leave either waiting).  Does nothing
    outside a group."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    sys.stdout.flush()
    sys.stderr.flush()
    timer = threading.Timer(2 * timeout_s, lambda: os._exit(code_on_hang))
    timer.daemon = True
    timer.start()
    try:
        kw = {}
        if dist.get_backend() == "nccl":
            kw["device_ids"] = [torch.cuda.current_device()]
        dist.barrier(async_op=True, **kw).wait(
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:   # a gone peer: tear down all the same
        print(f"end of rank: barrier failed ({type(e).__name__}: {e})",
              file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        dist.destroy_process_group()
    except Exception as e:
        print(f"end of rank: teardown failed ({type(e).__name__}: {e})",
              file=sys.stderr, flush=True)
    timer.cancel()


def end_rank(code: int = 0, timeout_s: float = 30.0) -> NoReturn:
    """The one way a rank process ends: `leave_group(timeout_s)`, then
    `os._exit(code)`, so the interpreter's exit never runs with the group's
    threads behind it.  A teardown that blocks ends the process with `code`
    all the same: the rank's work was done.  Never returns."""
    leave_group(timeout_s, code_on_hang=code)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def run_ranks(argv_of: Callable[[int, int], Sequence[str]], n: int,
              timeout_s: float, env: Optional[dict] = None,
              cwd: Optional[str] = None,
              grace_s: float = 30.0) -> List[RankResult]:
    """Run `argv_of(rank, port)` for ranks 0..n-1 at once and wait for all:
    at most `timeout_s` in all, and `grace_s` after the first rank that
    fails; ranks still running then are killed (rc 124).  Reruns the set
    once on a fresh port when a rank's stderr shows the rendezvous could
    not bind its port."""
    results = _run_once(argv_of, n, timeout_s, env, cwd, grace_s)
    if any(r.rc != 0 and BIND_FAILURE.search(r.err) for r in results):
        results = _run_once(argv_of, n, timeout_s, env, cwd, grace_s)
    return results
