"""End-to-end demo on the card: UDP producer -> ingest -> the fused chain ->
UDP egress (v1x frames) -> an independent consumer's volume, which must
equal the processor's.

    python -m wrp_tpu_torch.tools.hw_demo [--device-decode] [SECTORS]
        [--out DIR] [--method pallas] [--rate R] [--device cuda]

Counterpart of the JAX package's ``tools/hw_demo.sh``, step for step:

1. `cli stream --transport udp --method pallas [--device-decode] --batch 16
   --timeout 10 --idle-limit 30 --checkpoint OUT/proc.npz
   --extended-results --max-sectors SECTORS --ready-file OUT/ready`, its
   stats in OUT/stream_stats.json (with `kernel_launches`: the radix kernel
   on host decode, the wire kernel with --device-decode);
2. `cli consume --volume OUT/rx.npz`;
3. the stream's ready file (a stream that dies in its warm-up: its stderr,
   exit 1);
4. `cli produce --transport udp --sectors SECTORS --headers`;
5. both processes waited for, then `cli volume OUT/proc.npz --render-all
   OUT/mosaic.ppm` and `cli volume OUT/rx.npz`;
6. their `zdb*`, `zdr*`, `sectors*`, `coverage*` and `elevations*` keys
   compared: `MATCH` and exit 0, or `MISMATCH on [...]` and exit 1.

SECTORS defaults to 286 (two cuts).  `--out` takes the place of the
script's WRP_DEMO_DIR (default: a fresh temporary directory; the demo's
own files in it are replaced), `--method` of WRP_DEMO_METHOD.  The stream
runs on `--device` (cuda by default); without CUDA and without `--device
cpu` the demo exits 2 before it starts anything.

Where it departs from the script:

* the ingest port and both result ports are free ports, passed to stream,
  consume and produce (the script's fixed defaults collide with any other
  user of those ports);
* consume asks for SECTORS zdb frames, one a sector: it counts zdb frames
  only, so the script's 2 x SECTORS was never reached and the script
  always waited out consume's 240 s;
* `--rate` paces the producer (default 0, unpaced, as the script);
* every wait is bounded, by WAIT_S (120 s): the ready file, the producer,
  the stream after the producer, each `cli volume`; and the consumer's,
  once the stream has ended, by CONSUME_GRACE_S (its frames are all
  sent).  A stream or consumer still running then gets SIGTERM, which
  both take as their graceful end (the volume so far is saved), and is
  killed TERM_GRACE_S later.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from ..parallel.launch import ROOT, free_port, module_env
from ._common import device_of

#: the keys of `cli volume`'s line that the two volumes must share
VOLUME_KEYS = ("zdb", "zdr", "sectors", "coverage", "elevations")
#: the demo's files in OUT (a stale ready file would start the producer
#: before the stream is up)
OUT_FILES = ("ready", "proc.npz", "rx.npz", "mosaic.ppm", "stream_stats.json",
             "stream.err", "consume_stats.json", "consume.err",
             "produce.err", "proc_volume.json", "rx_volume.json")
#: the longest wait for a step (and the consumer's rolling deadline, which
#: also spans the stream's warm-up)
WAIT_S = 120.0
#: the consumer's wait once the stream has ended: its frames are all sent
CONSUME_GRACE_S = 10.0
#: after SIGTERM, the wait before a kill
TERM_GRACE_S = 30.0


def verdict(proc: dict, rx: dict) -> tuple:
    """("MATCH", 0) when the consumer's volume summary equals the
    processor's on every key of VOLUME_KEYS in the processor's line, else
    ("MISMATCH on [keys]", 1)."""
    keys = [k for k in proc if k.startswith(VOLUME_KEYS)]
    bad = [k for k in keys if proc.get(k) != rx.get(k)]
    return ("MATCH", 0) if not bad else (f"MISMATCH on {bad}", 1)


def _cli(*argv) -> list:
    return [sys.executable, "-m", "wrp_tpu_torch.cli", *argv]


def _stop(proc: subprocess.Popen, wait_s: float) -> int:
    """proc's exit code, waiting at most wait_s, then SIGTERM (the graceful
    end of stream and consume) and TERM_GRACE_S more, then a kill."""
    try:
        return proc.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        pass
    print(f"pid {proc.pid} still running after {wait_s:.0f} s: SIGTERM",
          file=sys.stderr, flush=True)
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=TERM_GRACE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m wrp_tpu_torch.tools.hw_demo",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device-decode", action="store_true",
                    help="decode the wire on the device (the wire kernel) "
                         "instead of the host codec")
    ap.add_argument("sectors", nargs="?", type=int, default=286,
                    metavar="SECTORS")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="where the artifacts go (default: a fresh "
                         "temporary directory)")
    ap.add_argument("--method", default="pallas",
                    choices=["mxu", "parseval", "pallas", "radix", "fft"])
    ap.add_argument("--device", default="cuda",
                    help="the stream's device: cuda (default) or cpu")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="the producer's sectors/s cap (0: unpaced)")
    args = ap.parse_args(argv)
    if args.sectors < 1:
        ap.error("SECTORS must be at least 1")
    return ap, args


def main(argv=None) -> int:
    ap, args = _args(argv)
    device_of(ap, args.device)            # no CUDA, no --device cpu: exit 2
    out = args.out or tempfile.mkdtemp(prefix="wrp_hw_demo_")
    os.makedirs(out, exist_ok=True)
    for name in OUT_FILES:
        if os.path.exists(os.path.join(out, name)):
            os.remove(os.path.join(out, name))
    path = {name: os.path.join(out, name) for name in OUT_FILES}
    ingest, zdb, zdr = (free_port(socket.SOCK_DGRAM) for _ in range(3))
    env = module_env()
    files = []

    def start(argv, stdout, stderr):
        files.extend([open(stdout, "w"), open(stderr, "w")])
        return subprocess.Popen(argv, cwd=ROOT, env=env,
                                stdin=subprocess.DEVNULL, stdout=files[-2],
                                stderr=files[-1])

    stream = start(_cli(
        "stream", "--transport", "udp", "--method", args.method,
        *(["--device-decode"] if args.device_decode else []),
        "--batch", "16", "--timeout", "10", "--idle-limit", "30",
        "--checkpoint", path["proc.npz"], "--extended-results",
        "--max-sectors", str(args.sectors), "--ready-file", path["ready"],
        "--ingest-port", str(ingest), "--zdb-port", str(zdb),
        "--zdr-port", str(zdr), "--device", args.device),
        path["stream_stats.json"], path["stream.err"])
    consume = start(_cli(
        "consume", "--count", str(args.sectors), "--timeout", str(WAIT_S),
        "--volume", path["rx.npz"], "--port", str(zdb), "--zdr-port",
        str(zdr)), path["consume_stats.json"], path["consume.err"])
    try:
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(path["ready"]):
            if stream.poll() is not None or time.monotonic() > deadline:
                print("stream died during warmup" if stream.poll() is not None
                      else f"stream not ready after {WAIT_S:.0f} s",
                      file=sys.stderr)
                with open(path["stream.err"]) as f:
                    sys.stderr.write(f.read())
                return 1
            time.sleep(0.1)
        with open(path["produce.err"], "w") as err:
            produce = subprocess.run(_cli(
                "produce", "--transport", "udp", "--sectors",
                str(args.sectors), "--headers", "--ingest-port", str(ingest),
                "--rate", str(args.rate)), cwd=ROOT, env=env,
                stdin=subprocess.DEVNULL, stderr=err, timeout=WAIT_S)
        rc_s = _stop(stream, WAIT_S)
        rc_c = _stop(consume, CONSUME_GRACE_S)
    finally:
        for p in (stream, consume):
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    volumes = [subprocess.Popen(
        _cli("volume", path[f"{name}.npz"], *extra), cwd=ROOT, env=env,
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, extra in (("proc", ["--render-all", path["mosaic.ppm"]]),
                            ("rx", []))]
    outputs = []
    for v in volumes:
        try:
            outputs.append(v.communicate(timeout=WAIT_S))
        except subprocess.TimeoutExpired:
            v.kill()
            outputs.append(v.communicate())
    lines = []
    for name, v, (stdout, stderr) in zip(("proc", "rx"), volumes, outputs):
        with open(path[f"{name}_volume.json"], "w") as f:
            f.write(stdout)
        if v.returncode != 0 or not stdout.strip():
            print(f"cli volume {name}.npz: exit {v.returncode}\n{stderr}",
                  file=sys.stderr)
            return 1
        lines.append(stdout.strip().splitlines()[0])
    print(f"stream rc={rc_s} consume rc={rc_c} produce "
          f"rc={produce.returncode}  (artifacts in {out})")
    print(f"processor volume: {lines[0]}")
    print(f"consumer  volume: {lines[1]}")
    # the consumer's independently rebuilt volume must match the processor's
    text, rc = verdict(json.loads(lines[0]), json.loads(lines[1]))
    print(text, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
