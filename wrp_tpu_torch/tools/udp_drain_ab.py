#!/usr/bin/env python3
"""A/B of the UDP receive with and without its native drain, on the host.

    python3 -m wrp_tpu_torch.tools.udp_drain_ab [--sectors 40]
        [--hold-ms 80] [--rcvbuf 4194304] [--turns drain,socket,socket,drain]

Each turn receives one stream of `--sectors` sectors (DEFAULT_CONFIG, the
extended headers) sent by a `cli produce` process at a radar's 21.45
sectors/s over loopback, while this process's main thread holds the GIL for
`--hold-ms` every 200 ms (a `usleep` through `ctypes.PyDLL`, which keeps
it), as a busy compute thread can.  `drain`: `UdpIngest(native=True)`, the
socket drained by a native thread into a ring of `--rcvbuf` bytes.
`socket`: the same reassembly reading the socket itself
(`ingest_native.recv_sector`), the receive without a drain.  Both ask the
kernel for `--rcvbuf` bytes of socket buffer (granted up to
net.core.rmem_max).  One JSON line: per turn the sectors received, the
datagrams and sectors dropped, and the receiving process's CPU ms a sector
(`time.process_time` over the stream: the receive, the main thread's
holds cost none).  No GPU is used.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from ..config import DEFAULT_CONFIG
from ..io.udp import UdpIngest
from ..native import ingest_native

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _SocketReceive:
    """The native reassembly on the socket itself, no drain; into a fresh
    buffer a sector, as `UdpIngest.recv_sector` receives."""

    def __init__(self, cfg, rcvbuf: int, timeout_s: float):
        self.cfg = cfg
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        self.sock.bind(("127.0.0.1", 0))
        self.local_port = self.sock.getsockname()[1]
        self.timeout_ms = int(timeout_s * 1000)
        self.stats = np.zeros(5, np.int64)
        self.hdr = np.zeros(3, np.int32)

    def recv(self) -> int:
        return ingest_native.recv_sector(
            self.sock.fileno(), self.timeout_ms,
            bytearray(self.cfg.sector_nbytes_wire),
            self.cfg.num_range_cells, self.cfg.datagram_nbytes, self.stats,
            self.hdr)

    def drops(self) -> tuple[int, int]:
        return int(self.stats[1]), int(self.stats[2])

    def close(self):
        self.sock.close()


class _DrainReceive:
    def __init__(self, cfg, rcvbuf: int, timeout_s: float):
        self.ingest = UdpIngest(cfg, host="127.0.0.1", port=0,
                                timeout_s=timeout_s, rcvbuf_bytes=rcvbuf)
        self.local_port = self.ingest.local_port

    def recv(self) -> int:
        try:
            buf, _ = self.ingest.recv_sector()
        except TimeoutError:
            return -1
        return 0 if buf is None else 1

    def drops(self) -> tuple[int, int]:
        s = self.ingest.stats
        return s.dropped_datagrams, s.dropped_sectors

    def close(self):
        self.ingest.close()


def turn(kind: str, sectors: int, hold_ms: float, rcvbuf: int,
         rate: float) -> dict:
    cfg = DEFAULT_CONFIG
    rx = (_DrainReceive if kind == "drain" else _SocketReceive)(
        cfg, rcvbuf, timeout_s=2.0)
    got = [0]

    def receive():
        idle = 0
        # the producer takes seconds to start: wait out more idle timeouts
        # before its first sector than after it
        while got[0] < sectors and idle < (10 if got[0] == 0 else 2):
            rc = rx.recv()
            if rc == 1:
                got[0] += 1
                idle = 0
            elif rc == 0:
                idle += 1
            elif rc == -2:
                break

    t = threading.Thread(target=receive)
    t.start()
    libc = ctypes.PyDLL(None)       # its calls keep the GIL
    c0 = time.process_time()
    producer = subprocess.Popen(
        [sys.executable, "-m", "wrp_tpu_torch.cli", "produce", "--sectors",
         str(sectors), "--rate", str(rate), "--pool", "2", "--seed", "0",
         "--headers", "--ingest-port", str(rx.local_port)],
        cwd=ROOT, stderr=subprocess.DEVNULL)
    try:
        while producer.poll() is None:
            if hold_ms > 0:
                libc.usleep(int(hold_ms * 1000))
            time.sleep(0.2)
        t.join(timeout=60)
    finally:
        if producer.poll() is None:
            producer.kill()
        producer.wait()
    cpu_s = time.process_time() - c0
    dropped_datagrams, dropped_sectors = rx.drops()
    rx.close()
    return {"kind": kind, "received": got[0], "sent": sectors,
            "dropped_datagrams": dropped_datagrams,
            "dropped_sectors": dropped_sectors,
            "receiver_cpu_ms_a_sector": 1000 * cpu_s / max(got[0], 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sectors", type=int, default=40)
    ap.add_argument("--hold-ms", type=float, default=80.0)
    ap.add_argument("--rcvbuf", type=int, default=4 << 20)
    ap.add_argument("--rate", type=float, default=21.45)
    ap.add_argument("--turns", default="drain,socket,socket,drain")
    a = ap.parse_args(argv)
    kinds = a.turns.split(",")
    if not kinds or any(k not in ("drain", "socket") for k in kinds):
        ap.error("--turns: a comma-separated list of drain and socket")
    rows = [turn(k, a.sectors, a.hold_ms, a.rcvbuf, a.rate) for k in kinds]
    print(json.dumps({"sectors": a.sectors, "hold_ms": a.hold_ms,
                      "rcvbuf": a.rcvbuf, "rate": a.rate, "turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
