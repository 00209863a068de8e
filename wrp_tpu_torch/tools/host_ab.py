#!/usr/bin/env python3
"""A/B of the host-decode path across source trees, on one GPU.

    python3 wrp_tpu_torch/tools/host_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (e.g. the parent commit unpacked with
`git archive` into a git-ignored directory); each runs in its own process,
in the order given, so list them in turns (parent, change, change, parent)
to separate a code change from the host's drift.  In each, the tree's own
`chip_smoke.py` drives the host-decode path as its smoke run does: the
executor fed from memory, unpaced (capacity), then one cut of 143 sectors
at 21.45/s over UDP loopback from a `cli produce` process (the paced
stream).  One JSON line a tree: the card, capacity in sectors/s and its
`ingest/decode` ms a sector, the stream's delivered rate, p50 and p99
latency and `ingest/decode`, and, where the tree prints them, the decode
rates of its codecs alone.  Needs CUDA; a tree whose run fails ends the
tool with its output and exit 1.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

RUN = ("import chip_smoke as cs; cs.phase_environment(); cs.phase_build(); "
       "cs.phase_capacity(device_decode=False); "
       "cs.phase_stream(device_decode=False)")

CAPACITY = re.compile(r"host-decode capacity: \d+ sectors unpaced from memory, "
                      r"([\d.]+) sectors/s.*mean ms per call (\{.*\})")
STREAM = re.compile(r"host-decode stream: \d+ sectors, requested [\d.]+/s, "
                    r"delivered ([\d.]+) sectors/s over the active span; "
                    r"latency p50 ([\d.]+) ms p99 ([\d.]+) ms; mean "
                    r"ingest/decode ([\d.]+) ms")
CODECS = re.compile(r"decode_iq_i16 alone .*")


def run_tree(tree: Path) -> dict:
    done = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    out = done.stdout
    cap, stream = CAPACITY.search(out), STREAM.search(out)
    if done.returncode != 0 or cap is None or stream is None:
        sys.stderr.write(out[-4000:] + done.stderr[-4000:])
        raise SystemExit(f"{tree}: run failed (rc {done.returncode})")
    codecs = CODECS.search(out)
    return {"tree": str(tree), "device": out.splitlines()[1].strip(),
            "capacity_sectors_per_s": float(cap[1]),
            "capacity_decode_ms": json.loads(cap[2])["ingest/decode"],
            "stream_sectors_per_s": float(stream[1]),
            "stream_p50_ms": float(stream[2]),
            "stream_p99_ms": float(stream[3]),
            "stream_decode_ms": float(stream[4]),
            "codecs": codecs[0] if codecs else None}


def main(argv=None) -> int:
    trees = [Path(t) for t in (argv if argv is not None else sys.argv[1:])]
    if not trees:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    for tree in trees:
        print(json.dumps(run_tree(tree)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
