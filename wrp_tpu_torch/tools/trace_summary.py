"""Summarise a torch.profiler chrome trace of the port (`bench --profile
DIR`, `cli stream --trace DIR`) into time totals by event name, per process
and per thread, and the device's busy share; with --overlap, the host
stages' overlap with the device in-flight window from
DIR/host_intervals.json.  Counterpart of ``tools/trace_summary.py``.

Both commands write DIR/trace.json, and `bench --sharded N --profile DIR`
one DIR/rank{r}/trace.json a rank; torch.profiler's tensorboard handler
writes `<worker>.<n>.pt.trace.json`; gzipped copies are read too.
Complete events ("ph": "X") carry a name and a duration in microseconds.
A process is labelled by its name and pid, a thread by its name and tid.
A trace is one process's: torch names the device after the program too
(its pid is the device's index, labelled "GPU n"), so the device's streams
are counted as threads of the host process ("GPU n: stream 7 [tid 7]"),
and the profiler's own rows (pids without a process name: "Spans", and
-1 for its buffer requests on the card) are left out.
Traces are summarised each on its own; one in a folder under DIR has its
processes labelled by that folder ("rank0: python3 [pid 4242]"): ranks'
traces reuse device indices and have unsynchronised clocks.  Every process
carries its trace's device time.

    python -m wrp_tpu_torch.tools.trace_summary DIR [--top 25] [--json]
        [--overlap]

--json prints one object: {"traces", "processes", "device"} and, with
--overlap, "overlap".  "device" holds the busy share over the whole trace
and, for a `stream --trace` run, over its traffic alone (":stream", from
the first decode to the last fetch).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys

#: trace files, most specific first (the first pattern with a match wins)
TRACE_PATTERNS = ("trace.json", "trace.json.gz", "**/*.pt.trace.json",
                  "**/*.pt.trace.json.gz", "**/*.trace.json",
                  "**/*.trace.json.gz", "**/trace.json", "**/trace.json.gz")
#: event categories of work on the device in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_traces(root: str) -> list:
    for pat in TRACE_PATTERNS:
        out = sorted(set(glob.glob(os.path.join(root, pat), recursive=True)))
        if out:
            return out
    return []


def load_events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def _labels(events):
    """({pid: process label}, {(pid, tid): thread label}, {pid: "GPU n"})
    from the trace's metadata events."""
    pnames, tnames, devices = {}, {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args", {})
        name = args.get("name")
        if e.get("name") == "process_name":
            pnames[e.get("pid")] = f"{name} [pid {e.get('pid')}]"
        elif e.get("name") == "thread_name":
            tnames[(e.get("pid"), e.get("tid"))] = f"{name} [tid {e.get('tid')}]"
        elif (e.get("name") == "process_labels"
              and str(args.get("labels", "")).startswith("GPU")):
            devices[e.get("pid")] = args["labels"]
    return pnames, tnames, devices


def _top(totals, counts, span, top):
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [{"name": n, "total_ms": round(t / 1e3, 3), "calls": counts[n],
             "pct_of_span": round(100 * t / span, 1) if span else 0.0}
            for n, t in rows]


def summarise(events, top: int = 25) -> dict:
    """{process: {span_ms, ops, threads: {thread: {span_ms, ops}}}}: time
    totals by event name (the `top` largest), call counts and first-to-last
    spans, per process and per thread.  A device's streams count as threads
    of the trace's one host process; rows under pids without a process
    name (the profiler's own) are left out."""
    pnames, tnames, devices = _labels(events)
    hosts = {pid for pid in pnames if pid not in devices}
    host = next(iter(hosts)) if len(hosts) == 1 else None
    totals = collections.defaultdict(lambda: collections.defaultdict(float))
    counts = collections.defaultdict(lambda: collections.defaultdict(int))
    spans = collections.defaultdict(lambda: [float("inf"), float("-inf")])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        pid, tid = e.get("pid"), e.get("tid")
        if pid not in pnames:
            continue
        thread = tnames.get((pid, tid), str(tid))
        if pid in devices and host is not None:
            pid, thread = host, f"{devices[pid]}: {thread}"
        proc = pnames[pid]
        name, dur, ts = e.get("name", "?"), float(e["dur"]), float(e["ts"])
        for key in ((proc,), (proc, thread)):
            totals[key][name] += dur
            counts[key][name] += 1
            s = spans[key]
            s[0], s[1] = min(s[0], ts), max(s[1], ts + dur)
    out = {}
    for key in sorted(k for k in totals if len(k) == 1):
        span = spans[key][1] - spans[key][0]
        out[key[0]] = {"span_ms": round(span / 1e3, 3),
                       "ops": _top(totals[key], counts[key], span, top),
                       "threads": {}}
    for key in sorted(k for k in totals if len(k) == 2):
        span = spans[key][1] - spans[key][0]
        out[key[0]]["threads"][key[1]] = {
            "span_ms": round(span / 1e3, 3),
            "ops": _top(totals[key], counts[key], span, top)}
    return out


def _union(intervals):
    """Merge [t0, t1) spans; returns (merged list, total length)."""
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged, sum(t1 - t0 for t0, t1 in merged)


def _intersect_len(a, b):
    """Total overlap length of two MERGED span lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_busy(events, span=None) -> dict:
    """The device's share of a window of the trace: the union of its
    kernels (and of its copies and memsets) over the window, by default
    from the first event of the trace to the end of the last, host and
    device alike; `span` = (t0, t1) in the trace's microseconds clips to
    that window.  Kernel counts by name beside it (in the window)."""
    lo, hi = span if span is not None else (float("inf"), float("-inf"))
    spans = collections.defaultdict(list)
    kernels = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if span is None:
            lo, hi = min(lo, t0), max(hi, t1)
        else:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 <= t0:
                continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            spans[cat].append((t0, t1))
            if cat == "kernel":
                kernels[e.get("name", "?")] += 1
    width = hi - lo if lo < hi else 0.0
    kernel_us = _union(spans["kernel"])[1]
    busy_us = _union([s for c in DEVICE_CATS for s in spans[c]])[1]
    return {"window_ms": round(width / 1e3, 3),
            "kernel_ms": round(kernel_us / 1e3, 3),
            "busy_ms": round(busy_us / 1e3, 3),
            "kernel_share": kernel_us / width if width else None,
            "busy_share": busy_us / width if width else None,
            "kernel_launches": dict(kernels.most_common())}


def stream_span(events):
    """(t0, t1) of a `stream --trace` run's traffic: from the start of the
    first `ingest/decode` span to the end of the last `compute/fetch`
    (the warm-up and the wait for the first sector left out), or None
    when the trace has no such spans."""
    first, last = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        if e.get("name") == "ingest/decode":
            first = min(first, float(e["ts"]))
        elif e.get("name") == "compute/fetch":
            last = max(last, float(e["ts"]) + float(e["dur"]))
    return (first, last) if first < last else None


def summarise_overlap(intervals) -> dict:
    """Pairwise overlap fractions from the executor's host-interval log
    (StageTimers.enable_intervals: [name, thread, t0, t1] rows), the keys
    of ``tools/trace_summary.summarise_overlap``.

    The question the totals cannot answer: while a batch was in flight on
    the device (compute/in_flight spans: H2D enqueue and dispatch through
    the blocking fetch), was the host ingesting and decoding the next
    sectors, i.e. does the two-deep pipeline overlap?"""
    by_name = collections.defaultdict(list)
    for name, _thread, t0, t1 in intervals:
        by_name[name].append((t0, t1))
    merged = {n: _union(v) for n, v in by_name.items()}
    out = {"busy_s": {n: round(tot, 3) for n, (_, tot) in
                      sorted(merged.items())}}
    base_name = "compute/in_flight"
    if base_name in merged:
        base, base_len = merged[base_name]
        rows = {}
        for n, (spans, tot) in merged.items():
            if n == base_name or not base_len:
                continue
            ov = _intersect_len(base, spans)
            rows[n] = {
                # the share of the stage's own busy time that ran while a
                # batch was in flight on the device
                "of_stage": round(ov / tot, 3) if tot else None,
                # the share of the device in-flight time the stage covered
                "of_in_flight": round(ov / base_len, 3),
                "overlap_s": round(ov, 3),
            }
        out["in_flight_s"] = round(base_len, 3)
        out["overlap_with_in_flight"] = rows
    return out


def run(trace_dir: str, top: int = 25, overlap: bool = False) -> dict:
    """{"traces", "processes", "device"[, "overlap"]} for the traces under
    trace_dir.  Raises FileNotFoundError when there is no trace (or, with
    overlap, no host_intervals.json)."""
    out = {}
    if overlap:
        ipath = os.path.join(trace_dir, "host_intervals.json")
        if not os.path.exists(ipath):
            raise FileNotFoundError(f"no {ipath}")
        with open(ipath) as f:
            out["overlap"] = summarise_overlap(json.load(f))
    paths = find_traces(trace_dir)
    if not paths:
        raise FileNotFoundError(f"no trace files under {trace_dir}")
    # each file on its own, its processes under the trace's label: files of
    # several processes (ranks) reuse pids and device indices and have
    # unsynchronised clocks
    out["traces"], out["processes"], out["device"] = paths, {}, {}
    for p in paths:
        events = load_events(p)
        key = trace_label(p, trace_dir)
        busy = out["device"][key] = device_busy(events)
        prefix = "" if key == "trace" else key + ": "
        for proc, info in summarise(events, top).items():
            info["device"] = {k: busy[k] for k in
                              ("kernel_ms", "busy_ms", "busy_share")}
            out["processes"][prefix + proc] = info
        span = stream_span(events)
        if span is not None:
            out["device"][key + ":stream"] = device_busy(events, span)
    return out


def trace_label(path: str, root: str) -> str:
    """A trace's name under root: "trace" for root's own trace.json, the
    folder for root/<folder>/trace.json (a rank's: "rank0"), else its path
    under root."""
    rel = os.path.relpath(path, root)
    head, tail = os.path.split(rel)
    if tail in ("trace.json", "trace.json.gz"):
        return head or "trace"
    return rel


def _print_ops(title, info, indent):
    print(f"{indent}== {title}  (span {info['span_ms']} ms)")
    for r in info["ops"]:
        print(f"{indent}  {r['total_ms']:>10.3f} ms  {r['calls']:>6}x "
              f"{r['pct_of_span']:>5.1f}%  {r['name'][:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trace_summary")
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON object")
    ap.add_argument("--overlap", action="store_true",
                    help="also read DIR/host_intervals.json (written by "
                         "`cli stream --trace`) and give the host stages' "
                         "overlap with the device in-flight window")
    args = ap.parse_args(argv)
    try:
        out = run(args.trace_dir, args.top, args.overlap)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(out))
        return 0
    if args.overlap:
        print(json.dumps(out["overlap"], indent=1))
    for proc, info in sorted(out["processes"].items()):
        print()
        _print_ops(proc, info, "")
        for thread, tinfo in sorted(info["threads"].items()):
            _print_ops(thread, tinfo, "   ")
    for name, d in out["device"].items():
        share = d["busy_share"]
        print(f"\ndevice ({name}): kernels {d['kernel_ms']} ms, busy "
              f"{d['busy_ms']} ms of a {d['window_ms']} ms window"
              + ("" if share is None else f" ({100 * share:.2f}% busy)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
