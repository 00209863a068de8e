"""What the probe entry points share: the device, as the bench resolves it,
and their timing (best of 3 spans, each many launches)."""

from __future__ import annotations

import time

import torch

from ..pipeline import resolve_device


def device_of(ap, name: str) -> torch.device:
    """The device `name` names; without CUDA a "cuda" request exits 2
    through `ap.error`, as the bench does (nothing falls back to the CPU)."""
    try:
        dev = resolve_device(name)
    except RuntimeError as e:
        ap.error(str(e))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def span_s(fn, dev: torch.device) -> float:
    """Seconds of one fn(), which enqueues many launches: CUDA events around
    it, ending in a synchronize (launches are asynchronous); the host clock
    on the CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def best_of_3(fn, dev: torch.device):
    """(best, [the three]) seconds of fn() after one warm call, as the JAX
    tools time their spans."""
    fn()
    runs = [span_s(fn, dev) for _ in range(3)]
    return min(runs), runs
