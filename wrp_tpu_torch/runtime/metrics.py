"""Observability: per-stage timers, throughput counters, structured logs.

Counterpart of ``wrp_tpu/runtime/metrics.py``.  Where the JAX package
wraps timed sections in ``jax.profiler.TraceAnnotation``, this one pushes
``torch.cuda.nvtx`` ranges, so the spans line up with the kernels in an
NVTX-aware profiler.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

log = logging.getLogger("wrp_tpu_torch")


def configure_logging(level: str = "INFO", structured: bool = False) -> None:
    handler = logging.StreamHandler()
    if structured:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))
    root = logging.getLogger("wrp_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(level.upper())


class _JsonFormatter(logging.Formatter):
    def format(self, record):
        payload = {
            "t": round(record.created, 3),
            "level": record.levelname,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


class StageTimers:
    """Named accumulating wall-clock timers (the tick/tock ledger).

    Thread-safe: the ingest thread(s) and the compute thread update the
    same ledger concurrently."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.intervals = None      # optional (name, thread, t0, t1) log
        self._annotate = False

    def enable_intervals(self, annotate: bool = False,
                         max_events: int = 500_000) -> None:
        """Record (name, thread, t0, t1) per timed section — the overlap
        evidence the totals can't carry.  annotate=True additionally wraps
        each section in an NVTX range (CUDA builds of torch only)."""
        self.intervals = []
        self._max_events = max_events
        self._annotate = annotate

    def add_interval(self, name: str, t0: float, t1: float) -> None:
        """Log an explicit span (e.g. the device in-flight window the
        executor knows but no single `with` block covers)."""
        if self.intervals is not None:
            with self._lock:
                if len(self.intervals) < self._max_events:
                    self.intervals.append(
                        (name, threading.current_thread().name, t0, t1))

    @contextlib.contextmanager
    def time(self, name: str):
        nvtx = None
        if self._annotate:
            import torch

            if torch.cuda.is_available():
                nvtx = torch.cuda.nvtx
                nvtx.range_push(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if nvtx is not None:
                nvtx.range_pop()
            with self._lock:
                self.totals[name] += t1 - t0
                self.counts[name] += 1
                if (self.intervals is not None
                        and len(self.intervals) < self._max_events):
                    self.intervals.append(
                        (name, threading.current_thread().name, t0, t1))

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }


class LatencyStats:
    """Per-sector end-to-end latency reservoir: wire arrival (last row of
    the sector received) -> products published.  Includes decode,
    queueing, batch-fill wait, H2D, compute, D2H, and egress.

    Thread-safe; keeps the most recent `cap` samples."""

    def __init__(self, cap: int = 100_000):
        self.cap = cap
        self.count = 0
        self._samples: list = []
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self._samples.append(seconds)
            if len(self._samples) > self.cap:
                del self._samples[: len(self._samples) - self.cap]

    def summary(self):
        """Nearest-rank percentile summary in ms (every reported value is a
        latency that actually happened), or None if nothing was recorded."""
        with self._lock:
            if not self._samples:
                return None
            s = list(self._samples)
            count = self.count
        s.sort()

        def rank(p):
            return s[min(len(s) - 1, int(p * len(s)))]

        return {
            "count": count,
            "mean_ms": round(1e3 * sum(s) / len(s), 3),
            "p50_ms": round(1e3 * rank(0.50), 3),
            "p90_ms": round(1e3 * rank(0.90), 3),
            "p99_ms": round(1e3 * rank(0.99), 3),
            "max_ms": round(1e3 * s[-1], 3),
        }


@dataclass
class Throughput:
    """Sectors/s counter with a rolling window, the reference's headline
    number.  first_tick/last_tick survive window pruning so a harness can
    take an active-span rate that excludes warmup and the idle tail."""

    window: float = 10.0
    count: int = 0
    started: float = field(default_factory=time.perf_counter)
    first_tick: float = 0.0
    first_count: int = 0
    last_tick: float = 0.0
    _events: list = field(default_factory=list)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def tick(self, n: int = 1) -> None:
        now = time.perf_counter()
        if not self.first_tick:
            self.first_tick = now
            self.first_count = n
        self.last_tick = now
        self.count += n
        self._events.append((now, n))
        self._prune(now)

    def rate(self) -> float:
        now = time.perf_counter()
        self._prune(now)
        if not self._events:
            return 0.0
        span = max(now - max(self._events[0][0], now - self.window), 1e-9)
        return sum(n for _, n in self._events) / span

    def overall(self) -> float:
        return self.count / max(time.perf_counter() - self.started, 1e-9)

    def active_rate(self) -> float:
        """Items/s from the first completion to the last, counting what
        completed after the first tick: excludes warmup and the idle tail
        (NaN before two ticks)."""
        span = self.last_tick - self.first_tick
        return (self.count - self.first_count) / span if span > 0 else float("nan")
