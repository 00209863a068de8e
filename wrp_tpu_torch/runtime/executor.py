"""Streaming executor: the reference's v1 stream-cascade pipeline
(gpu_1fp_streamcasc.cu:485-737) on one CUDA device.

Counterpart of ``wrp_tpu/runtime/executor.py`` (single-host).  Two threads
and a two-deep batch pipeline:

  ingest thread:  transport recv -> native decode (native/codec.cpp: int16
                  planar, natural row order) -> queue; with device_decode,
                  no decode: the wire bytes are only viewed in the
                  processor's wire dtype (int32 words or uint8), and the
                  device decodes them
  compute thread: drain batch k+1 -> stage it in a pinned ping-pong buffer
                  -> H2D on the copy stream -> dispatch the chain on the
                  compute stream once the copy's event fires -> only then
                  fetch batch k's products -> egress + volume accumulation

While the device runs batch k, the ingest thread decodes batch k+2 and the
compute thread stages batch k+1.  Adds what the reference lacked: receive
timeouts with drop-and-resync, sector/elevation tracking, volume
checkpointing, per-stage timers and end-to-end latency.

Lock-step mode (`lockstep=True`, for the multi-rank processors of
parallel/multihost.py) waits for full batches, so every rank issues the
same collective steps, and bounds the wait on a silent peer: a watchdog
thread around dispatch and fetch warns after `stall_warning_s` and, past
`collective_timeout_s`, saves every volume checkpoint, writes the stats to
stderr and exits the process with code 3.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import queue
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import RadarConfig, DEFAULT_CONFIG
from ..io import codec
from ..pipeline import SectorProcessor
from .metrics import LatencyStats, StageTimers, Throughput, log
from .volume import VolumeScan


@dataclasses.dataclass
class SectorTask:
    planar: np.ndarray          # [C, 2, m, n] int16, natural row order; with
                                # device_decode the wire view [nbytes / itemsize]
    sector: int
    elevation: int
    feed: int = 0               # which ingest transport produced it
    t_recv: float = 0.0         # perf_counter at wire arrival (0 = unknown)


def _to_host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class _StallWatchdog:
    """Surfaces a lock-step collective blocked on a silent peer.

    A collective waits for every rank: if one rank never issues its step
    (its ingest died or went idle), every other rank blocks inside the
    backend with no error.  This side thread logs a diagnostic every
    `interval` seconds while the wrapped section blocks and, with
    `timeout_s`, calls `on_timeout(what, waited)` once the block exceeds
    it (the blocked thread cannot be unblocked from the host, so
    on_timeout is expected to checkpoint and end the process)."""

    def __init__(self, what: str, interval: Optional[float],
                 on_warn: Optional[Callable] = None,
                 timeout_s: Optional[float] = None,
                 on_timeout: Optional[Callable] = None):
        self.what = what
        self.interval = interval
        self.on_warn = on_warn
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _watch(self, t0: float):
        wait = self.interval or self.timeout_s
        if self.timeout_s:
            wait = min(wait, self.timeout_s)
        while not self._done.wait(wait):
            waited = time.monotonic() - t0
            if (self.timeout_s is not None and waited >= self.timeout_s
                    and self.on_timeout is not None):
                self.on_timeout(self.what, waited)
                return  # unreachable when on_timeout exits the process
            log.warning(
                "lock-step %s blocked for %.1fs: a peer rank is likely "
                "silent (its ingest idle or dead); this rank is stuck in "
                "the collective until the peer steps or the run is killed",
                self.what, waited)
            if self.on_warn is not None:
                self.on_warn()

    def __enter__(self):
        armed = (self.interval is not None and self.interval > 0) or (
            self.timeout_s is not None and self.timeout_s > 0)
        if armed:
            self._thread = threading.Thread(
                target=self._watch, args=(time.monotonic(),), daemon=True,
                name="wrp-stall-watchdog")
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self._done.set()
            self._thread.join(timeout=1)
        return False


class StreamingExecutor:
    """Pull sectors from a transport, process in batches, publish products.

    transport: object with `recv_sector() -> (bytes | None, header | None)`
               (UdpIngest) or a bare `recv_sector() -> bytes | None`; or a
               LIST of them — multi-feed mode: each feed has its own ingest
               thread, sector counters, volume and stats, all batched
               through one processor.
    publish:   callable(sector, elevation, zdb, zdr), or an egress object
               whose `.send` takes those arguments (UdpEgress); a list gives
               each feed its own.
    volume:    a VolumeScan, or a list with one per feed.
    processor: override of the batch step, called with the host int16
               planar batch [batch, C, 2, m, n] (numpy; with device_decode
               the wire batch [batch, nbytes / itemsize] in the override's
               `wire_dtype`; plus `labels=` rows of (sector, elevation) if
               it takes them) and returning (zdb, zdr).  It owns its device
               placement (e.g. PulseShardedProcessor.step_local of
               parallel/multihost.py for lock-step multi-rank streaming).
               Default: a SectorProcessor(method, device) fed through
               pinned staging.
    device_decode: ship raw wire bytes and decode them on the device
               (SectorProcessor(wire_input=True): the wire kernel, or a
               decode pass before the dense kernel).  The ingest thread then
               only views each sector's bytes in the processor's wire dtype,
               which frees the host decode; H2D bytes are unchanged.
               Requires method="pallas", or an override whose owner has
               wire_input=True.
    """

    def __init__(
        self,
        cfg: RadarConfig = DEFAULT_CONFIG,
        transport=None,
        publish: Optional[Callable] = None,
        batch: int = 8,
        method: str = "mxu",
        queue_depth: int = 4,
        debug_sync: bool = False,
        volume: Optional[VolumeScan] = None,
        max_sectors: Optional[int] = None,
        idle_limit: Optional[int] = None,
        processor: Optional[Callable] = None,
        checkpoint_every_s: Optional[float] = 30.0,
        on_ready: Optional[Callable] = None,
        device="cuda",
        device_decode: bool = False,
        lockstep: bool = False,
        stall_warning_s: Optional[float] = 10.0,
        collective_timeout_s: Optional[float] = None,
    ):
        """idle_limit: stop after this many consecutive idle receive
        timeouts (None = listen forever, the service default).

        checkpoint_every_s: with a volume that has a checkpoint path, save
        it at most this often (<= 0 after every batch, None only at exit).

        on_ready: called once warmup is done and ingest is listening — the
        point where a producer can start without overflowing the receive
        buffer.

        device: where the default processor runs; "cuda" (the default)
        raises on a host without CUDA rather than running on the CPU.

        lockstep: wait for FULL batches (except at end of stream), so every
        rank of a multi-rank processor issues the same collective steps for
        the same sector count.

        stall_warning_s: in lock-step mode, log a diagnostic when a step
        blocks longer than this (a peer rank is silent); None disables.

        collective_timeout_s: in lock-step mode, bound the wait on a dead
        peer: when dispatch or fetch blocks (or raises) past this, or no
        batch can start or fill for this long, save every volume
        checkpoint, write the stats to stderr and exit the process with
        code 3 (the blocked thread cannot be freed from the host; a
        restarted rank resumes from --checkpoint).  None keeps the
        warn-only watchdog.  Give the process group a larger timeout
        (parallel/mesh.init_distributed), or the backend's own watchdog
        may end the process first."""
        self.cfg = cfg
        self.transports = (list(transport)
                           if isinstance(transport, (list, tuple))
                           else ([transport] if transport is not None
                                 else []))
        self.transport = self.transports[0] if self.transports else None
        nfeeds = max(1, len(self.transports))
        self.publishes = (list(publish) if isinstance(publish, (list, tuple))
                          else [publish] * nfeeds)
        if not self.publishes:       # [] means publish nowhere, like None
            self.publishes = [None] * nfeeds
        if len(self.publishes) != nfeeds:
            raise ValueError("publish list must match the transport list")
        if isinstance(volume, (list, tuple)):
            self.volumes = list(volume)
            if len(self.volumes) != nfeeds:
                raise ValueError("volume list must match the transport list")
        elif len(self.transports) > 1 and volume is not None:
            # feeds share sector/elevation labels: one volume would be
            # silently cross-contaminated
            raise ValueError("multi-feed mode needs one volume per feed "
                             "(pass a list)")
        else:
            self.volumes = [volume] * nfeeds
        self.batch = batch
        self.lockstep = lockstep
        self.stall_warning_s = stall_warning_s
        self.collective_timeout_s = collective_timeout_s
        self.stall_warnings = 0
        self.batches = 0
        self.debug_sync = debug_sync
        self.max_sectors = max_sectors
        self.idle_limit = idle_limit
        self.checkpoint_every_s = checkpoint_every_s
        self.on_ready = on_ready
        self._last_checkpoint = 0.0
        self.checkpoints_written = 0
        self.bad_headers = 0
        self._processed = 0
        self.timers = StageTimers()
        self.throughput = Throughput()
        self.latency = LatencyStats()
        # per feed: a merged percentile would let a fast feed mask a slow
        # feed's tail
        self.feed_latencies = [LatencyStats() for _ in range(nfeeds)]
        self._feed_processed = [0] * nfeeds
        self._pub_v2: dict = {}      # feed -> send() takes elevation?
        # reference counters (rpv2.cu:46-51, advance() :572-579), per feed
        self._pos = [[0, 0] for _ in range(nfeeds)]

        if device_decode:
            # the step must take raw wire bytes: the built-in pallas path,
            # or an override whose owner advertises wire input
            takes_wire = getattr(getattr(processor, "__self__", processor),
                                 "wire_input", False)
            if processor is not None and not takes_wire:
                raise ValueError(
                    "device_decode with a processor override requires the "
                    "override to take wire bytes (wire_input=True)")
            if processor is None and method != "pallas":
                raise ValueError("device_decode (on-device wire decode) "
                                 "requires method='pallas'")
        self._device_decode = device_decode
        self._proc_takes_labels = False
        if processor is not None:
            self.processor = processor
            self._device = None
            try:
                self._proc_takes_labels = "labels" in (
                    inspect.signature(processor).parameters)
            except (TypeError, ValueError):
                pass
        else:
            self.processor = SectorProcessor(cfg, method=method, device=device,
                                             wire_input=device_decode)
            self._device = self.processor.device
        self._cuda = self._device is not None and self._device.type == "cuda"
        shape = (batch, cfg.num_channels, 2, cfg.m, cfg.n)
        dtype = torch.int16
        self._wire_dtype = None
        if device_decode:
            owner = getattr(self.processor, "__self__", self.processor)
            self._wire_dtype = np.dtype(getattr(owner, "wire_dtype", np.uint8))
            shape = (batch, cfg.sector_nbytes_wire // self._wire_dtype.itemsize)
            dtype = torch.from_numpy(np.zeros(0, self._wire_dtype)).dtype

        # Ping-pong batch staging: two host slots (pinned when the device
        # is a GPU, so the H2D can run asynchronously on the copy stream)
        # and, on the GPU, two device slots.  Slot i is reused at dispatch
        # k+2.  Unlike jax.device_put, a torch non_blocking copy reads the
        # pinned host memory AFTER it returns, so before rewriting host
        # slot i the host waits on `_copied[i]`, the event of that slot's
        # last H2D; and the copy into device slot i waits on `_computed[i]`,
        # the event of the compute that last read it.  Slots take the wire
        # dtype and shape with device_decode.
        self._host = [torch.zeros(shape, dtype=dtype,
                                  pin_memory=self._cuda) for _ in range(2)]
        self._host_np = [h.numpy() for h in self._host]
        self._stage_rows = [0, 0]
        self._stage_idx = 0
        self._copied: list = [None, None]
        self._computed: list = [None, None]
        if self._cuda:
            self._dev = [torch.zeros(shape, dtype=dtype,
                                     device=self._device) for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self._device)
            self._compute_stream = torch.cuda.Stream(self._device)

        self._queue: "queue.Queue[Optional[SectorTask]]" = queue.Queue(
            maxsize=queue_depth * batch)
        self._stop = threading.Event()
        self._ingest_threads: list[threading.Thread] = []
        self._ingest_error: Optional[BaseException] = None
        self._eof_feeds = 0

    # ------------------------------------------------------------------
    # ingest side
    # ------------------------------------------------------------------

    def _advance(self, feed: int = 0):
        pos = self._pos[feed]
        pos[0] = (pos[0] + 1) % self.cfg.num_sectors
        if pos[0] == 0:
            pos[1] = (pos[1] + 1) % self.cfg.num_elevations

    def _ingest_loop(self, feed: int = 0):
        transport = self.transports[feed] if self.transports else None
        received = 0
        idle = 0
        try:
            while not self._stop.is_set():
                if self.max_sectors is not None and received >= self.max_sectors:
                    break
                with self.timers.time("ingest/recv"):
                    try:
                        got = transport.recv_sector()
                    except TimeoutError as e:
                        log.warning("feed %d dropped sector: %s", feed, e)
                        self._advance(feed)
                        continue
                wire, header = got if isinstance(got, tuple) else (got, None)
                if wire is None:
                    idle += 1
                    if self.idle_limit is not None and idle >= self.idle_limit:
                        log.info("idle limit reached (%d timeouts), stopping",
                                 idle)
                        break
                    continue
                idle = 0
                t_recv = time.perf_counter()   # wire arrival: latency t0
                if header is not None:
                    sector, elevation = header.sector, header.elevation
                    if not (0 <= sector < self.cfg.num_sectors
                            and 0 <= elevation < self.cfg.num_elevations):
                        # a corrupt header must neither kill the run nor
                        # index outside the volume: clamp and count it
                        sector %= self.cfg.num_sectors
                        elevation %= self.cfg.num_elevations
                        self.bad_headers += 1
                        log.warning("bad wire header clamped to (%d, %d)",
                                    sector, elevation)
                    self._pos[feed][:] = [sector, elevation]
                else:
                    sector, elevation = self._pos[feed]
                with self.timers.time("ingest/decode"):
                    # Natural row order always: the fused kernels read the
                    # radix branches by index arithmetic, so there is no
                    # radix-ordered decode here and no counterpart of
                    # wrp_tpu's executor quietly assuming input_radix=1
                    # for a processor that does not advertise its order.
                    if self._device_decode:
                        # a view, no decode (transports hand over a fresh
                        # buffer per sector, so the view stays valid)
                        planar = np.frombuffer(wire, self._wire_dtype)
                    else:
                        planar = codec.decode_iq_i16(wire, self.cfg)
                task = SectorTask(planar, sector, elevation, feed,
                                  t_recv=t_recv)
                while not self._stop.is_set():
                    try:
                        self._queue.put(task, timeout=0.2)
                        break
                    except queue.Full:
                        continue  # shutdown must not hang on a full queue
                self._advance(feed)
                received += 1
        except BaseException as e:  # surface into run()
            log.exception("ingest feed %d died; its stream ends here "
                          "(other feeds continue)", feed)
            self._ingest_error = e
        finally:
            # the EOF sentinel must land unless run() is already unwinding
            while not self._stop.is_set():
                try:
                    self._queue.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------------
    # compute side
    # ------------------------------------------------------------------

    def _drain_batch(self):
        """Collect up to `batch` queued sectors (at least one, else None);
        in lock-step mode a full batch unless the stream ended."""
        nfeeds = max(1, len(self.transports))
        item = None
        waited0 = 0.0
        while item is None:
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                # defensive liveness check: every ingest thread gone and
                # nothing left to drain
                ts = self._ingest_threads
                if (ts and all(not t.is_alive() for t in ts)
                        and self._queue.empty()):
                    return None
                if self.lockstep and self.collective_timeout_s is not None:
                    # a lock-step rank that makes no progress cannot tell a
                    # healthy idle fleet from peers blocked on its next
                    # step; past the timeout it exits with a checkpoint
                    # (set the timeout above the expected sector gap)
                    waited0 += 0.5
                    if waited0 >= self.collective_timeout_s:
                        self._collective_abort(
                            "batch start (no local traffic; peers may be "
                            "blocked on this rank's next step)", waited0)
                continue
            if item is None:            # one feed reached end-of-stream
                self._eof_feeds += 1
                if self._eof_feeds >= nfeeds:
                    return None
        tasks = [item]
        starved_s = 0.0
        next_starve_warn = self.stall_warning_s or float("inf")
        while len(tasks) < self.batch:
            if self.lockstep:
                try:
                    item = self._queue.get(timeout=0.5)
                    # an arrival proves the wire is alive: starvation is
                    # about CONSECUTIVE idle time
                    starved_s = 0.0
                    next_starve_warn = self.stall_warning_s or float("inf")
                except queue.Empty:
                    ts = self._ingest_threads
                    if (ts and all(not t.is_alive() for t in ts)
                            and self._queue.empty()):
                        break
                    starved_s += 0.5
                    if (self.collective_timeout_s is not None
                            and starved_s >= self.collective_timeout_s):
                        # this rank's wire died mid-batch: peers are (or
                        # will be) blocked on its next step
                        self._collective_abort(
                            "batch fill (local ingest idle; peers blocked "
                            "on this rank's next step)", starved_s)
                    if starved_s >= next_starve_warn:
                        log.warning(
                            "lock-step batch starving: %d/%d sectors after "
                            "%.1fs of idle ingest; peer ranks are blocked "
                            "on this rank's next collective step",
                            len(tasks), self.batch, starved_s)
                        self.stall_warnings += 1
                        next_starve_warn += self.stall_warning_s
                    continue
            else:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
            if item is None:
                self._eof_feeds += 1
                if self._eof_feeds >= nfeeds:
                    self._queue.put(None)  # re-signal EOF for the next round
                    break
                continue
            tasks.append(item)
        return tasks

    def _stage(self, tasks) -> int:
        """Copy the batch into the next host slot; returns the slot."""
        idx = self._stage_idx
        self._stage_idx = 1 - idx
        if self._copied[idx] is not None:
            with self.timers.time("compute/stage_wait"):
                self._copied[idx].synchronize()
        buf = self._host_np[idx]
        with self.timers.time("compute/stage_copy"):
            for i, t in enumerate(tasks):
                buf[i] = t.planar
            if self._stage_rows[idx] > len(tasks):
                # scrub rows a larger batch wrote (the pad rows a processor
                # override sees stay zeros; their products are discarded)
                buf[len(tasks):self._stage_rows[idx]] = 0
        self._stage_rows[idx] = len(tasks)
        return idx

    def _dispatch_batch(self, tasks):
        """Stage a batch, enqueue its H2D and the chain; returns (tasks,
        zdb, zdr, t_dispatch, done_event) with the device work in flight.
        A processor override sees the batch padded to the fixed `batch`
        shape, as in wrp_tpu; the built-in processor copies and computes
        only the filled rows (eager torch has no compiled shape to keep)."""
        idx = self._stage(tasks)
        rows = len(tasks)
        done = None
        self.batches += 1
        if self._device is None:      # processor override
            t_dispatch = time.perf_counter()
            with self.timers.time("compute/dispatch"), \
                    self._stall_watch("collective dispatch"):
                try:
                    if self._proc_takes_labels:
                        labels = np.full((self.batch, 2), -1, np.int32)
                        for i, t in enumerate(tasks):
                            labels[i] = (t.sector, t.elevation)
                        zdb, zdr = self.processor(self._host_np[idx],
                                                  labels=labels)
                    else:
                        zdb, zdr = self.processor(self._host_np[idx])
                except Exception:
                    # a dead peer may surface as a backend error instead of
                    # a block: the same bounded exit.  The traceback goes
                    # first: the error may as well be local.
                    if self.lockstep and self.collective_timeout_s is not None:
                        log.exception("collective dispatch raised (a dead "
                                      "peer OR a local error, see traceback)")
                        self._collective_abort("dispatch (exception)", 0.0)
                    raise
        elif self._cuda:
            with self.timers.time("compute/h2d_enqueue"):
                if self._computed[idx] is not None:
                    self._copy_stream.wait_event(self._computed[idx])
                with torch.cuda.stream(self._copy_stream):
                    self._dev[idx][:rows].copy_(self._host[idx][:rows],
                                                non_blocking=True)
                    self._copied[idx] = torch.cuda.Event()
                    self._copied[idx].record(self._copy_stream)
            t_dispatch = time.perf_counter()
            with self.timers.time("compute/dispatch"):
                self._compute_stream.wait_event(self._copied[idx])
                with torch.cuda.stream(self._compute_stream):
                    zdb, zdr = self.processor(self._dev[idx][:rows])
                    done = torch.cuda.Event()
                    done.record(self._compute_stream)
                self._computed[idx] = done
        else:
            t_dispatch = time.perf_counter()
            with self.timers.time("compute/dispatch"):
                zdb, zdr = self.processor(self._host[idx][:rows])
        return tasks, zdb, zdr, t_dispatch, done

    def _complete_batch(self, pending) -> int:
        """Wait for a dispatched batch, fetch its products (D2H) and run
        the host-side epilogue: volume store, egress, throughput,
        periodic checkpoint."""
        tasks, zdb, zdr, t_dispatch, done = pending
        with self.timers.time("compute/fetch"), \
                self._stall_watch("result fetch"):
            try:
                if done is not None:
                    done.synchronize()
                zdb = _to_host(zdb)[: len(tasks)]
                zdr = _to_host(zdr)[: len(tasks)]
            except Exception:
                if self.lockstep and self.collective_timeout_s is not None:
                    log.exception("collective result fetch raised (a dead "
                                  "peer OR a local error, see traceback)")
                    self._collective_abort("result fetch (exception)", 0.0)
                raise
        # the device in-flight window: dispatch through the completed fetch
        self.timers.add_interval("compute/in_flight", t_dispatch,
                                 time.perf_counter())
        if self.debug_sync:
            bad = ~np.isfinite(zdb[:, 1:])
            if bad.any():
                log.error("debug_sync: %d non-finite zdb bins", int(bad.sum()))
        for k, t in enumerate(tasks):
            vol = self.volumes[t.feed]
            if vol is not None:
                vol.store(t.sector, t.elevation, zdb[k], zdr[k])
            if self.publishes[t.feed] is not None:
                with self.timers.time("egress/send"):
                    self._publish_one(t, zdb[k], zdr[k])
            self._feed_processed[t.feed] += 1
            if t.t_recv:
                dt = time.perf_counter() - t.t_recv
                self.latency.record(dt)
                self.feed_latencies[t.feed].record(dt)
        self.throughput.tick(len(tasks))
        self._processed += len(tasks)
        self._maybe_checkpoint()
        return len(tasks)

    def _publish_one(self, t, zdb, zdr) -> None:
        """One sector's products to its feed's egress: a plain callable
        takes (sector, elevation, zdb, zdr); an object's `send` takes that
        (v2) or (sector, zdb, zdr) (v1, e.g. a v1 UdpEgress)."""
        pub = self.publishes[t.feed]
        if callable(pub) and not hasattr(pub, "send"):
            pub(t.sector, t.elevation, zdb, zdr)
            return
        v2 = self._pub_v2.get(t.feed)
        if v2 is None:
            # the arity once, by signature: a call that catches TypeError
            # would take an error raised inside a v2 send for a v1
            # signature and call it again with zdb as the elevation
            try:
                v2 = len(inspect.signature(pub.send).parameters) >= 4
                self._pub_v2[t.feed] = v2
            except (TypeError, ValueError):
                # no signature to read: probe once by call
                try:
                    pub.send(t.sector, t.elevation, zdb, zdr)
                    self._pub_v2[t.feed] = True
                except TypeError:
                    pub.send(t.sector, zdb, zdr)
                    self._pub_v2[t.feed] = False
                return
        if v2:
            pub.send(t.sector, t.elevation, zdb, zdr)
        else:
            pub.send(t.sector, zdb, zdr)

    def _process_batch(self, tasks):
        """Synchronous dispatch + complete (debug_sync / tests)."""
        return self._complete_batch(self._dispatch_batch(tasks))

    def _stall_watch(self, what: str) -> _StallWatchdog:
        """A watchdog armed only in lock-step mode: a single-rank step
        cannot block on a peer."""
        def _count():
            self.stall_warnings += 1

        return _StallWatchdog(
            what, self.stall_warning_s if self.lockstep else None,
            on_warn=_count,
            timeout_s=self.collective_timeout_s if self.lockstep else None,
            on_timeout=self._collective_abort)

    def _collective_abort(self, what: str, waited: float):
        """The bounded exit of collective_timeout_s: save every volume
        checkpoint, write the stats to stderr, exit code 3.

        Runs on the watchdog thread while the compute thread is blocked
        inside a collective that nothing on the host can free, so it ends
        the process itself (os._exit: finally blocks and atexit would need
        the blocked thread).  Saving is safe: a volume changes only in the
        epilogue of a completed batch, and the compute thread is stuck
        before it."""
        log.error(
            "lock-step %s blocked/failed for %.1fs (collective timeout "
            "%.1fs): a peer rank is gone; saving the volume checkpoint and "
            "exiting 3; restart every rank with --checkpoint to resume this "
            "volume", what, waited, self.collective_timeout_s or 0.0)
        try:
            for vol in self.volumes:
                if vol is not None and vol.path is not None:
                    vol.save()
                    self.checkpoints_written += 1
                    log.info("volume checkpoint saved to %s (%.1f%% covered)",
                             vol.path, 100 * vol.fraction())
        except Exception as e:   # a bad disk must not block the exit
            log.error("checkpoint save failed during abort: %s", e)
        try:
            sys.stderr.write(json.dumps(self.stats(self._processed)) + "\n")
            sys.stderr.flush()
        except Exception:
            pass
        os._exit(3)

    def _maybe_checkpoint(self):
        """Periodic crash-safe volume save (VolumeScan.save is atomic)."""
        vols = [v for v in self.volumes if v is not None and v.path is not None]
        if not vols or self.checkpoint_every_s is None:
            return
        now = time.monotonic()
        if now - self._last_checkpoint >= self.checkpoint_every_s:
            with self.timers.time("checkpoint/save"):
                for v in vols:
                    v.save()
            self._last_checkpoint = now
            self.checkpoints_written += 1

    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Run the chain once on zeros of the staging shape before ingest
        starts (builds the CUDA kernel library at first use; a first-batch
        stall would overflow the UDP receive buffer and drop sectors)."""
        if self._device is None:
            if self._proc_takes_labels:
                # all-padding labels: a multi-rank processor's alignment
                # check runs here too, so its first collective (NCCL builds
                # its communicator there, ~1 s) happens before ingest
                zdb, _ = self.processor(
                    self._host_np[0],
                    labels=np.full((self.batch, 2), -1, np.int32))
            else:
                zdb, _ = self.processor(self._host_np[0])
        elif self._cuda:
            zdb, _ = self.processor(self._dev[0])
            torch.cuda.synchronize(self._device)
        else:
            zdb, _ = self.processor(self._host[0])
        _to_host(zdb)

    def run(self) -> dict:
        """Blocking steady-state loop; returns a stats summary."""
        with self.timers.time("compute/warmup"):
            self.warmup()
        log.info("warmup complete, ingest starting (%d feed%s)",
                 max(1, len(self.transports)),
                 "s" if len(self.transports) > 1 else "")
        self._ingest_threads = [
            threading.Thread(target=self._ingest_loop, args=(k,),
                             daemon=True, name=f"wrp-ingest-{k}")
            for k in range(max(1, len(self.transports)))
        ]
        for t in self._ingest_threads:
            t.start()
        if self.on_ready is not None:
            self.on_ready()
        processed = 0
        next_progress = 100
        # Two-deep software pipeline: while batch k computes, batch k+1 is
        # drained, staged and dispatched; only then is batch k fetched.
        # debug_sync degrades to fully synchronous batches.
        pending = None

        def complete_pending(replace=None):
            # swap `pending` out BEFORE completing it, so an interrupt
            # mid-completion neither publishes a batch twice nor orphans
            # a just-dispatched one
            nonlocal pending, processed
            p, pending = pending, replace
            if p is not None:
                processed += self._complete_batch(p)

        try:
            while True:
                can_fill = (self._queue.qsize() >= self.batch
                            if self.lockstep else not self._queue.empty())
                if pending is not None and not can_fill:
                    # nothing to overlap with: publish now rather than sit
                    # on finished results while waiting for the wire (in
                    # lock-step mode, for a full batch)
                    complete_pending()
                tasks = self._drain_batch()
                if tasks is None:
                    break
                complete_pending(replace=self._dispatch_batch(tasks))
                if self.debug_sync:
                    complete_pending()
                if processed >= next_progress:
                    log.info("processed %d sectors (%.1f/s)", processed,
                             self.throughput.rate())
                    while processed >= next_progress:
                        next_progress += 100
            complete_pending()
        except KeyboardInterrupt:
            log.info("interrupted after %d sectors, shutting down", processed)
            complete_pending()
        finally:
            self._stop.set()
            for t in self._ingest_threads:
                t.join(timeout=5)
        if self._ingest_error is not None:
            raise self._ingest_error
        return self.stats(processed)

    def stop(self) -> None:
        """End a running `run()` from another thread: ingest stops taking
        sectors, `run()` processes what is already queued, joins its
        ingest threads and returns its stats."""
        self._stop.set()

    def stats(self, processed: int) -> dict:
        out = {
            "processed_sectors": processed,
            "bad_headers": self.bad_headers,
            "stall_warnings": self.stall_warnings,
            "batches": self.batches,
            "checkpoints_written": self.checkpoints_written,
            "sectors_per_second": round(self.throughput.overall(), 2),
            "active_sectors_per_second": round(self.throughput.active_rate(), 2),
            "latency_ms": self.latency.summary(),
            "timers": self.timers.summary(),
            "device": (torch.cuda.get_device_name(self._device) if self._cuda
                       else str(self._device)),
            "transport": dataclasses.asdict(self.transport.stats)
            if hasattr(self.transport, "stats") else {},
        }
        if len(self.transports) > 1:
            out["feeds"] = [
                {"processed_sectors": self._feed_processed[k],
                 "latency_ms": self.feed_latencies[k].summary(),
                 "transport": dataclasses.asdict(tr.stats)
                 if hasattr(tr, "stats") else {}}
                for k, tr in enumerate(self.transports)
            ]
        return out
