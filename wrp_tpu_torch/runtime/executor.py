"""Streaming executor: the reference's v1 stream-cascade pipeline
(gpu_1fp_streamcasc.cu:485-737) on one CUDA device.

Counterpart of ``wrp_tpu/runtime/executor.py`` (single-host).  Two threads
and a two-deep batch pipeline:

  ingest thread:  transport recv -> numpy decode (int16 planar, natural row
                  order) -> queue
  compute thread: drain batch k+1 -> stage it in a pinned ping-pong buffer
                  -> H2D on the copy stream -> dispatch the chain on the
                  compute stream once the copy's event fires -> only then
                  fetch batch k's products -> egress + volume accumulation

While the device runs batch k, the ingest thread decodes batch k+2 and the
compute thread stages batch k+1.  Adds what the reference lacked: receive
timeouts with drop-and-resync, sector/elevation tracking, volume
checkpointing, per-stage timers and end-to-end latency.

Left for later (ROADMAP.md): the lock-step multi-host mode with its stall
watchdog and collective timeout, and the on-device wire decode.
"""

from __future__ import annotations

import dataclasses
import inspect
import queue
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
    planar: np.ndarray          # [C, 2, m, n] int16, natural row order
    sector: int
    elevation: int
    feed: int = 0               # which ingest transport produced it
    t_recv: float = 0.0         # perf_counter at wire arrival (0 = unknown)


def _to_host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


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
               planar batch [batch, C, 2, m, n] (numpy; plus `labels=` rows
               of (sector, elevation) if it takes them) and returning
               (zdb, zdr).  It owns its device placement.  Default: a
               SectorProcessor(method, device) fed through pinned staging.
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
    ):
        """idle_limit: stop after this many consecutive idle receive
        timeouts (None = listen forever, the service default).

        checkpoint_every_s: with a volume that has a checkpoint path, save
        it at most this often (<= 0 after every batch, None only at exit).

        on_ready: called once warmup is done and ingest is listening — the
        point where a producer can start without overflowing the receive
        buffer.

        device: where the default processor runs; "cuda" (the default)
        raises on a host without CUDA rather than running on the CPU."""
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
        # reference counters (rpv2.cu:46-51, advance() :572-579), per feed
        self._pos = [[0, 0] for _ in range(nfeeds)]

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
            self.processor = SectorProcessor(cfg, method=method, device=device)
            self._device = self.processor.device
        self._cuda = self._device is not None and self._device.type == "cuda"

        # Ping-pong batch staging: two host slots (pinned when the device
        # is a GPU, so the H2D can run asynchronously on the copy stream)
        # and, on the GPU, two device slots.  Slot i is reused at dispatch
        # k+2.  Unlike jax.device_put, a torch non_blocking copy reads the
        # pinned host memory AFTER it returns, so before rewriting host
        # slot i the host waits on `_copied[i]`, the event of that slot's
        # last H2D; and the copy into device slot i waits on `_computed[i]`,
        # the event of the compute that last read it.
        shape = (batch, cfg.num_channels, 2, cfg.m, cfg.n)
        self._host = [torch.zeros(shape, dtype=torch.int16,
                                  pin_memory=self._cuda) for _ in range(2)]
        self._host_np = [h.numpy() for h in self._host]
        self._stage_rows = [0, 0]
        self._stage_idx = 0
        self._copied: list = [None, None]
        self._computed: list = [None, None]
        if self._cuda:
            self._dev = [torch.zeros(shape, dtype=torch.int16,
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
                    # Natural row order always: the fused kernel reads the
                    # radix branches by index arithmetic, so there is no
                    # radix-ordered decode here and no counterpart of
                    # wrp_tpu's executor quietly assuming input_radix=1
                    # for a processor that does not advertise its order.
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
        """Collect up to `batch` queued sectors (at least one, else None)."""
        nfeeds = max(1, len(self.transports))
        item = None
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
                continue
            if item is None:            # one feed reached end-of-stream
                self._eof_feeds += 1
                if self._eof_feeds >= nfeeds:
                    return None
        tasks = [item]
        while len(tasks) < self.batch:
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
        if self._device is None:      # processor override
            t_dispatch = time.perf_counter()
            with self.timers.time("compute/dispatch"):
                if self._proc_takes_labels:
                    labels = np.full((self.batch, 2), -1, np.int32)
                    for i, t in enumerate(tasks):
                        labels[i] = (t.sector, t.elevation)
                    zdb, zdr = self.processor(self._host_np[idx],
                                              labels=labels)
                else:
                    zdb, zdr = self.processor(self._host_np[idx])
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
        with self.timers.time("compute/fetch"):
            if done is not None:
                done.synchronize()
            zdb = _to_host(zdb)[: len(tasks)]
            zdr = _to_host(zdr)[: len(tasks)]
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
            pub = self.publishes[t.feed]
            if pub is not None:
                with self.timers.time("egress/send"):
                    send = pub.send if hasattr(pub, "send") else pub
                    send(t.sector, t.elevation, zdb[k], zdr[k])
            self._feed_processed[t.feed] += 1
            if t.t_recv:
                dt = time.perf_counter() - t.t_recv
                self.latency.record(dt)
                self.feed_latencies[t.feed].record(dt)
        self.throughput.tick(len(tasks))
        self._processed += len(tasks)
        self._maybe_checkpoint()
        return len(tasks)

    def _process_batch(self, tasks):
        """Synchronous dispatch + complete (debug_sync / tests)."""
        return self._complete_batch(self._dispatch_batch(tasks))

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
        """Run the chain once before ingest starts (builds the CUDA kernel
        library at first use; a first-batch stall would overflow the UDP
        receive buffer and drop sectors)."""
        if self._device is None:
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
                if pending is not None and self._queue.empty():
                    # nothing to overlap with: publish now rather than sit
                    # on finished results while waiting for the wire
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

    def stats(self, processed: int) -> dict:
        out = {
            "processed_sectors": processed,
            "bad_headers": self.bad_headers,
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
