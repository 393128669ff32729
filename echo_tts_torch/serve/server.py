"""Concurrent micro-batching server loop.

Counterpart of echo_tts_tpu/serve/server.py.  The reference scales by
share-nothing queue workers (one request at a time per GPU, SURVEY.md
§2e); here one card is fed by coalescing concurrent requests into one
batch (serve/batcher.py).  Callers submit from any thread and receive a
Future; a single executor thread drains the queue, groups compatible
requests (identical sampler params), pads speaker references to a shared
bucket, runs one batched sampler+decode pass, and resolves the futures.

One executor thread == one device stream: serializing device work through
one loop keeps device memory bounded and batches maximal.

Production hardening (beyond the reference's error envelope,
reference: handler.py:797-803):

  * BOUNDED intake: the queue holds at most `max_queue` requests;
    `submit` on a full queue raises QueueFullError immediately instead of
    accepting work the device cannot keep up with (backpressure the
    caller can convert to a 429/try-later).
  * Per-request DEADLINES: `deadline_s` (per-submit or server default)
    bounds time-to-result.  Expired requests are failed with
    TimeoutError at dispatch time, and a watchdog fails the futures of an
    IN-FLIGHT batch whose device call outlives the tightest deadline, so
    that a wedged device call does not strand every submitted Future (the
    executor thread itself keeps waiting on the device, but callers get
    their Timeout and intake keeps backpressuring via the bound).
  * CANCELLATION: a Future cancelled before its batch dispatches is
    dropped from the group (set_running_or_notify_cancel).
  * SHUTDOWN drains in-flight work by default; `shutdown(drain=False)`
    cancels everything still queued instead (futures -> CancelledError).
  * OBSERVABILITY: `stats()` exposes queue depth / in-flight / totals
    (surfaced by serve.handler.health_check), the serve.metrics registry
    tracks batch occupancy and queue depth, and a rate-limited warning
    logs when the queue backs up.

The JAX server pads every group to a batch-size bucket
(presets.batch_size_buckets) because each distinct batch size compiles
its own XLA program.  An eager PyTorch pass compiles nothing per shape,
so here a group runs at its own size.  The batch's rows are independent
(per-row noise, per-row masks), so no request's output depends on the
group it lands in beyond float reduction order.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from ..pipeline.pipeline import EchoModels
from . import metrics
from .batcher import BatchRequest, BatchResult, group_compatible, run_batch

log = logging.getLogger("echo_tts_torch.serve")

# Queue-depth warning threshold (fraction of max_queue) and rate limit.
_WARN_FRACTION = 0.5
_WARN_INTERVAL_S = 10.0


class QueueFullError(RuntimeError):
    """Raised by submit() when the bounded intake queue is full — the
    caller should shed load (HTTP 429 / retry-later), not block."""


@dataclasses.dataclass
class _Item:
    request: BatchRequest
    params: Dict
    future: Future
    enqueue_t: float
    deadline_s: Optional[float]

    def remaining(self, now: float) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (now - self.enqueue_t)


class MicroBatchServer:
    def __init__(self, models: EchoModels, *, max_batch: int = 8,
                 max_wait_s: float = 0.05,
                 speaker_bucket: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        self.models = models
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.speaker_bucket = speaker_bucket
        # Default bound: generous (16 batches' worth) but finite — an
        # unbounded queue turns a wedged device into unbounded memory and
        # unbounded client latency with no signal.
        self.max_queue = (16 * max_batch if max_queue is None
                          else int(max_queue))
        self.deadline_s = deadline_s
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue(
            maxsize=self.max_queue)
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()  # orders submit vs shutdown
        # Serializes DEVICE work: the executor holds it per batched pass,
        # and co-resident non-queue work (a streaming job or an uncached
        # voice encode beside this server, serve/handler) must hold it
        # too, so that a B=8 sampler+decode and a stream's K/V never sit
        # in device memory at once.
        self.device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._expired = 0
        self._cancelled = 0
        self._batches = 0
        self._batched_requests = 0
        self._in_flight = 0
        self._last_warn_t = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="echo-batch-executor")
        self._thread.start()

    def submit(self, request: BatchRequest,
               sampler_params: Optional[Dict] = None,
               deadline_s: Optional[float] = None) -> "Future[BatchResult]":
        """Thread-safe; returns a Future resolving to a BatchResult.

        `deadline_s` (or the server default) bounds time-to-result: the
        future fails with TimeoutError if the result isn't produced in
        time.  Raises QueueFullError when the bounded queue is full."""
        with self._submit_lock:
            # check-then-put under the same lock as shutdown's set-then-put,
            # so no request can land behind the stop sentinel unserviced
            if self._stop.is_set():
                raise RuntimeError("server is shut down")
            fut: Future = Future()
            item = _Item(request=request,
                         params=dict(sampler_params or {}), future=fut,
                         enqueue_t=time.monotonic(),
                         deadline_s=(self.deadline_s if deadline_s is None
                                     else deadline_s))
            try:
                self._q.put_nowait(item)
            except queue.Full:
                raise QueueFullError(
                    f"batch queue full ({self.max_queue} requests) — the "
                    "device is not keeping up; shed load and retry") \
                    from None
            with self._stats_lock:
                self._submitted += 1
            self._observe_depth()
            return fut

    def stats(self) -> Dict:
        """Operational snapshot (surfaced by health_check)."""
        with self._stats_lock:
            return {
                "queue_depth": self._q.qsize(),
                "max_queue": self.max_queue,
                "max_batch": self.max_batch,
                "in_flight": self._in_flight,
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "expired": self._expired,
                "cancelled": self._cancelled,
                "batches": self._batches,
                "mean_occupancy": (
                    round(self._batched_requests / self._batches, 3)
                    if self._batches else None),
                "shutdown": self._stop.is_set(),
            }

    def shutdown(self, wait: bool = True, drain: bool = True) -> None:
        """Stop accepting work.  drain=True (default) finishes everything
        already queued; drain=False cancels queued futures immediately
        (in-flight device work still completes — it cannot be
        interrupted)."""
        with self._submit_lock:
            self._stop.set()
            if not drain:
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None and item.future.cancel():
                        with self._stats_lock:
                            self._cancelled += 1
            self._q.put(None)  # wake the loop
        if wait:
            self._thread.join()

    # ------------------------------------------------------------------
    def _observe_depth(self) -> None:
        depth = self._q.qsize()
        metrics.gauge("batch_queue_depth").set(depth)
        if depth >= max(1, int(_WARN_FRACTION * self.max_queue)):
            now = time.monotonic()
            with self._stats_lock:
                warn = now - self._last_warn_t >= _WARN_INTERVAL_S
                if warn:
                    self._last_warn_t = now
            if warn:
                log.warning(
                    "batch queue depth %d/%d — device falling behind "
                    "(long stream holding device_lock, or a wedged "
                    "device call)", depth, self.max_queue)

    def _drain(self) -> List[_Item]:
        """Block for one item, then opportunistically gather more for up to
        max_wait_s (or until max_batch)."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        while len(items) < self.max_batch:
            try:
                nxt = self._q.get(timeout=self.max_wait_s)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-signal stop after this batch
                break
            items.append(nxt)
        return items

    def _run_group(self, group: List[_Item]) -> None:
        now = time.monotonic()
        live: List[_Item] = []
        for it in group:
            rem = it.remaining(now)
            if rem is not None and rem <= 0:
                # expired while queued: fail before paying device time
                if not it.future.done():
                    it.future.set_exception(TimeoutError(
                        f"request expired in queue after "
                        f"{now - it.enqueue_t:.2f}s "
                        f"(deadline {it.deadline_s}s)"))
                with self._stats_lock:
                    self._expired += 1
                continue
            # cancellation point: a future cancelled before dispatch is
            # dropped from the batch (after this call it can no longer
            # be cancelled — it is "running")
            if not it.future.set_running_or_notify_cancel():
                with self._stats_lock:
                    self._cancelled += 1
                continue
            live.append(it)
        if not live:
            return

        # Watchdog for the in-flight batch: if the device call outlives
        # the tightest remaining deadline, fail those futures with
        # TimeoutError NOW — callers unblock even if the device never
        # returns.  The late device result is discarded (done() guard).
        batch_done = threading.Event()
        watchdog_box: List[Optional[threading.Timer]] = [None]

        def _arm_watchdog():
            if batch_done.is_set():
                return
            n = time.monotonic()
            pending = [it.remaining(n) for it in live
                       if it.deadline_s is not None
                       and not it.future.done()]
            if not pending:
                return
            t = threading.Timer(max(min(pending), 1e-3), _expire_inflight)
            t.daemon = True
            watchdog_box[0] = t
            t.start()

        def _expire_inflight():
            n = time.monotonic()
            for it in live:
                r = it.remaining(n)
                if r is not None and r <= 0 and not it.future.done():
                    it.future.set_exception(TimeoutError(
                        "request exceeded deadline "
                        f"{it.deadline_s}s while in flight"))
                    with self._stats_lock:
                        self._expired += 1
            _arm_watchdog()  # re-arm for later deadlines in this batch

        _arm_watchdog()

        with self._stats_lock:
            self._in_flight = len(live)
        try:
            with self.device_lock:
                results = run_batch(
                    self.models, [it.request for it in live], live[0].params,
                    speaker_bucket=self.speaker_bucket)
            done = 0
            for it, res in zip(live, results):
                if not it.future.done():  # watchdog may have expired it
                    it.future.set_result(res)
                    done += 1
            with self._stats_lock:
                self._completed += done
                self._batches += 1
                self._batched_requests += len(live)
            metrics.histogram("batch_occupancy").observe(len(live))
        except Exception as exc:
            n_failed = 0
            for it in live:
                if not it.future.done():
                    it.future.set_exception(exc)
                    n_failed += 1
            with self._stats_lock:
                self._failed += n_failed
        finally:
            batch_done.set()
            if watchdog_box[0] is not None:
                watchdog_box[0].cancel()
            with self._stats_lock:
                self._in_flight = 0
            self._observe_depth()

    def _loop(self) -> None:
        while not (self._stop.is_set() and self._q.empty()):
            items = self._drain()
            if not items:
                break
            groups = group_compatible(
                [(it.request, it.params) for it in items], self.max_batch)
            for idx_group in groups:
                self._run_group([items[i] for i in idx_group])
