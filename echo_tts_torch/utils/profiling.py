"""Tracing / profiling hooks.

Counterpart of echo_tts_tpu/utils/profiling.py.  The reference has
wall-clock phase timers only (handler.py:342-409, gradio_app.py:203,
284-285).  Here:

  * the span recorder: `span(name, **attrs)` around a piece of host work,
    kept in a bounded in-memory ring that `spans()` copies out.  It is
    always on, at request and pass-stage granularity (serve/server.py's
    queue, gather and pass, serve/batcher.py's host stages,
    utils/programs.py's builds), and it is the one record of them: the
    benchmark's per-layer readers, the warm-up report, StageTimer and
    trace() all read it;
  * StageTimer: accumulating per-stage wall timing (voice encode /
    synthesis / host DSP / upload) with a structured report, the RTF
    bookkeeping of the serving envelope; each stage is a span;
  * trace(): a context manager around torch.profiler, over every thread,
    that writes a Chrome trace (chrome://tracing, Perfetto) of the host
    and, on a card, the device, with the recorder's spans of its window
    beside them, in place of jax.profiler;
  * the timers of the card's work that chip_smoke.py, the tools and the
    bench modules (examples/bench_*.py) share: `wall_ms` (a stage on the
    host clock between two synchronises), `device_ms` (CUDA events around
    back-to-back calls), `timed` (torch.profiler's sum of a call's device
    intervals), `host_us_paired`, and `bound` with the H100's published
    peaks.

The spans' clock.  Stamps are Unix-epoch nanoseconds (`now_ns`,
time.time_ns), the timebase torch.profiler converts its host and device
events to, so that a span and an interval of a profiler trace compare
directly (tests/test_torch_spans.py holds the two within a millisecond).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

# the spans' clock (module docstring)
now_ns = time.time_ns

# spans the ring keeps; about 20 a server pass
RING_SPANS = 1 << 16


class Span:
    """One span: its name, start and end (now_ns), its own id, its
    parent's (the span open on the same thread when it began), the
    thread's native id and its attributes.  As a context manager it
    times its body on the calling thread; a span whose body raised
    carries the exception's type under `error`."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "thread",
                 "attrs", "_recorder")

    def __init__(self, recorder: "SpanRecorder", name: str, attrs: dict,
                 start_ns: int = 0, end_ns: int = 0,
                 parent: Optional[int] = None, thread: int = 0):
        self._recorder = recorder
        self.name, self.attrs = name, attrs
        self.start_ns, self.end_ns = start_ns, end_ns
        self.id = next(recorder._ids)
        self.parent, self.thread = parent, thread

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack, self.thread = self._recorder._open()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start_ns = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = now_ns()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack, _ = self._recorder._open()
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        self._recorder._keep(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}..{self.end_ns}, "
                f"id={self.id}, parent={self.parent}, thread={self.thread}, "
                f"{self.attrs})")


class SpanRecorder:
    """The spans of a process, the last `capacity` kept (thread-safe).
    Nothing is written anywhere: `spans()` copies them out."""

    def __init__(self, capacity: int = RING_SPANS):
        self._ring: "collections.deque[Span]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _open(self):
        """(this thread's stack of open spans, its native id)."""
        local = self._local
        try:
            return local.stack, local.thread
        except AttributeError:
            local.stack, local.thread = [], threading.get_native_id()
            return local.stack, local.thread

    def _keep(self, s: Span) -> None:
        with self._lock:
            self._ring.append(s)

    def span(self, name: str, **attrs) -> Span:
        """A span of the body of a `with` on this thread."""
        return Span(self, name, attrs)

    def record(self, name: str, start_ns: int, end_ns: int, *,
               thread: Optional[int] = None, **attrs) -> Span:
        """A span whose times were taken elsewhere (a request's wait in a
        queue, from its submit on a caller's thread), kept as it is:
        a root, on `thread` (default: this one)."""
        s = Span(self, name, attrs, start_ns, end_ns, None,
                 self._open()[1] if thread is None else thread)
        self._keep(s)
        return s

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread, or None."""
        stack, _ = self._open()
        return stack[-1] if stack else None

    def annotate(self, **attrs) -> None:
        """Add attributes to the innermost span open on this thread; a
        no-op when none is open."""
        s = self.current()
        if s is not None:
            s.attrs.update(attrs)

    def spans(self, since_ns: Optional[int] = None) -> List[Span]:
        """A copy of the kept spans, in the order they ended; with
        since_ns, those that ended at or after it."""
        with self._lock:
            out = list(self._ring)
        if since_ns is not None:
            out = [s for s in out if s.end_ns >= since_ns]
        return out


RECORDER = SpanRecorder()
span = RECORDER.span
record = RECORDER.record
current = RECORDER.current
annotate = RECORDER.annotate
spans = RECORDER.spans


class StageTimer:
    """Accumulating wall-clock stage timer; each stage is a span of its
    name.

    with timer.stage("synthesis"):
        ...
    timer.report() -> {"synthesis": {"seconds": ..., "calls": ...}, ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        s = span(name)
        try:
            with s:
                yield
        finally:
            self._acc.setdefault(name, []).append(s.seconds)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"seconds": round(sum(v), 4), "calls": len(v)}
            for name, v in self._acc.items()
        }

    def total(self) -> float:
        return sum(sum(v) for v in self._acc.values())

    def rtf(self, audio_seconds: float) -> float:
        """Audio-seconds per wall-second over everything timed so far."""
        t = self.total()
        return audio_seconds / t if t > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: str = "echo_tts_trace"):
    """Profile the body with torch.profiler, on every thread of the
    process, and write its Chrome trace to `log_dir`/trace.json with the
    recorder's spans of the window added (category "span", on their
    threads, in the trace's timebase); yields that path.  CUDA activity
    is recorded when a card is present."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        t0 = now_ns()
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = now_ns()
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans(since_ns=t0) if s.start_ns <= t1])


def _add_spans(path: str, kept: List[Span]) -> None:
    """Write spans into the Chrome trace at `path` as complete events.
    The trace's `ts` is microseconds after its `baseTimeNanoseconds`
    (Unix-epoch nanoseconds, the spans' clock)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": dict(s.attrs, id=s.id, parent=s.parent)}
        for s in kept)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)


# ---------------------------------------------------------------------------
# Timing on the card, shared by chip_smoke.py, the tools and the bench
# modules (echo_tts_torch/examples/bench_*.py)
# ---------------------------------------------------------------------------

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 and int8
# tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# torch.profiler traces `timed` takes before it reads CUDA events instead
TRACES = 5


def sync() -> None:
    """Wait for the card, when this process has used one; a no-op on the
    CPU."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def wall_ms(fn, reps: int = 1):
    """(the last call's result, [host-clock ms of each of `reps` calls of
    fn]), each call between two synchronises of the card."""
    out, runs = None, []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        runs.append((time.perf_counter() - t0) * 1e3)
    return out, runs


def device_ms(fn, reps: int) -> float:
    """One call's device time (call it after a warm-up): CUDA events around
    `reps` calls queued back to back, over reps (the gaps between the
    calls' work included).  On the CPU, the host clock around the same
    calls."""
    import torch
    if not torch.cuda.is_initialized():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int, log=_log, check_calls: bool = True) -> dict:
    """One call of fn, after a warm-up: `ms`, its device time, the sum of
    the device intervals (kernels, copies, sets) that `reps` calls queue,
    as torch.profiler reads them, over reps; `by_name`, that sum split by
    kernel name; `host_us`, the host's microseconds to issue one call (the
    wall time of `reps` calls queued without a synchronise, over reps);
    `timer`, what read `ms`.

    Every call queues the same device work, so a whole trace holds each
    name's events a positive multiple of `reps` times.  The profiler now
    and then drops some of a kernel's events, which would read several
    times too fast, and a trace that does so is taken again.  After
    TRACES such traces `ms` is read with CUDA events instead: the device's
    elapsed time from before the first of `reps` calls to after the last,
    over reps.  That time holds the gaps between the calls' work too, so
    it is never below the profiler's sum; `by_name` is then empty.
    check_calls=False is for a function whose event counts need not be a
    multiple of reps: its first trace is read as it is."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, count = {}, {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                span = (ev.time_range.end - ev.time_range.start) / 1e3 / reps
                by_name[ev.name] = by_name.get(ev.name, 0.0) + span
                count[ev.name] = count.get(ev.name, 0) + 1
        short = {k[:60]: n for k, n in count.items()
                 if n % reps and check_calls}
        ms = sum(by_name.values())
        if ms > 0 and not short:
            return dict(ms=ms, by_name=by_name, host_us=host_us,
                        timer="profiler")
        log(f"  (torch.profiler: device time {ms:.4f} ms, events not a "
            f"multiple of {reps} calls: {short}; tracing again)")
    ms = device_ms(fn, reps)
    log(f"  (torch.profiler dropped device events in {TRACES} traces of "
        f"{reps} calls: {ms:.4f} ms per call read with CUDA events)")
    return dict(ms=ms, by_name={}, host_us=host_us, timer="cuda events")


def host_us_paired(fn_a, fn_b, reps: int = 50, rounds: int = 41) -> dict:
    """The host's microseconds to issue one call of fn_a and of fn_b:
    rounds of `reps` calls each, the two in turns (a, b, b, a, ...), each
    round ended by a synchronise.  `a_us` and `b_us` are the median round
    of each; `diff_us` the median of the rounds' differences b - a, with
    its quartiles in `diff_q_us`.  Turns keep a drift of the shared host's
    load out of the difference; the quartiles say whether it is resolved
    (both on one side of 0)."""
    import numpy as np
    import torch
    times = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            fn = (fn_a, fn_b)[i]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[i].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    diff = np.subtract(times[1], times[0])
    return dict(a_us=float(np.median(times[0])),
                b_us=float(np.median(times[1])),
                diff_us=float(np.median(diff)),
                diff_q_us=[float(x) for x in np.percentile(diff, [25, 75])])


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple:
    """(ms, what bounds it): the larger of ops at the operand type's peak
    rate and bytes at the memory rate."""
    t_ops = ops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
