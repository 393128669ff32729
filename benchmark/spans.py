"""The program's own spans (echo_tts_torch/utils/profiling.py) for the
per-layer readers that read them (benchmark/metrics/*.py).

The program stamps its spans in Unix-epoch nanoseconds, the timebase of
the traced window's device intervals (harness.Trace), so a span and an
idle gap of the device compare directly.  The device's idle time in the
window (the window less the union of its device intervals) is split by
what the server's executor thread was doing at each instant: the
innermost span open on that thread, filed under the root span it lies
in:

  gather    `server.gather`: the batch held open for more rows
  host      `server.pass` and its children (run_batch's host stages, the
            device lock, resolving the futures)
  wait      `server.wait`: the queue empty, the offered load
  other     any other root span on that thread
  untraced  no span open on that thread: what the spans cannot see

A program without the recorder (no `utils.profiling.spans`) gives
nothing to read: every function here then returns None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import harness

CATEGORY = {"server.gather": "gather", "server.pass": "host",
            "server.wait": "wait"}


def program_spans() -> Optional[list]:
    """The spans the program kept, or None when it keeps none."""
    try:
        from echo_tts_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def idle_intervals(window: Tuple[int, int],
                   device: List[tuple]) -> List[Tuple[int, int]]:
    """The window less the union of the device intervals (start, end,
    ...), sorted."""
    w0, w1 = window
    gaps, last = [], w0
    for s, e, *_ in sorted(device):
        s, e = max(s, w0), min(e, w1)
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    return gaps


def innermost(thread_spans: list) -> List[Tuple[int, int, object]]:
    """One thread's time split by its innermost open span: (start, end,
    span) segments in order, the instants with no span open left out.
    Spans of one thread nest."""
    segs, stack, t = [], [], 0
    for s in sorted(thread_spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            if t < top.end_ns:
                segs.append((t, top.end_ns, top))
            t = max(t, top.end_ns)
        if stack and t < s.start_ns:
            segs.append((t, s.start_ns, stack[-1]))
        stack.append(s)
        t = s.start_ns
    while stack:
        top = stack.pop()
        if t < top.end_ns:
            segs.append((t, top.end_ns, top))
        t = max(t, top.end_ns)
    return segs


def executor_thread(spans: list, window: Tuple[int, int]) -> Optional[int]:
    """The thread that ran the most `server.pass` spans in the window."""
    counts: Dict[int, int] = {}
    for s in spans:
        if (s.name == "server.pass" and s.end_ns >= window[0]
                and s.start_ns <= window[1]):
            counts[s.thread] = counts.get(s.thread, 0) + 1
    return max(counts, key=counts.get) if counts else None


def split_idle(window: Tuple[int, int], device: List[tuple],
               spans: list) -> Optional[Dict[str, object]]:
    """The device's idle seconds in the window, in all (`idle`) and by
    category (module docstring), and under each innermost span's name
    (`by_span`); None without an executor thread."""
    thread = executor_thread(spans, window)
    if thread is None:
        return None
    mine = [s for s in spans if s.thread == thread]
    by_id = {s.id: s for s in mine}

    def category(s) -> str:
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
        return CATEGORY.get(s.name, "other")

    segs = [(a, b, s.name, category(s)) for a, b, s in innermost(mine)
            if b > window[0] and a < window[1]]
    gaps = idle_intervals(window, device)
    out = {k: 0 for k in ("gather", "host", "wait", "other")}
    by_span: Dict[str, int] = {}
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b, name, cat = segs[j]
            d = max(0, min(b, g1) - max(a, g0))
            out[cat] += d
            by_span[name] = by_span.get(name, 0) + d
            j += 1
    idle = sum(g1 - g0 for g0, g1 in gaps)
    res = {k: v / 1e9 for k, v in out.items()}
    res["untraced"] = (idle - sum(out.values())) / 1e9
    res["idle"] = idle / 1e9
    res["by_span"] = {k: v / 1e9 for k, v in by_span.items()}
    return res


def idle_split(ctx) -> Optional[Dict[str, object]]:
    """split_idle over the traced window, computed once a run and logged
    whole: the `wait` and `other` shares too, and the idle under each
    innermost span's name."""
    if not hasattr(ctx, "_idle_split"):
        spans = program_spans()
        res = (None if spans is None else
               split_idle(ctx.trace.window, ctx.trace.device, spans))
        ctx._idle_split = res
        if res is not None:
            w = ctx.trace.window_s
            harness.log("spans: device idle over the window (%): " + ", ".join(
                f"{k} {100.0 * v / w:.4f}" for k, v in res.items()
                if k != "by_span"))
            top = sorted(res["by_span"].items(), key=lambda kv: -kv[1])
            harness.log("spans: device idle under each innermost span (%): "
                        + ", ".join(f"{k} {100.0 * v / w:.4f}"
                                    for k, v in top))
    return ctx._idle_split


def idle_share(ctx, category: str) -> Optional[float]:
    """The device's idle time under `category`, over the window, in %."""
    res = idle_split(ctx)
    w = ctx.trace.window_s
    if res is None or w <= 0:
        return None
    return 100.0 * res[category] / w


def queue_wait_p90_ms(ctx) -> Optional[float]:
    """The nearest-rank p90 of the `server.queue` spans of requests
    dispatched inside the window, in ms."""
    spans = program_spans()
    if spans is None:
        return None
    w0, w1 = ctx.trace.window
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in spans
             if s.name == "server.queue"
             and s.attrs.get("outcome") == "dispatched"
             and w0 <= s.end_ns <= w1]
    return harness.percentile(waits, 0.9) if waits else None


def program_build_s(ctx) -> Optional[float]:
    """Seconds of the `program.build` spans (each miss's eager run and
    capture) that ended before the window, a build inside another's
    counted once."""
    spans = program_spans()
    if spans is None:
        return None
    builds = {s.id: s for s in spans if s.name == "program.build"}
    return sum(s.end_ns - s.start_ns for s in builds.values()
               if s.end_ns <= ctx.trace.window[0]
               and s.parent not in builds) / 1e9
