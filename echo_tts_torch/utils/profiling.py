"""Tracing / profiling hooks.

Counterpart of echo_tts_tpu/utils/profiling.py.  The reference has
wall-clock phase timers only (handler.py:342-409, gradio_app.py:203,
284-285).  Here:

  * StageTimer: accumulating per-stage wall timing (voice encode /
    synthesis / host DSP / upload) with a structured report, the RTF
    bookkeeping of the serving envelope (copied as it is);
  * trace(): a context manager around torch.profiler that writes a Chrome
    trace (chrome://tracing, Perfetto) of the host and, on a card, the
    device, in place of jax.profiler.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List


class StageTimer:
    """Accumulating wall-clock stage timer.

    with timer.stage("synthesis"):
        ...
    timer.report() -> {"synthesis": {"seconds": ..., "calls": ...}, ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc.setdefault(name, []).append(time.perf_counter() - t0)

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
    """Profile the body with torch.profiler and write its Chrome trace to
    `log_dir`/trace.json; yields that path.  CUDA activity is recorded
    when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
