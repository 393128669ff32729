"""In-process metrics registry: counters, gauges, latency histograms.

Counterpart of echo_tts_tpu/serve/metrics.py, copied as it is (pure
Python).

The reference worker has structured logging with request_id threading but
NO metrics export (SURVEY.md §5 — "No metrics export"); its only
operational introspection is the health-check action
(reference: handler.py:609-679).  This module fills that gap the
framework way: a tiny thread-safe registry the serving layer updates
inline (requests/errors/queue depth/batch occupancy/per-stage latency/
rolling RTF+TTFA), snapshotted into the health-check envelope, the
`{"action": "metrics"}` job, and an optional JSON metrics file
(ECHO_METRICS_FILE) written after each handled job — pull-friendly for
any scraper without taking a dependency on a metrics client library
(no network egress assumptions, matching serve/storage.py's stance).

Histograms keep lifetime count/sum/min/max plus a bounded ring of recent
observations for percentiles — O(window) memory forever, and the
percentiles reflect CURRENT behavior (a latency regression shows up
immediately instead of being averaged into a long uptime).
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Dict, List, Optional, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset",
    "write_metrics_file",
]


class Counter:
    """Monotonic counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self) -> None:
        self._value: Union[int, float] = 0

    def set(self, value: Union[int, float]) -> None:
        self._value = value

    @property
    def value(self) -> Union[int, float]:
        return self._value

    def snapshot(self) -> Union[int, float]:
        return self._value


class Histogram:
    """Lifetime count/sum/min/max + recent-window percentiles."""

    def __init__(self, window: int = 512) -> None:
        self._lock = threading.Lock()
        self._window = int(window)
        self._ring: List[float] = []
        self._next = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._ring) < self._window:
                self._ring.append(v)
            else:
                self._ring[self._next] = v
                self._next = (self._next + 1) % self._window

    def snapshot(self) -> Dict:
        with self._lock:
            recent = sorted(self._ring)
            count, total = self.count, self.sum
            lo, hi = self.min, self.max

        def pct(q: float) -> Optional[float]:
            if not recent:
                return None
            idx = min(len(recent) - 1,
                      max(0, int(round(q * (len(recent) - 1)))))
            return recent[idx]

        return {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else None,
            "min": lo, "max": hi,
            "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            "window": len(recent),
        }


class MetricsRegistry:
    """Thread-safe name -> metric map; get-or-create with type checking."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(**kw)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 512) -> Histogram:
        return self._get(name, Histogram, window=window)

    def snapshot(self) -> Dict:
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def reset(self) -> None:
        """Drop every metric (tests; a fresh worker starts empty anyway)."""
        with self._lock:
            self._metrics.clear()


# The process-wide default registry the serving layer writes to.
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, window: int = 512) -> Histogram:
    return REGISTRY.histogram(name, window=window)


def snapshot() -> Dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


def write_metrics_file(path: str,
                       registry: Optional[MetricsRegistry] = None,
                       extra: Optional[Dict] = None) -> None:
    """Atomically dump a JSON snapshot (tmp + rename, so a scraper never
    reads a half-written file)."""
    reg = registry if registry is not None else REGISTRY
    payload = {"time": time.time(), "metrics": reg.snapshot()}
    if extra:
        payload.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
