"""benchmark/spans.py: the device's idle time split by the server
thread's innermost span, on synthetic intervals and spans; the queue wait
and the build seconds; and a tiny traced CPU cell in which every reader
of the program's spans returns a number."""
from __future__ import annotations

import json
import os
import time
import types

import pytest

from benchmark import harness, spans


def _span(id, name, start, end, parent=None, thread=7, **attrs):
    return types.SimpleNamespace(id=id, name=name, start_ns=start,
                                 end_ns=end, parent=parent, thread=thread,
                                 attrs=attrs)


# the executor (thread 7): wait, gather, a pass with two children, a
# root of another name, nothing, wait; a request's queue span on thread 8
SPANS = [
    _span(1, "server.wait", 0, 150),
    _span(2, "server.gather", 150, 300),
    _span(3, "server.pass", 300, 700),
    _span(4, "batch.text", 300, 350, parent=3),
    _span(5, "server.resolve", 650, 700, parent=3),
    _span(6, "custom", 700, 750),
    _span(7, "server.wait", 800, 1000),
    _span(8, "server.queue", 0, 1000, thread=8, outcome="dispatched"),
]
DEVICE = [(100, 200, "k"), (400, 600, "k"), (900, 950, "k")]


def test_innermost_splits_a_thread_by_its_deepest_open_span():
    segs = spans.innermost([s for s in SPANS if s.thread == 7])
    assert [(a, b, s.id) for a, b, s in segs] == [
        (0, 150, 1), (150, 300, 2), (300, 350, 4), (350, 650, 3),
        (650, 700, 5), (700, 750, 6), (800, 1000, 7)]


def test_idle_gaps_split_by_category():
    """Idle [0, 100) under wait; [200, 400) half gather, half the pass
    (its text stage, then itself); [600, 900) the pass, its resolve,
    another root, no span, wait; [950, 1000) wait.  Only the executor's
    spans count, and the categories add up to the idle time."""
    assert spans.idle_intervals((0, 1000), DEVICE) == [
        (0, 100), (200, 400), (600, 900), (950, 1000)]
    got = spans.split_idle((0, 1000), DEVICE, SPANS)
    by_span = got.pop("by_span")
    want = {"wait": 250, "gather": 100, "host": 200, "other": 50,
            "untraced": 50, "idle": 650}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert by_span == pytest.approx({k: v / 1e9 for k, v in {
        "server.wait": 250, "server.gather": 100, "batch.text": 50,
        "server.pass": 100, "server.resolve": 50, "custom": 50}.items()})
    assert sum(got[k] for k in ("wait", "gather", "host", "other",
                                "untraced")) == pytest.approx(got["idle"])


def test_a_gap_with_no_span_is_untraced_and_no_server_reads_none():
    device = [(0, 400, "k"), (600, 1000, "k")]
    gap_only = [_span(1, "server.pass", 100, 300)]
    got = spans.split_idle((0, 1000), device, gap_only)
    assert got["untraced"] == pytest.approx(200 / 1e9)
    assert got["host"] == 0
    assert spans.split_idle((0, 1000), device, [_span(1, "x", 0, 9)]) is None


def _ctx(window=(0, 1000), device=DEVICE):
    trace = types.SimpleNamespace(window=window, device=device,
                                  window_s=(window[1] - window[0]) / 1e9)
    return types.SimpleNamespace(trace=trace)


def test_readers_of_queue_wait_and_builds(monkeypatch):
    kept = [
        _span(1, "program.build", 0, 40, cache="euler"),
        _span(2, "program.build", 10, 20, parent=1, cache="decode"),
        _span(3, "program.build", 50, 60, cache="decode"),
        _span(4, "program.build", 95, 200, cache="late"),   # ends inside
    ] + [_span(10 + i, "server.queue", 100, 100 + 1_000_000 * (i + 1),
               thread=8, outcome="dispatched") for i in range(10)] + [
        _span(30, "server.queue", 100, 150, thread=8, outcome="expired"),
        _span(31, "server.queue", 0, 50, thread=8, outcome="dispatched")]
    monkeypatch.setattr(spans, "program_spans", lambda: kept)
    ctx = _ctx(window=(100, 100 + 9_000_000))
    assert spans.program_build_s(ctx) == pytest.approx(50 / 1e9)
    # nine dispatches inside the window, 1..9 ms: the nearest-rank p90
    assert spans.queue_wait_p90_ms(ctx) == pytest.approx(9.0)
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    ctx = _ctx()
    assert spans.program_build_s(ctx) is None
    assert spans.queue_wait_p90_ms(ctx) is None
    assert spans.idle_share(ctx, "host") is None


@pytest.mark.parametrize("cell,group", [("tiny-open", "open"),
                                        ("tiny-closed", "bulk")])
def test_tiny_traced_cell_reads_every_span_metric(tiny_root, cell, group):
    """The tiny cells added to the new metrics' workloads (as to the
    cells of their group): a --trace 1 run on the CPU reports each."""
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    names = []
    for m in manifest["per_layer"]:
        if m["source"] == "program_span" and m["name"].endswith(group):
            m["workloads"].append(cell)
            names.append(m["name"])
    with open(path, "w") as f:
        json.dump(manifest, f)
    res = harness.run(tiny_root, cell, 2 ** 40 + 23, 3.0, True,
                      t_start=time.monotonic(), device="cpu")
    assert res["correct"]
    got = {n: res["metrics"][n]["value"] for n in names}
    assert len(got) == (5 if group == "open" else 2)
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert got[f"program_build_s.{group}"] > 0
    if group == "open":
        # no device work on the CPU: the window is idle, and the server's
        # thread has a span open nearly all of it
        assert got["idle_untraced.open"] < 5.0
        assert got["queue_wait_p90_ms.open"] < 1e3 * res["device"]["window_s"]
