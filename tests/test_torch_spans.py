"""The port's span recorder (echo_tts_torch/utils/profiling.py): nesting
and parent ids, attributes, the ring's bound, threads recording at once,
its clock against torch.profiler's, StageTimer's stages and trace()'s
export as spans, and run_batch's host stages and pass shapes against the
benchmark's own record of the same call."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.pipeline.pipeline import random_models
from echo_tts_torch.serve import server as srv_mod
from echo_tts_torch.serve.batcher import BatchRequest
from echo_tts_torch.utils import profiling
from echo_tts_torch.utils.profiling import SpanRecorder, StageTimer, trace

FAST = {"num_steps": 2, "sequence_length": 8}


def _mine(mark, *names):
    """This thread's spans since mark, of the given names."""
    me = threading.get_native_id()
    return [s for s in profiling.spans(mark)
            if s.thread == me and (not names or s.name in names)]


def test_spans_nest_with_parent_ids_and_attributes():
    rec = SpanRecorder()
    with rec.span("outer", request="r1") as outer:
        assert rec.current() is outer
        with rec.span("inner") as inner:
            rec.annotate(rows=3)
        with rec.span("second") as second:
            pass
    with pytest.raises(ValueError):
        with rec.span("fails"):
            raise ValueError("boom")
    assert rec.current() is None
    rec.annotate(dropped=True)            # nothing open: a no-op
    got = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["inner", "second", "outer",
                                             "fails"]
    assert outer.parent is None and got["fails"].parent is None
    assert inner.parent == outer.id and second.parent == outer.id
    assert len({outer.id, inner.id, second.id, got["fails"].id}) == 4
    assert inner.attrs == {"rows": 3} and outer.attrs == {"request": "r1"}
    assert got["fails"].attrs == {"error": "ValueError"}
    assert (outer.start_ns <= inner.start_ns <= inner.end_ns
            <= second.start_ns <= second.end_ns <= outer.end_ns)
    assert {s.thread for s in rec.spans()} == {threading.get_native_id()}
    assert rec.spans(since_ns=outer.end_ns) == [outer, got["fails"]]


def test_recorded_spans_share_a_request_id():
    """Spans recorded from times taken elsewhere keep them, on the thread
    given, as roots; one request's spans share its id."""
    rec = SpanRecorder()
    with rec.span("pass", requests=["7", "8"]):
        a = rec.record("queue", 10, 20, thread=1234, request="7")
        b = rec.record("queue", 15, 20, thread=1235, request="8")
    assert (a.start_ns, a.end_ns, a.thread, a.parent) == (10, 20, 1234, None)
    assert b.thread == 1235
    by_request = {}
    for s in rec.spans():
        for rid in [s.attrs.get("request")] + s.attrs.get("requests", []):
            if rid is not None:
                by_request.setdefault(rid, []).append(s.name)
    assert by_request == {"7": ["queue", "pass"], "8": ["queue", "pass"]}


def test_the_ring_keeps_the_last_spans():
    rec = SpanRecorder(capacity=8)
    for i in range(20):
        with rec.span("s", i=i):
            pass
    kept = rec.spans()
    assert [s.attrs["i"] for s in kept] == list(range(12, 20))
    kept.clear()                          # a copy
    assert len(rec.spans()) == 8
    assert len(profiling.RECORDER._ring) <= profiling.RING_SPANS


def test_eight_threads_record_at_once():
    """Eight threads, each nesting spans under a short switch interval:
    every span kept once, with a unique id, and each parent on its own
    thread."""
    rec = SpanRecorder()
    per, start = 300, threading.Barrier(8)

    def work(k):
        start.wait(timeout=30)
        for i in range(per):
            with rec.span("outer", k=k, i=i):
                with rec.span("inner", k=k, i=i):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = rec.spans()
    assert len(got) == 8 * 2 * per
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    for s in got:
        if s.name == "inner":
            p = by_id[s.parent]
            assert (p.name, p.attrs, p.thread) == ("outer", s.attrs, s.thread)
        else:
            assert s.parent is None
    assert len({s.thread for s in got}) == 8


def _body():
    """Host work with device work inside it, where there is a card."""
    x = torch.ones(128, 128,
                   device="cuda" if torch.cuda.is_available() else "cpu")
    for _ in range(20):
        x = x @ x / 128.0
    time.sleep(0.002)
    return x.sum().item()


def test_span_clock_is_the_profilers():
    """A span and a record_function range around the same body agree
    within a millisecond in the profiler's timebase: a PyTorch whose
    profiler moves to another clock fails here."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a thread's first range under a profiler starts late (the
        # profiler's own set-up for the thread, up to a millisecond or
        # more on a card's host): warm it up
        with record_function("warm-up"):
            _body()
        with profiling.span("clock.probe") as sp:
            with record_function("clock.probe.range"):
                _body()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == "clock.probe.range"]
    assert len(ranges) == 1
    (r0, r1), = ranges
    assert abs(r0 - sp.start_ns) < 1e6 and abs(r1 - sp.end_ns) < 1e6


def test_trace_exports_spans_of_every_thread_beside_the_profiler(tmp_path):
    """trace() profiles every thread (a worker's record_function range is
    in the file) and writes the recorder's spans of its window, each
    within a millisecond of the host range around the same body, on the
    same thread row (on a card the range is also drawn on the device's
    row, as a `gpu_user_annotation` over its kernels)."""
    go, done = threading.Event(), threading.Event()

    def worker():
        assert go.wait(timeout=60)
        with record_function("worker.warm-up"):   # as in the test above
            _body()
        with profiling.span("worker.span"):
            with record_function("worker.range"):
                _body()
        done.set()

    # the worker starts before the profiler, as a server's thread does
    t = threading.Thread(target=worker)
    t.start()
    with profiling.span("before"):
        pass
    with trace(str(tmp_path / "tr")) as path:
        go.set()
        with record_function("main.warm-up"):
            _body()
        with profiling.span("main.span", rows=2):
            with record_function("main.range"):
                _body()
        assert done.wait(timeout=60)
    t.join(timeout=60)
    assert not t.is_alive()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    named = {e["name"]: e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("span", "user_annotation")}
    assert "before" not in named
    for who in ("main", "worker"):
        sp, rf = named[f"{who}.span"], named[f"{who}.range"]
        assert sp["cat"] == "span" and sp["tid"] == rf["tid"]
        assert abs(sp["ts"] - rf["ts"]) < 1e3
        assert abs(sp["ts"] + sp["dur"] - rf["ts"] - rf["dur"]) < 1e3
    assert named["main.span"]["args"]["rows"] == 2


def test_stage_timer_stages_are_spans():
    mark = profiling.now_ns()
    t = StageTimer()
    with t.stage("synthesis"):
        time.sleep(0.01)
    got = _mine(mark, "synthesis")
    assert len(got) == 1
    assert t.report()["synthesis"] == {"seconds": round(got[0].seconds, 4),
                                       "calls": 1}


@pytest.fixture(scope="module")
def models():
    return random_models("cpu", torch.float32, dit_cfg=tiny_dit_config(),
                         dac_cfg=tiny_dac_config())


def test_run_batch_stages_and_shapes_match_the_benchmarks_record(models):
    """run_batch inside a span: its host stages are that span's children
    in order, one decode span a slice, and the shapes it puts on the span
    equal the benchmark's Recorder's Pass of the same call (rows, sequence,
    widths launched, real lengths, decode batches)."""
    from benchmark.loops.serving import Recorder

    rng = np.random.default_rng(3)
    reqs = []
    for i, n in enumerate((16, 9, 4, 12, 16)):
        lat = np.zeros((1, 16, 80), np.float32)
        lat[0, :n] = rng.standard_normal((n, 80))
        reqs.append(BatchRequest(text="Row " + "word " * (i + 1), seed=i,
                                 speaker_latent=lat,
                                 speaker_mask=np.arange(16)[None] < n,
                                 request_id=str(i)))
    rec = Recorder().install()
    rec.recording = True
    try:
        mark = profiling.now_ns()
        with profiling.span("probe") as sp:
            srv_mod.run_batch(models, reqs, FAST, speaker_bucket=16)
    finally:
        rec.uninstall()
    (p,) = rec.passes
    a = sp.attrs
    assert a["rows"] == p.rows == 5 and a["seq"] == p.seq == 8
    assert (a["text_width"], a["speaker_width"]) == (p.text_width,
                                                     p.speaker_width)
    assert a["text_lengths"] == p.text_lengths
    assert a["speaker_lengths"] == p.speaker_lengths == [16, 9, 4, 12, 16]
    assert a["decode_batches"] == p.decode_batches == [4, 1]
    children = [s for s in _mine(mark) if s.parent == sp.id]
    assert [s.name for s in children] == [
        "batch.text", "batch.speaker", "batch.noise", "batch.sampler",
        "batch.decode", "batch.decode", "batch.to_host", "batch.crop"]
    assert [s.attrs["rows"] for s in children if s.name == "batch.decode"] \
        == [4, 1]
    starts = [s.start_ns for s in children]
    assert starts == sorted(starts)
    assert all(sp.start_ns <= s.start_ns <= s.end_ns <= sp.end_ns
               for s in children)
