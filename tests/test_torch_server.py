"""The port's MicroBatchServer (serve/server.py): coalescing, grouping,
futures, error propagation and shutdown, and the hardening surface
(bounded queue, deadlines with the in-flight watchdog, cancellation,
drainless shutdown, stats), mirroring tests/test_server.py over a fake
run_batch, so that no model runs; a group is padded to its batch bucket
(presets.pick_batch_bucket), as the JAX server pads it.  Last, the
server's spans (utils/profiling.py): the queue, the gather and the pass.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

from echo_tts_torch.serve import metrics
from echo_tts_torch.serve import server as srv_mod
from echo_tts_torch.serve.batcher import BatchRequest, BatchResult
from echo_tts_torch.serve.server import MicroBatchServer, QueueFullError
from echo_tts_torch.utils import profiling

FAST = {"num_steps": 2, "sequence_length": 8}
MODELS = object()  # the fake run_batch never reads the models


def fake_run_batch(models, reqs, params=None, speaker_bucket=None):
    """One result per request, its audio a function of its seed; a
    sampler parameter the sampler does not take raises TypeError, as the
    real pass does."""
    unknown = set(params or ()) - set(FAST) - {"cfg_scale_text"}
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
    return [BatchResult(audio=np.full((1, 16), r.seed, np.float32),
                        normalized_text=f"[S1] {r.text}",
                        request_id=r.request_id) for r in reqs]


class _Wedge:
    """A run_batch stand-in that blocks until released: a wedged (or just
    slow) device call."""

    def __init__(self, real):
        self.real = real
        self.release = threading.Event()
        self.entered = threading.Event()

    def __call__(self, models, reqs, *a, **kw):
        self.entered.set()
        assert self.release.wait(timeout=60), "wedge never released"
        return self.real(models, reqs, *a, **kw)


@pytest.fixture(autouse=True)
def fake(monkeypatch):
    sizes = []

    def run(models, reqs, *a, **kw):
        sizes.append(len(reqs))
        return fake_run_batch(models, reqs, *a, **kw)

    monkeypatch.setattr(srv_mod, "run_batch", run)
    return sizes


@pytest.fixture()
def server():
    srv = MicroBatchServer(MODELS, max_batch=4, max_wait_s=0.2)
    yield srv
    srv.shutdown()


def test_concurrent_requests_batched(server, fake):
    futs = [server.submit(BatchRequest(f"Request number {i}.", seed=i,
                                       request_id=str(i)), FAST)
            for i in range(8)]
    results = [f.result(timeout=30) for f in futs]
    assert [r.request_id for r in results] == [str(i) for i in range(8)]
    for i, r in enumerate(results):
        assert (r.audio == i).all() and r.normalized_text.startswith("[S1] ")
    # each pass at a batch bucket of max_batch 4, padded rows dropped
    assert set(fake) <= {1, 2, 4} and sum(fake) >= 8
    assert server.stats()["completed"] == 8


def test_mixed_params_grouped_separately(server, fake):
    f1 = server.submit(BatchRequest("Two steps.", seed=1, request_id="a"), FAST)
    f2 = server.submit(BatchRequest("Other scale.", seed=2, request_id="b"),
                       {**FAST, "cfg_scale_text": 2.0})
    assert f1.result(timeout=30).request_id == "a"
    assert f2.result(timeout=30).request_id == "b"
    assert sorted(fake) == [1, 1]


def test_submission_from_many_threads():
    """More submitting threads than cores, with a short switch interval:
    every request answered with its own result, and the stats counters
    (shared by the submitters and the executor) lose no update."""
    results = {}
    n = 4 * (os.cpu_count() or 1) + 4
    server = MicroBatchServer(MODELS, max_batch=4, max_wait_s=0.01,
                              max_queue=n)

    def worker(i):
        fut = server.submit(BatchRequest(f"Thread {i}.", seed=i,
                                         request_id=str(i)), FAST)
        results[i] = fut.result(timeout=30)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(n))
    assert all((results[i].audio == i).all() for i in range(n))
    stats = server.stats()
    assert stats["submitted"] == stats["completed"] == n


def test_odd_group_runs_at_its_own_size(fake):
    """A group of three runs as one pass padded to the batch bucket 4 (the
    last request repeated, its extra output dropped): each future gets its
    own request's result, and the occupancy counts the three."""
    srv = MicroBatchServer(MODELS, max_batch=4, max_wait_s=1.0)
    try:
        futs = [srv.submit(BatchRequest(f"Odd {i}.", seed=50 + i), FAST)
                for i in range(3)]
        assert [f.result(timeout=30).audio[0, 0] for f in futs] == [50, 51, 52]
        assert fake == [4]
        assert srv.stats()["mean_occupancy"] == 3.0
    finally:
        srv.shutdown()


def test_error_propagates_to_future(server):
    fut = server.submit(BatchRequest("x", seed=0),
                        {**FAST, "nonsense_key": 1})
    with pytest.raises(TypeError):
        fut.result(timeout=30)
    assert server.stats()["failed"] == 1


def test_shutdown_rejects_new_work():
    srv = MicroBatchServer(MODELS, max_batch=2, max_wait_s=0.01)
    srv.shutdown()
    with pytest.raises(RuntimeError):
        srv.submit(BatchRequest("nope", seed=0), FAST)
    assert srv.stats()["shutdown"]


def test_bounded_queue_backpressure(monkeypatch):
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01, max_queue=2)
    try:
        first = srv.submit(BatchRequest("Wedge.", seed=0), FAST)
        assert wedge.entered.wait(timeout=30)
        q1 = srv.submit(BatchRequest("Queued one.", seed=1), FAST)
        q2 = srv.submit(BatchRequest("Queued two.", seed=2), FAST)
        with pytest.raises(QueueFullError):
            srv.submit(BatchRequest("Overflow.", seed=3), FAST)
        assert srv.stats()["queue_depth"] == 2
        wedge.release.set()
        for f in (first, q1, q2):
            assert f.result(timeout=30).audio.ndim == 2
    finally:
        wedge.release.set()
        srv.shutdown()


def test_deadline_expired_in_queue(monkeypatch):
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01)
    try:
        first = srv.submit(BatchRequest("Wedge.", seed=0), FAST)
        assert wedge.entered.wait(timeout=30)
        doomed = srv.submit(BatchRequest("Too late.", seed=1), FAST,
                            deadline_s=0.05)
        time.sleep(0.2)
        wedge.release.set()
        with pytest.raises(TimeoutError):
            doomed.result(timeout=30)
        assert first.result(timeout=30).audio.ndim == 2
        assert srv.stats()["expired"] == 1
    finally:
        wedge.release.set()
        srv.shutdown()


def test_wedged_device_watchdog_times_out_inflight(monkeypatch):
    """A request whose device call wedges fails with TimeoutError while the
    call is still stuck, and the executor serves the next request."""
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01)
    try:
        fut = srv.submit(BatchRequest("Wedged forever.", seed=0), FAST,
                         deadline_s=0.1)
        assert wedge.entered.wait(timeout=30)
        with pytest.raises(TimeoutError):
            fut.result(timeout=30)
        assert srv.stats()["expired"] == 1
        monkeypatch.setattr(srv_mod, "run_batch", wedge.real)
        wedge.release.set()
        nxt = srv.submit(BatchRequest("Still alive.", seed=1), FAST)
        assert nxt.result(timeout=30).audio.ndim == 2
    finally:
        wedge.release.set()
        srv.shutdown()


def test_server_default_deadline(monkeypatch):
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01,
                           deadline_s=0.1)
    try:
        fut = srv.submit(BatchRequest("Default deadline.", seed=0), FAST)
        with pytest.raises(TimeoutError):
            fut.result(timeout=30)
    finally:
        wedge.release.set()
        srv.shutdown()


def test_cancel_before_dispatch(monkeypatch):
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01)
    try:
        first = srv.submit(BatchRequest("Wedge.", seed=0), FAST)
        assert wedge.entered.wait(timeout=30)
        doomed = srv.submit(BatchRequest("Changed my mind.", seed=1), FAST)
        assert doomed.cancel()
        wedge.release.set()
        assert first.result(timeout=30).audio.ndim == 2
        assert doomed.cancelled()
        deadline = time.monotonic() + 30
        while (srv.stats()["cancelled"] != 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert srv.stats()["cancelled"] == 1
    finally:
        wedge.release.set()
        srv.shutdown()


def test_shutdown_drains_inflight_by_default():
    srv = MicroBatchServer(MODELS, max_batch=2, max_wait_s=0.01)
    futs = [srv.submit(BatchRequest(f"Drain {i}.", seed=i), FAST)
            for i in range(3)]
    srv.shutdown(wait=True)
    for f in futs:
        assert f.result(timeout=0).audio.ndim == 2


def test_shutdown_drain_false_cancels_queued(monkeypatch):
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01)
    try:
        first = srv.submit(BatchRequest("Wedge.", seed=0), FAST)
        assert wedge.entered.wait(timeout=30)
        queued = srv.submit(BatchRequest("Never runs.", seed=1), FAST)
        srv.shutdown(wait=False, drain=False)
        assert queued.cancelled()
        assert srv.stats()["cancelled"] == 1
        wedge.release.set()
        assert first.result(timeout=30).audio.ndim == 2
    finally:
        wedge.release.set()
        srv.shutdown()


def test_device_lock_serializes_the_pass(monkeypatch):
    """A holder of device_lock (a stream, an uncached voice encode) keeps
    the executor's pass waiting until it lets go."""
    srv = MicroBatchServer(MODELS, max_batch=1, max_wait_s=0.01)
    try:
        with srv.device_lock:
            fut = srv.submit(BatchRequest("Waits.", seed=0), FAST)
            time.sleep(0.2)
            assert not fut.done()
        assert fut.result(timeout=30).audio.ndim == 2
    finally:
        srv.shutdown()


def test_stats_shape(server):
    server.submit(BatchRequest("Stats please.", seed=0), FAST).result(timeout=30)
    s = server.stats()
    assert s["submitted"] >= 1 and s["completed"] >= 1
    assert s["max_queue"] == 16 * server.max_batch
    assert s["queue_depth"] == 0 and not s["shutdown"]
    assert s["batches"] >= 1 and s["mean_occupancy"] >= 1.0
    assert s["in_flight"] == 0 and s["failed"] == 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_server_spans_nest_and_order():
    """Each request's `server.queue` span runs from its submit, on the
    submitting thread, to its pass's dispatch (the `server.pass` span's
    start), with its id; on the executor thread `server.wait`,
    `server.gather` and `server.pass` follow one another, the pass holding
    `server.device_lock` then `server.resolve`; `queue_wait_seconds`
    observes each dispatched request."""
    waits = metrics.histogram("queue_wait_seconds")
    n0, mark = waits.count, profiling.now_ns()
    srv = MicroBatchServer(MODELS, max_batch=4, max_wait_s=0.2)
    try:
        futs = [srv.submit(BatchRequest(f"Span {i}.", seed=i,
                                        request_id=f"r{i}"), FAST)
                for i in range(3)]
        for f in futs:
            f.result(timeout=30)
    finally:
        srv.shutdown()
    got = profiling.spans(mark)
    queued = {s.attrs["request"]: s for s in got if s.name == "server.queue"}
    (pass_,) = [s for s in got if s.name == "server.pass"]
    assert pass_.attrs["requests"] == ["r0", "r1", "r2"]
    assert (pass_.attrs["live"], pass_.attrs["bucket"]) == (3, 4)
    me = threading.get_native_id()
    for rid, q in queued.items():
        assert q.attrs["outcome"] == "dispatched" and q.thread == me
        assert q.end_ns == pass_.start_ns and q.start_ns <= q.end_ns
    assert sorted(queued) == ["r0", "r1", "r2"]
    assert waits.count - n0 == 3
    executor = [s for s in got if s.thread == pass_.thread]
    roots = [s for s in executor if s.parent is None]
    roots.sort(key=lambda s: s.start_ns)
    # the last wait is the one shutdown ends
    assert [s.name for s in roots] == ["server.wait", "server.gather",
                                       "server.pass", "server.wait"]
    assert roots[1].attrs == {"rows": 3, "ended": "timeout"}
    for a, b in zip(roots, roots[1:]):
        assert a.end_ns <= b.start_ns
    inner = sorted((s for s in executor if s.parent == pass_.id),
                   key=lambda s: s.start_ns)
    assert [s.name for s in inner] == ["server.device_lock",
                                       "server.resolve"]
    assert all(pass_.start_ns <= s.start_ns <= s.end_ns <= pass_.end_ns
               for s in inner)


def test_gather_ends_at_max_batch():
    srv = MicroBatchServer(MODELS, max_batch=2, max_wait_s=5.0)
    mark = profiling.now_ns()
    try:
        futs = [srv.submit(BatchRequest(f"Full {i}.", seed=i), FAST)
                for i in range(2)]
        for f in futs:
            f.result(timeout=30)
    finally:
        srv.shutdown()
    gathers = [s for s in profiling.spans(mark) if s.name == "server.gather"]
    assert [s.attrs for s in gathers] == [{"rows": 2, "ended": "max_batch"}]


def test_expired_and_cancelled_requests_carry_their_outcome(monkeypatch):
    """A request that expires in the queue and one cancelled before its
    dispatch each get a `server.queue` span ending at the dispatch that
    dropped it, with the outcome; one cancelled by a drainless shutdown
    gets its span too."""
    wedge = _Wedge(srv_mod.run_batch)
    monkeypatch.setattr(srv_mod, "run_batch", wedge)
    srv = MicroBatchServer(MODELS, max_batch=4, max_wait_s=0.01)
    mark = profiling.now_ns()
    try:
        first = srv.submit(BatchRequest("Wedge.", seed=0, request_id="w"),
                           FAST)
        assert wedge.entered.wait(timeout=30)
        late = srv.submit(BatchRequest("Too late.", seed=1,
                                       request_id="late"), FAST,
                          deadline_s=0.05)
        gone = srv.submit(BatchRequest("Changed my mind.", seed=2,
                                       request_id="gone"), FAST)
        assert gone.cancel()
        time.sleep(0.2)
        wedge.release.set()
        assert first.result(timeout=30).audio.ndim == 2
        with pytest.raises(TimeoutError):
            late.result(timeout=30)
        wedge.release.clear()
        wedge.entered.clear()
        second = srv.submit(BatchRequest("Wedge again.", seed=3), FAST)
        assert wedge.entered.wait(timeout=30)
        dropped = srv.submit(BatchRequest("Never runs.", seed=4,
                                          request_id="dropped"), FAST)
        srv.shutdown(wait=False, drain=False)
        assert dropped.cancelled()
        wedge.release.set()
        assert second.result(timeout=30).audio.ndim == 2
    finally:
        wedge.release.set()
        srv.shutdown()
    got = profiling.spans(mark)
    outcome = {s.attrs["request"]: s.attrs["outcome"] for s in got
               if s.name == "server.queue"}
    assert {k: outcome[k] for k in ("w", "late", "gone", "dropped")} == {
        "w": "dispatched", "late": "expired", "gone": "cancelled",
        "dropped": "cancelled"}
    passes = [s for s in got if s.name == "server.pass"]
    dropping = next(p for p in passes if p.attrs["live"] == 0)
    assert all(s.end_ns == dropping.start_ns for s in got
               if s.name == "server.queue"
               and s.attrs["request"] in ("late", "gone"))
