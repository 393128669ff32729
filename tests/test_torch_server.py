"""The port's MicroBatchServer (serve/server.py): coalescing, grouping,
futures, error propagation and shutdown, and the hardening surface
(bounded queue, deadlines with the in-flight watchdog, cancellation,
drainless shutdown, stats), mirroring tests/test_server.py over a fake
run_batch, so that no model runs; a group is padded to its batch bucket
(presets.pick_batch_bucket), as the JAX server pads it."""
import os
import sys
import threading
import time

import numpy as np
import pytest

from echo_tts_torch.serve import server as srv_mod
from echo_tts_torch.serve.batcher import BatchRequest, BatchResult
from echo_tts_torch.serve.server import MicroBatchServer, QueueFullError

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
