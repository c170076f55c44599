"""The port's two-lane inference queue holds the contracts that
``tests/test_integration.py`` holds for the JAX package's: express before
standard, FIFO within a lane, exceptions reach the submitter, a job
cancelled while queued never runs, and stop() settles the job in flight
and the queued ones and makes later submits fail fast."""
import concurrent.futures
import threading
import time

import pytest

from qwen3_asr_tpu_torch.runtime.queue import (EXPRESS, STANDARD,
                                               PriorityInferQueue)

WAIT = 10


@pytest.fixture
def queue():
    q = PriorityInferQueue()
    q.start()
    yield q
    q.stop()


def _wait_for(cond):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


def _occupy(queue):
    """Hold the device thread until the returned event is set; returns
    (gate, future of the holding job)."""
    started, gate = threading.Event(), threading.Event()

    def first():
        started.set()
        assert gate.wait(WAIT)
        return "first"

    fut = queue.submit(first, priority=STANDARD)
    assert started.wait(WAIT)
    return gate, fut


def test_priority_preemption(queue):
    order = []

    def job(name):
        return lambda: order.append(name) or name

    gate, first = _occupy(queue)
    futs = [queue.submit(job("http-1"), STANDARD),
            queue.submit(job("http-2"), STANDARD),
            queue.submit(job("ws-1"), EXPRESS)]
    assert queue.depth == 3
    gate.set()
    assert first.result(WAIT) == "first"
    assert [f.result(WAIT) for f in futs] == ["http-1", "http-2", "ws-1"]
    assert order == ["ws-1", "http-1", "http-2"]


def test_fifo_within_a_lane(queue):
    order = []
    gate, first = _occupy(queue)
    futs = [queue.submit((lambda i=i: order.append(i)), STANDARD)
            for i in range(5)]
    gate.set()
    for f in [first, *futs]:
        f.result(WAIT)
    assert order == list(range(5))


def test_exception_reaches_the_submitter(queue):
    def boom():
        raise RuntimeError("device error")

    with pytest.raises(RuntimeError, match="device error"):
        queue.submit(boom).result(WAIT)
    assert queue.submit(lambda: 42).result(WAIT) == 42   # still alive


def test_cancelled_job_skips_device_work(queue):
    ran = []
    gate, first = _occupy(queue)
    doomed = queue.submit(lambda: ran.append("doomed"))
    kept = queue.submit(lambda: ran.append("kept"))
    assert doomed.cancel()            # the client went away while queued
    gate.set()
    first.result(WAIT)
    kept.result(WAIT)
    with pytest.raises(concurrent.futures.CancelledError):
        doomed.result(WAIT)
    assert ran == ["kept"]


def test_stop_settles_inflight_and_queued_and_fails_new_submits():
    q = PriorityInferQueue()
    q.start()
    gate, inflight = _occupy(q)
    queued = q.submit(lambda: "never")
    q.stop()
    with pytest.raises(concurrent.futures.CancelledError):
        inflight.result(WAIT)
    with pytest.raises(concurrent.futures.CancelledError):
        queued.result(WAIT)
    with pytest.raises(RuntimeError, match="stopped"):
        q.submit(lambda: "never")
    # a restart serves again, once the abandoned job has left the device
    q.start()
    later = q.submit(lambda: 42)
    gate.set()
    assert later.result(WAIT) == 42
    q.stop()


def test_one_device_thread_under_many_submitters(queue):
    """Jobs from many threads never overlap on the device."""
    running, overlaps = [0], []
    lock = threading.Lock()

    def job():
        with lock:
            running[0] += 1
            overlaps.append(running[0])
        time.sleep(0.0005)
        with lock:
            running[0] -= 1

    futs, threads = [], []
    for i in range(16):
        t = threading.Thread(target=lambda i=i: futs.extend(
            queue.submit(job, i % 2) for _ in range(8)))
        threads.append(t)
        t.start()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    _wait_for(lambda: len(futs) == 128)
    for f in futs:
        f.result(WAIT)
    assert max(overlaps) == 1 and len(overlaps) == 128
