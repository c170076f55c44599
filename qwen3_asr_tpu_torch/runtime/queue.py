"""On-device dispatch scheduler.

Counterpart of ``qwen3_asr_tpu/runtime/queue.py``. A device admits one
in-flight dispatch at a time — batching happens *inside* a job, in the
engine — so scheduling reduces to one question: which waiting job gets the
device next? Two FIFO lanes answer it: an express lane for
latency-sensitive streaming work and a standard lane for batch HTTP
uploads. Express always goes first; within a lane, arrival order holds.

Device work itself runs on one dedicated thread so dispatch stays
serialized even when jobs block in native code. The port's server runs a
thread per request rather than an event loop, so the lanes sit behind a
``threading.Condition`` and each job's reply is a
``concurrent.futures.Future``. A job runs in a copy of its submitter's
``contextvars`` context, so what it logs carries the request's id.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextvars
import threading
from typing import Callable, Deque, Optional, Tuple

EXPRESS = 0   # streaming partials / finals (WebSocket)
STANDARD = 1  # batch HTTP work

_Entry = Tuple[Callable, concurrent.futures.Future, contextvars.Context]


class PriorityInferQueue:
    """Two-lane scheduler feeding one device-dispatch thread."""

    def __init__(self):
        self._lanes: Tuple[Deque[_Entry], Deque[_Entry]] = (
            collections.deque(), collections.deque())
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._inflight: Optional[concurrent.futures.Future] = None
        self._stopped = True

    def start(self) -> None:
        """Start the device thread. After ``stop()`` a new thread starts,
        and it waits for the old one to finish the job it still runs, so
        two jobs never share the device."""
        with self._cond:
            if not self._stopped:
                return
            self._stopped = False
            self._thread = threading.Thread(
                target=self._run, args=(self._thread,),
                name="device-dispatch", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Settle every reply: the job on the device thread cannot be
        interrupted (abandon-and-return, like request timeouts), but its
        submitter must not wait forever for a result no one will deliver;
        what is still queued can never run. Later submits fail fast."""
        with self._cond:
            self._stopped = True
            if self._inflight is not None:
                settle(self._inflight, exc=concurrent.futures.CancelledError(
                    "inference queue stopped"))
                self._inflight = None
            for lane in self._lanes:
                while lane:
                    lane.popleft()[1].cancel()
            self._cond.notify_all()

    def submit(self, fn: Callable, priority: int = STANDARD
               ) -> concurrent.futures.Future:
        """Queue a job for the device; the future resolves to its return
        value or its exception. Cancel the future to skip the job while it
        is still queued."""
        reply: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            if self._stopped:
                # A lane no device thread will ever drain must fail fast,
                # not strand the submitter.
                raise RuntimeError("inference queue stopped")
            lane = self._lanes[EXPRESS if priority <= EXPRESS else STANDARD]
            lane.append((fn, reply, contextvars.copy_context()))
            self._cond.notify()
        return reply

    @property
    def depth(self) -> int:
        with self._cond:
            return sum(len(lane) for lane in self._lanes)

    def _run(self, previous: Optional[threading.Thread]) -> None:
        if previous is not None:
            previous.join()
        me = threading.current_thread()
        while True:
            with self._cond:
                while not self._stopped and not any(self._lanes):
                    self._cond.wait()
                if self._stopped or self._thread is not me:
                    return          # stopped, or restarted after a stop
                fn, reply, ctx = next(lane for lane in self._lanes
                                      if lane).popleft()
                # A reply cancelled while queued (the client went away)
                # skips the device work entirely.
                if not reply.set_running_or_notify_cancel():
                    continue
                self._inflight = reply
            try:
                outcome = ctx.run(fn)
            except BaseException as exc:  # handed to the submitter
                settle(reply, exc=exc)
                if not isinstance(exc, Exception):
                    raise
            else:
                settle(reply, result=outcome)
            finally:
                with self._cond:
                    if self._inflight is reply:
                        self._inflight = None


def settle(reply: concurrent.futures.Future, *, result=None,
           exc: Optional[BaseException] = None) -> None:
    """Set a reply unless it is settled already (``stop()`` may have
    settled it, or its waiter cancelled it)."""
    try:
        if exc is not None:
            reply.set_exception(exc)
        else:
            reply.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass
