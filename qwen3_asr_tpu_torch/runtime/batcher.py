"""Micro-batching: concurrent transcriptions that land in the same length
bucket within a short window run as ONE batched device call.

Counterpart of ``qwen3_asr_tpu/runtime/batcher.py`` (``_pad_pow2``,
``_Collector`` and ``MicroBatcher``). ``_Collector`` keeps a keyed group
map guarded by one lock, a flush timer per group, power-of-two batch
padding, and future settling that survives any failure. Device dispatch
always happens OUTSIDE the lock: a batched call can take seconds and must
not stall the admission of other requests. The port's server runs a thread
per request, so the lock is a ``threading.Lock``, the timer a
``threading.Timer`` and each reply a ``concurrent.futures.Future``; a
group's timer flushes it in the context of the request that opened it,
so its dispatch logs under that request's id.
``TickBatcher`` (``qwen3_asr_tpu/runtime/batcher.py:153-261``) coalesces
concurrent WS sessions' partial ticks into one batched resume run, on the
fast engine when one is loaded and the tick asks for it;
``GroupTickBatcher`` (``:262-326``) coalesces the partial ticks of one
stream group's members into one pooled-cache dispatch. The batchers read
the manager's engines when a request comes (after its
``ensure_loaded``) and again when a dispatch runs: an idle unload may
come between, and a dispatch that finds no engine loads it on the device
thread before it runs.
"""
from __future__ import annotations

import concurrent.futures
import contextvars
import logging
import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..utils.telemetry import Metrics
from .queue import EXPRESS, STANDARD, settle

log = logging.getLogger(__name__)


class _PendingTick:
    __slots__ = ("audio", "resume", "language", "future")

    def __init__(self, audio, resume, language, future):
        self.audio = audio
        self.resume = resume
        self.language = language
        self.future = future


class _Pending:
    __slots__ = ("audio", "language", "future", "priority")

    def __init__(self, audio, language, future, priority=STANDARD):
        self.audio = audio
        self.language = language
        self.future = future
        # Queue lane for the request (0 = express, 1 = standard). A
        # coalesced group dispatches at its most urgent member's lane.
        self.priority = priority


def dispatch_engine(mgr, use_fast: bool = False):
    """The engine a dispatch runs on, read on the device thread: after an
    idle unload that won the race against the request, the engines load
    again first (``qwen3_asr_tpu/runtime/batcher.py:224``)."""
    if mgr.engine is None:
        log.info("Reloading model: request admitted during idle unload")
        mgr._load_sync()
    return (mgr.fast_engine if use_fast and mgr.fast_engine is not None
            else mgr.engine)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _pad_pow2(clips: list, rows: Optional[list] = None,
              dtype=np.float32) -> None:
    """Pad in place to a power-of-two batch with 0.1 s silent clips (and
    ``rows`` with None), so only batches of {1, 2, 4, 8, ...} ever run."""
    n = 1
    while n < len(clips):
        n *= 2
    while len(clips) < n:
        clips.append(np.zeros(1600, dtype=dtype))
        if rows is not None:
            rows.append(None)


class _Collector:
    """Keyed group collection + settle-safe dispatch. Subclasses define
    ``_submit(key, group)``."""

    def __init__(self, manager, window_s: float, max_batch: int):
        self.manager = manager
        self.window_s = window_s
        # Round the cap DOWN to a power of two: groups are padded UP to a
        # power-of-two batch before dispatch, so a cap of 6 would dispatch
        # batches of 8, past the configured cap.
        cap = _pow2_floor(max_batch)
        if cap != max_batch:
            log.warning("batch cap %d rounded down to power-of-two %d",
                        max_batch, cap)
        self.max_batch = cap
        self.dispatches = 0           # device jobs submitted (for tests)
        # the serving registry (/metrics); a manager without one (a test
        # double) gets a registry of the batcher's own
        self.metrics = getattr(manager, "metrics", None) or Metrics()
        self._groups: dict = {}
        self._lock = threading.Lock()

    def _enqueue(self, key, pending, solo: bool = False) -> None:
        """Admit one item. ``solo`` dispatches it at once as its own group
        when none is collecting under its key (nothing to coalesce with).
        The lock guards ONLY the group map — dispatch happens outside
        it."""
        to_submit = None
        with self._lock:
            group = self._groups.get(key)
            if group is None and (solo or self.max_batch <= 1):
                to_submit = [pending]
            elif group is None:
                group = [pending]
                self._groups[key] = group
                timer = threading.Timer(
                    self.window_s, contextvars.copy_context().run,
                    args=(self._flush_later, key, group))
                timer.daemon = True
                timer.start()
            else:
                group.append(pending)
                if len(group) >= self.max_batch:
                    to_submit = self._groups.pop(key)
        if to_submit:
            self._submit(key, to_submit)

    def _flush_later(self, key, group) -> None:
        with self._lock:
            # Only flush the group this timer was made for: a group filled
            # to the cap may already have gone, and a successor started
            # under the same key.
            if self._groups.get(key) is not group:
                return
            self._groups.pop(key)
        self._submit(key, group)

    def _count_dispatch(self) -> None:
        with self._lock:
            self.dispatches += 1

    def _dispatch(self, group: list, job: Callable,
                  priority: int) -> None:
        """Run ``job`` on the inference queue and settle every member's
        future, whatever happens: a refused submit, a failing job or a
        stopped queue must not leave a coalesced request waiting until its
        timeout."""
        self._count_dispatch()
        try:
            reply = self.manager.queue.submit(job, priority=priority)
        except Exception as e:
            for p in group:
                settle(p.future, exc=e)
            return

        def done(reply: concurrent.futures.Future) -> None:
            try:
                results = reply.result()
            except (Exception, concurrent.futures.CancelledError) as e:
                for p in group:
                    settle(p.future, exc=e)
                return
            for p, res in zip(group, results):
                settle(p.future, result=res)

        reply.add_done_callback(done)


class _PendingGroupTick:
    __slots__ = ("member", "audio", "future")

    def __init__(self, member, audio, future):
        self.member = member
        self.audio = audio
        self.future = future


class GroupTickBatcher(_Collector):
    """Tick coalescing for the grouped WS mode: partial ticks of members
    of one ``StreamGroup`` (``runtime/stream_group.py``) that land within
    ``ASR_WS_TICK_WINDOW_MS`` (6) run as ONE ``StreamGroup.tick`` on the
    group's pooled cache, up to ``ASR_WS_GROUP_SLOTS`` (8) members. The key
    is the group, so members of different groups dispatch apart. A
    member's repeated ticks in one collection split into rounds, in order
    (its second tick diffs against its first's state); a member released
    before its round runs gets ``("", [])``. A lone live session
    (``manager.ws_sessions <= 1``) skips the window. Dispatched on the
    express lane."""

    def __init__(self, manager, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        super().__init__(
            manager,
            (window_ms if window_ms is not None else
             float(os.getenv("ASR_WS_TICK_WINDOW_MS", "6"))) / 1000,
            max_batch or int(os.getenv("ASR_WS_GROUP_SLOTS", "8")))
        # dispatched rounds by size, and the ticks they carried (also
        # counted in /metrics' asr_group_tick_{groups,ticks}_total)
        self.groups: dict = {}
        self.ticks = 0

    def tick(self, member, audio: np.ndarray) -> concurrent.futures.Future:
        """One member's partial tick → a future of (text, token_ids)."""
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._enqueue(("g", id(member.group)),
                      _PendingGroupTick(member, audio, future),
                      solo=getattr(self.manager, "ws_sessions", 0) <= 1)
        return future

    def _submit(self, key, group: List[_PendingGroupTick]) -> None:
        # a member appears at most once a dispatch: repeats go to later
        # rounds, which the queue's one lane runs in order
        rounds: List[List[_PendingGroupTick]] = []
        for p in group:
            for rnd in rounds:
                if all(q.member is not p.member for q in rnd):
                    rnd.append(p)
                    break
            else:
                rounds.append([p])
        for rnd in rounds:
            live = [p for p in rnd if p.member.group is not None]
            for p in rnd:
                if p.member.group is None:
                    # released mid-flight: an empty partial, not sent
                    settle(p.future, result=("", []))
            if not live:
                continue
            with self._lock:
                self.groups[len(live)] = self.groups.get(len(live), 0) + 1
                self.ticks += len(live)
            self.metrics.inc("asr_group_tick_groups_total", size=len(live))
            self.metrics.inc("asr_group_tick_ticks_total", float(len(live)))

            def run(live=live):
                out: List[Optional[tuple]] = [("", [])] * len(live)
                ticking = [(i, p) for i, p in enumerate(live)
                           if p.member.group is not None]
                if ticking:
                    grp = ticking[0][1].member.group
                    got = grp.tick([(p.member, p.audio)
                                    for _, p in ticking])
                    for (i, _), res in zip(ticking, got):
                        out[i] = res
                return out

            self._dispatch(live, run, priority=EXPRESS)


class MicroBatcher(_Collector):
    """Collects same-(bucket, language) transcriptions for a few ms, then
    submits one batched job to the priority queue."""

    def __init__(self, manager, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        super().__init__(
            manager,
            (window_ms if window_ms is not None else
             float(os.getenv("ASR_BATCH_WINDOW_MS", "20"))) / 1000,
            max_batch or int(os.getenv("ASR_MAX_BATCH", "8")))

    def transcribe(self, audio: np.ndarray, sr: int,
                   language: Optional[str], return_timestamps: bool = False,
                   priority: int = STANDARD) -> concurrent.futures.Future:
        """A future of the request's results (a list of
        ``TranscriptionResult``). Through the decode pool when the manager
        runs one and the request can pool (``pool_eligible``; whatever its
        lane, as in ``qwen3_asr_tpu/runtime/batcher.py:352-355``); else
        batched when possible; a solo job through
        ``manager.transcribe_sync`` for requests that cannot batch (word
        timestamps, resampling, multichannel, longer than MAX_SEGMENT_S,
        or a cap of 1). ``priority`` is the queue lane; a mixed group
        dispatches at its most urgent member's lane."""
        from ..models.asr import normalize_language
        from .engine import MAX_SEGMENT_S, TARGET_SR
        mgr = self.manager
        if mgr.pool_eligible(audio, sr, return_timestamps):
            # the pool coalesces at the decode-step level
            return mgr.transcribe_pooled(audio, sr, language)
        if (return_timestamps or sr != TARGET_SR or audio.ndim > 1
                or len(audio) > MAX_SEGMENT_S * TARGET_SR
                or self.max_batch <= 1):
            self._count_dispatch()
            return mgr.queue.submit(
                lambda: mgr.transcribe_sync(audio, sr, language,
                                            return_timestamps),
                priority=priority)
        bucket = mgr.serving_engine().bucket_frames(len(audio))
        # Normalize the language BEFORE grouping: "en" and "English" are
        # the same request (identical prompt) and must batch together and
        # echo the same metadata the solo path returns.
        language, _ = normalize_language(language)
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._enqueue((bucket, language or ""),
                      _Pending(audio, language, future, priority))
        return future

    def _submit(self, key, group: List[_Pending]) -> None:
        (bucket_frames, bucket_s), language = key[0], key[1] or None
        mgr = self.manager
        if len(group) > 1:
            log.debug("micro-batch: %d requests in bucket %ss", len(group),
                      bucket_s)

        def run():
            from .engine import (TARGET_SR, TranscriptionResult,
                                 _response_language)
            mgr._last_used = time.time()
            try:
                clips = [p.audio for p in group]
                _pad_pow2(clips)
                texts, id_lists = dispatch_engine(mgr)._run_bucket(
                    clips, bucket_frames, bucket_s, language)
            finally:
                # at the end too: the unload's re-check may run next
                mgr._last_used = time.time()
            return [[TranscriptionResult(
                text=text, language=_response_language(text, language),
                start_time=0.0, end_time=len(p.audio) / TARGET_SR,
                token_ids=ids)]
                for p, text, ids in zip(group, texts, id_lists)]

        self._dispatch(group, run, priority=min(p.priority for p in group))


class TickBatcher(_Collector):
    """Cross-session WS tick batching: partial ticks of concurrent
    streaming sessions that land in the same bucket within
    ``ASR_WS_TICK_WINDOW_MS`` (6) run as ONE batched resume run
    (``engine._run_bucket(resume_rows=..., language_rows=...)``), up to
    ``ASR_WS_TICK_MAX_BATCH`` (8) rows, padded to a power of two. Each row
    keeps its own window, draft, language and frontier, so its tokens are
    its solo resume run's. A group of one takes the batch-1 resume key,
    and a lone live session (``manager.ws_sessions <= 1``) skips the
    window. Dispatched on the express lane."""

    def __init__(self, manager, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None):
        super().__init__(
            manager,
            (window_ms if window_ms is not None else
             float(os.getenv("ASR_WS_TICK_WINDOW_MS", "6"))) / 1000,
            max_batch or int(os.getenv("ASR_WS_TICK_MAX_BATCH", "8")))
        # dispatched groups by size, and the ticks they carried (also
        # counted in /metrics' asr_tick_batch_{groups,ticks}_total)
        self.groups: dict = {}
        self.ticks = 0

    def transcribe_tick(self, audio: np.ndarray, language: Optional[str],
                        resume_tokens, use_fast: bool
                        ) -> concurrent.futures.Future:
        """One session's partial tick → a future of (text, token_ids).
        ``use_fast`` takes the fast engine when one is loaded; the key is
        (the engine taken is the fast one, bucket)."""
        from ..models.asr import normalize_language
        mgr = self.manager
        engine = mgr.serving_engine(use_fast)
        use_fast = engine is not mgr.engine
        language, _ = normalize_language(language)
        # language is per ROW, so sessions of different languages still
        # share one dispatch
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._enqueue((use_fast, engine.bucket_frames(len(audio))),
                      _PendingTick(audio, resume_tokens, language, future),
                      solo=getattr(mgr, "ws_sessions", 0) <= 1)
        return future

    def _submit(self, key, group: List[_PendingTick]) -> None:
        use_fast, (bucket_frames, bucket_s) = key
        mgr = self.manager
        if len(group) > 1:
            log.debug("tick batch: %d sessions in bucket %ss", len(group),
                      bucket_s)
        with self._lock:
            self.groups[len(group)] = self.groups.get(len(group), 0) + 1
            self.ticks += len(group)
        self.metrics.inc("asr_tick_batch_groups_total", size=len(group))
        self.metrics.inc("asr_tick_batch_ticks_total", float(len(group)))

        def run():
            mgr._last_used = time.time()
            try:
                engine = dispatch_engine(mgr, use_fast)
                clips = [p.audio for p in group]
                rows = [p.resume for p in group]
                langs = [p.language for p in group]
                if len(group) == 1:
                    texts, ids = engine._run_bucket(
                        clips, bucket_frames, bucket_s, langs[0],
                        resume_tokens=list(rows[0] or []))
                else:
                    _pad_pow2(clips, rows)
                    langs.extend([None] * (len(clips) - len(langs)))
                    texts, ids = engine._run_bucket(
                        clips, bucket_frames, bucket_s, None,
                        resume_rows=rows, language_rows=langs)
            finally:
                mgr._last_used = time.time()
            return list(zip(texts[:len(group)], ids[:len(group)]))

        self._dispatch(group, run, priority=EXPRESS)
