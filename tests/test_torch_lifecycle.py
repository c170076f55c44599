"""The port's model lifecycle (``runtime/lifecycle.py`` ``ModelManager``)
on the CPU: the counterparts of ``tests/test_integration.py``'s
``test_idle_unload_and_reload`` (here unmarked, at a 1 s timeout and a
0.2 s watchdog on the tiny checkpoint), ``test_speculative_uses_draft``,
``test_dual_model_fast_for_partials`` and
``test_unload_race_reloads_on_infer_thread``; an unload skipped while work
waits in the queue or the pool; an unload that stops the pool, releases
the stream sessions and unloads the aligner; a ``FAST_MODEL_ID`` that
cannot load; the tick batcher's ``use_fast`` route; a WS prefix session
bound anew after an unload; token-level speculation loaded from
``USE_SPECULATIVE``; and an in-process counterpart of
``e2e/test_idle_reload.py`` on a lazy port server."""
import contextlib
import gc
import json
import logging
import os
import threading
import time
import urllib.request
import uuid
import weakref

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.audio.codec import decode_audio, encode_wav
from qwen3_asr_tpu_torch.runtime.batcher import TickBatcher
from qwen3_asr_tpu_torch.runtime.engine import TranscriptionResult
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
from qwen3_asr_tpu_torch.serving.server import build_server

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
DRAFT = os.path.join(ROOT, "trained_draft")
CLIP = os.path.join(ROOT, "real", "english_01.wav")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Managers here skip the warmup (its tests are elsewhere), and start
    from the lifecycle's defaults."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SKIP_WARMUP", "true")
    for name in ("USE_SPECULATIVE", "DUAL_MODEL", "FAST_MODEL_ID",
                 "ASR_SPECULATIVE_MODE", "ASR_CONTINUOUS_BATCHING",
                 "IDLE_TIMEOUT", "ASR_WATCHDOG_INTERVAL", "NUMA_NODE"):
        monkeypatch.delenv(name, raising=False)
    yield
    torch.set_num_threads(torch_threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.fixtures import write_tiny_checkpoint
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("tiny")))


def _clip(path=CLIP):
    with open(path, "rb") as f:
        return decode_audio(f.read())


def _wait(pred, timeout_s=20.0, what="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class FakeEngine:
    """An engine as far as ``transcribe_sync`` and the tick batcher read
    it."""

    def __init__(self, text):
        self.text, self.calls, self.runs = text, 0, []
        self.last_used = 0.0

    def transcribe(self, *a, **k):
        self.calls += 1
        return [TranscriptionResult(text=self.text, language="en")]

    def bucket_frames(self, n):
        return 100, 1.0

    def _run_bucket(self, clips, bf, bs, language, **kw):
        self.runs.append((len(clips), kw))
        return [self.text] * len(clips), [[len(self.text)]] * len(clips)


def test_idle_unload_and_reload(tiny, monkeypatch):
    """A lazy manager loads on ensure_loaded, the watchdog unloads it
    after IDLE_TIMEOUT, and the next request loads it again, with the
    same ids."""
    monkeypatch.setenv("MODEL_ID", tiny)
    monkeypatch.setenv("IDLE_TIMEOUT", "1")
    monkeypatch.setenv("ASR_WATCHDOG_INTERVAL", "0.2")
    mgr = ModelManager(device="cpu")
    assert mgr.engine is None and mgr.lazy
    mgr.start()
    try:
        mgr.ensure_loaded()
        assert mgr.engine is not None and mgr.loaded_model_id == tiny
        clip = np.zeros(4800, np.float32) + 0.01
        first = mgr.queue.submit(
            lambda: mgr.transcribe_sync(clip, 16000, "en", False)).result(60)
        assert isinstance(first, list) and first[0].token_ids
        _wait(lambda: mgr.engine is None, what="the idle unload")
        assert mgr.loaded_model_id is None and mgr.fast_engine is None
        mgr.ensure_loaded()
        again = mgr.queue.submit(
            lambda: mgr.transcribe_sync(clip, 16000, "en", False)).result(60)
        assert again[0].token_ids == first[0].token_ids
    finally:
        mgr.stop()
    assert mgr._watchdog is None


def test_watchdog_off_at_zero_and_for_a_handed_engine(tiny, monkeypatch):
    """IDLE_TIMEOUT=0 turns the unload off; a manager handed an engine has
    nothing to load again and starts no watchdog."""
    monkeypatch.setenv("MODEL_ID", tiny)
    monkeypatch.setenv("IDLE_TIMEOUT", "0")
    monkeypatch.setenv("ASR_WATCHDOG_INTERVAL", "0.1")
    mgr = ModelManager(device="cpu")
    mgr.start()
    try:
        mgr.ensure_loaded()
        time.sleep(0.5)
        assert mgr.engine is not None
    finally:
        mgr.stop()
    handed = ModelManager(load_engine(tiny, device="cpu"))
    handed.idle_timeout = 0.01
    handed.start()
    try:
        assert handed._watchdog is None and not handed.lazy
        assert handed.device == torch.device("cpu")
    finally:
        handed.stop()


def test_speculative_uses_draft(monkeypatch):
    """USE_SPECULATIVE with ASR_SPECULATIVE_MODE=result: a short clean
    draft stands; a long one goes to the main engine."""
    monkeypatch.setenv("USE_SPECULATIVE", "true")
    monkeypatch.setenv("ASR_SPECULATIVE_MODE", "result")
    mgr = ModelManager()
    mgr.engine = FakeEngine("full model output")
    mgr.fast_engine = FakeEngine("short draft")
    out = mgr.transcribe_sync(None, 16000, "en", False)
    assert out[0].text == "short draft"
    assert mgr.engine.calls == 0
    mgr.fast_engine = FakeEngine("x" * 150)
    out = mgr.transcribe_sync(None, 16000, "en", False)
    assert out[0].text == "full model output"
    assert mgr.engine.calls == 1
    # a bracketed draft goes to the verifier too; a partial (use_fast) or
    # a resume tick keeps its own path
    mgr.fast_engine = FakeEngine("[music]")
    assert mgr.transcribe_sync(None, 16000, "en", False)[0].text == \
        "full model output"
    assert mgr.transcribe_sync(None, 16000, "en", False,
                               use_fast=True)[0].text == "[music]"
    assert mgr.transcribe_sync(None, 16000, "en", False,
                               resume_tokens=[1])[0].text == \
        "full model output"


def test_dual_model_fast_for_partials():
    mgr = ModelManager()
    mgr.engine = FakeEngine("full")
    mgr.fast_engine = FakeEngine("fast")
    assert mgr.transcribe_sync(None, 16000, "en", False,
                               use_fast=True)[0].text == "fast"
    assert mgr.transcribe_sync(None, 16000, "en", False,
                               use_fast=False)[0].text == "full"
    mgr.fast_engine = None
    assert mgr.transcribe_sync(None, 16000, "en", False,
                               use_fast=True)[0].text == "full"


def test_unload_race_reloads_on_infer_thread(tiny, monkeypatch):
    """A job admitted just before an idle unload runs after it on the one
    device thread: it loads the engine again instead of failing."""
    monkeypatch.setenv("MODEL_ID", tiny)
    mgr = ModelManager(device="cpu")
    mgr.queue.start()
    try:
        mgr.ensure_loaded()
        mgr.loaded_model_id = None
        mgr.engine = None
        mgr.fast_engine = None
        audio = np.zeros(1600, np.float32) + 0.01
        res = mgr.queue.submit(
            lambda: mgr.transcribe_sync(audio, 16000, "en", False)
        ).result(120)
        assert mgr.engine is not None and isinstance(res, list)
        # the micro-batcher's dispatch reloads the same way
        mgr.engine = None
        got = mgr.batcher.transcribe(audio, 16000, "en").result(120)
        assert mgr.engine is not None and got[0].token_ids == res[0].token_ids
    finally:
        mgr.queue.stop()


def test_unload_skipped_while_work_waits(tiny, monkeypatch):
    """The unload re-checks on the device thread: a queued job, or rows in
    the pool, keep the engine."""
    monkeypatch.setenv("MODEL_ID", tiny)
    mgr = ModelManager(device="cpu")
    mgr.idle_timeout = 0
    mgr.queue.start()
    gate, started = threading.Event(), threading.Event()
    try:
        mgr.ensure_loaded()
        engine = mgr.engine
        time.sleep(0.01)

        def hold():
            started.set()
            gate.wait(10)
        busy = mgr.queue.submit(hold)
        started.wait(10)
        unload = mgr.queue.submit(mgr._unload_sync)
        waiting = mgr.queue.submit(lambda: None)    # queued behind it
        gate.set()
        unload.result(30)
        waiting.result(30)
        busy.result(30)
        assert mgr.engine is engine

        class BusyPool:
            depth, stopped = 2, False

            def stop(self):
                self.stopped = True
        mgr.pool = pool = BusyPool()
        time.sleep(0.01)
        mgr.queue.submit(mgr._unload_sync).result(30)
        assert mgr.engine is engine and not pool.stopped
        pool.depth = 0
        mgr.queue.submit(mgr._unload_sync).result(30)
        assert mgr.engine is None and pool.stopped and mgr.pool is None
    finally:
        mgr.queue.stop()


def test_unload_stops_pool_releases_sessions_and_aligner(tiny, monkeypatch):
    """An unload stops the decode pool, releases every registered stream
    session (a prefix session and a group member) and unloads the forced
    aligner; ``/health``'s fields say nothing is loaded."""
    from qwen3_asr_tpu_torch.serving.server import device_bytes
    from qwen3_asr_tpu_torch.sidecars import subtitle
    monkeypatch.setenv("MODEL_ID", tiny)
    monkeypatch.setenv("ASR_CONTINUOUS_BATCHING", "true")
    monkeypatch.setenv("ASR_POOL_SLOTS", "2")
    monkeypatch.setattr(subtitle, "FORCED_ALIGNER_ID", tiny)
    mgr = ModelManager(device="cpu")
    mgr.queue.start()
    try:
        mgr.ensure_loaded()
        engine, pool = mgr.engine, mgr.pool
        assert pool is not None and pool._running
        mgr.queue.submit(lambda: subtitle.load_aligner("cpu")).result(60)
        assert subtitle.aligner_loaded()
        session = engine.stream_session(2.0, "en")
        member = engine.stream_group_member(2.0, "en", slots=2)
        for s in (session, member):
            mgr.register_stream_session(s)
        assert device_bytes(mgr) > 0
        mgr.idle_timeout = 0
        time.sleep(0.01)
        mgr.queue.submit(mgr._unload_sync).result(60)
        assert mgr.engine is None and mgr.pool is None
        assert not pool._running
        assert session.engine is None and session.work is None
        assert member.engine is None and member.group is None
        assert not subtitle.aligner_loaded()
        assert mgr.last_stream_session is None and device_bytes(mgr) == 0
        # nothing the manager, its queue or its batchers keep holds the
        # engine: its tensors go with it
        gone = weakref.ref(engine)
        del engine, pool, session, member
        gc.collect()
        assert gone() is None
    finally:
        mgr.queue.stop()
        subtitle.unload_aligner()


def test_fast_model_that_cannot_load(tiny, monkeypatch, caplog):
    """DUAL_MODEL with a FAST_MODEL_ID that does not load: logged, and the
    main engine serves alone (on the device asked for)."""
    monkeypatch.setenv("MODEL_ID", tiny)
    monkeypatch.setenv("DUAL_MODEL", "true")
    monkeypatch.setenv("FAST_MODEL_ID", os.path.join(tiny, "missing"))
    mgr = ModelManager(device="cpu")
    mgr.queue.start()
    try:
        with caplog.at_level(logging.ERROR):
            mgr.ensure_loaded()
        assert "Fast model load failed" in caplog.text
        assert mgr.engine is not None and mgr.fast_engine is None
        assert mgr.engine.device == torch.device("cpu")
        audio = np.zeros(1600, np.float32) + 0.01
        res = mgr.queue.submit(lambda: mgr.transcribe_sync(
            audio, 16000, "en", False, use_fast=True)).result(60)
        assert res[0].token_ids
    finally:
        mgr.queue.stop()


def test_same_fast_and_main_model_loads_once(tiny, monkeypatch, caplog):
    monkeypatch.setenv("MODEL_ID", tiny)
    monkeypatch.setenv("USE_SPECULATIVE", "true")
    monkeypatch.setenv("FAST_MODEL_ID", tiny)
    mgr = ModelManager(device="cpu")
    mgr.queue.start()
    try:
        with caplog.at_level(logging.INFO):
            mgr.ensure_loaded()
        assert "skipping dual load" in caplog.text
        assert mgr.fast_engine is None and mgr.engine.draft_model is None
    finally:
        mgr.queue.stop()


def test_tick_batcher_routes_use_fast_to_the_fast_engine():
    """``transcribe_tick(use_fast=True)`` keys by (fast, bucket) and runs
    on the fast engine when one is loaded, else on the main engine."""
    mgr = ModelManager()
    mgr.engine, mgr.fast_engine = FakeEngine("main"), FakeEngine("fast")
    batcher = TickBatcher(mgr, window_ms=1)
    mgr.queue.start()
    try:
        pcm = np.zeros(1600, np.float32)
        assert batcher.transcribe_tick(pcm, "en", None,
                                       use_fast=True).result(10)[0] == "fast"
        assert batcher.transcribe_tick(pcm, "en", None,
                                       use_fast=False).result(10)[0] == \
            "main"
        assert len(mgr.fast_engine.runs) == len(mgr.engine.runs) == 1
        mgr.fast_engine = None
        assert batcher.transcribe_tick(pcm, "en", [3],
                                       use_fast=True).result(10)[0] == \
            "main"
        assert mgr.engine.runs[-1][1]["resume_tokens"] == [3]
    finally:
        mgr.queue.stop()


def test_ws_prefix_session_rebinds_after_unload(monkeypatch):
    """A prefix session whose engine an unload took is bound anew on the
    next tick (to the reloaded engine), and ticks as a fresh session."""
    from qwen3_asr_tpu_torch.serving import ws
    monkeypatch.setenv("MODEL_ID", CKPT)
    monkeypatch.setattr(ws, "WS_WINDOW_MAX_S", 4.0)
    audio, _ = _clip()
    window = audio[:int(2.5 * 16000)].astype(np.float32) / 32768.0
    mgr = ModelManager(device="cpu")
    mgr.queue.start()
    try:
        session, err = ws.session_for_tick(mgr, None, "en")
        assert err is None and session.engine is mgr.engine
        first = mgr.queue.submit(lambda: session.update(window)).result(60)
        same, _ = ws.session_for_tick(mgr, session, "en")
        assert same is session
        mgr.idle_timeout = 0
        time.sleep(0.01)
        mgr.queue.submit(mgr._unload_sync).result(60)
        assert mgr.engine is None and session.engine is None
        rebound, err = ws.session_for_tick(mgr, session, "en")
        assert err is None and rebound is not session
        assert rebound.engine is mgr.engine is not None
        got = mgr.queue.submit(lambda: rebound.update(window)).result(60)
        fresh = load_engine(CKPT, device="cpu").stream_session(4.0, "en")
        want = fresh.update(window)
        assert got == want == first
        assert mgr.last_stream_session is rebound
    finally:
        mgr.queue.stop()


def test_speculative_manager_attaches_the_draft(monkeypatch):
    """USE_SPECULATIVE=true with FAST_MODEL_ID: the fast engine's model is
    the main engine's draft (token mode), and a request's ids are the
    plain greedy ones."""
    monkeypatch.setenv("MODEL_ID", CKPT)
    monkeypatch.setenv("USE_SPECULATIVE", "true")
    monkeypatch.setenv("FAST_MODEL_ID", DRAFT)
    mgr = ModelManager(device="cpu")
    mgr.queue.start()
    try:
        mgr.ensure_loaded()
        assert mgr.engine.draft_model is mgr.fast_engine.model
        audio, sr = _clip()
        got = mgr.queue.submit(lambda: mgr.transcribe_sync(
            audio, sr, "en", False)).result(120)
        assert mgr.engine.last_run["spec"]
        want = load_engine(CKPT, device="cpu").transcribe(audio, sr, "en")
        assert got[0].token_ids == want[0].token_ids
    finally:
        mgr.queue.stop()


# -- the lazy server -------------------------------------------------------------

@contextlib.contextmanager
def _serving(manager):
    manager.start()
    server = build_server(manager, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        manager.stop()
        thread.join(timeout=10)


def _health(url):
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        return json.loads(r.read())


def _post(url, data: bytes):
    bnd = uuid.uuid4().hex
    body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"language\""
            f"\r\n\r\nen\r\n--{bnd}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"a.wav\"\r\n\r\n").encode() + data + \
        f"\r\n--{bnd}--\r\n".encode()
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={bnd}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_lazy_server_idle_unload_and_reload(tiny, monkeypatch):
    """``e2e/test_idle_reload.py`` in process: /health answers before the
    first load (model_loaded false, no memory fields); the first upload
    loads; the watchdog unloads (model_loaded false, model_id null) and
    nothing keeps the engine; the next upload loads again and answers the
    same text."""
    monkeypatch.setenv("MODEL_ID", CKPT)
    monkeypatch.setenv("IDLE_TIMEOUT", "1")
    monkeypatch.setenv("ASR_WATCHDOG_INTERVAL", "0.2")
    with open(CLIP, "rb") as f:
        wav = f.read()
    manager = ModelManager(device="cpu")
    with _serving(manager) as url:
        h = _health(url)
        assert h["status"] == "ok" and h["model_loaded"] is False
        assert h["model_id"] is None and "device_arrays_mb" not in h
        assert "hbm_used_mb" not in h and h["device"] == "cpu"
        status, first = _post(url, wav)
        assert status == 200 and first["text"]
        h = _health(url)
        assert h["model_loaded"] is True and h["model_id"] == CKPT
        assert h["executable_count"] >= 1 and h["device_arrays_mb"] >= 0
        gone = weakref.ref(manager.engine)
        _wait(lambda: _health(url)["model_loaded"] is False, 30,
              "the idle unload")
        assert _health(url)["model_id"] is None
        # once the unload job has ended, nothing the server, the manager or
        # its batchers keep holds the engine
        manager.queue.submit(lambda: None).result(30)
        gc.collect()
        assert gone() is None
        status, again = _post(url, wav)
        assert status == 200 and again == first
        assert _health(url)["model_loaded"] is True
