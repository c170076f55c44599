"""Real-time transcription over ``WS /ws/transcribe``, on the standard
library.

Two parts:

1. **RFC 6455**, in ``serving/wsproto.py`` (no ``torch``, no ``numpy``:
   the gateway relays on it too): the opening handshake, the frame codec,
   ``upgrade`` for a request that reached the port's ``ThreadingHTTPServer``
   handler, and ``connect``, a client for tests and smoke runs.
2. **The session**, counterpart of ``qwen3_asr_tpu/serving/server.py:
   473-963`` (``_transcribe_with_context``, ``_trim_exact``,
   ``websocket_transcribe``) in its default configuration: the client
   streams s16le PCM; every ``WS_BUFFER_SIZE`` bytes (450 ms) the server
   re-transcribes its window (up to ``WS_WINDOW_MAX_S``, 6 s, trimmed from
   the front) and sends a partial; a ``flush`` action, or a VAD
   speech→silence edge debounced over ``ASR_VAD_FLUSH_TICKS`` silent
   ticks, sends a final and clears the window. Each tick decodes with
   resume (the previous partial's tokens as a self-draft), alone (mode
   ``solo``) or, in mode ``tick``, coalesced with other sessions' ticks by
   the manager's ``TickBatcher``; at ``ASR_WS_TICK_MIN_SESSIONS`` (3) or
   more sessions concurrent finals go through the micro-batcher. In mode
   ``prefix`` (``runtime/stream.py``) the connection binds a
   ``StreamSession`` and each partial is one job, ``session.update``, with
   cached encoder blocks and a persistent decoder cache; its window is
   trimmed in encoder-chunk quanta (sample-exact when the cap is under one
   chunk), and a parallel sample-exact window feeds flushes and finals,
   which keep the fused path. In mode ``grouped``
   (``runtime/stream_group.py``) the connection binds a member of a
   ``StreamGroup`` instead, and its partials go through the manager's
   ``GroupTickBatcher``, which runs the ticks of one group's members that
   land together as one pooled-cache dispatch; flushes and finals are
   those of mode ``prefix``. All of it on the express lane; with the
   decode pool running and ``ASR_POOL_WS=true``, a solo tick or flush goes
   to the pool instead.
   The host DSP of a tick (s16 → f32, the 300-3400 Hz bandpass) is numpy;
   the VAD runs on the manager's device.

The manager's engines may be unloaded while a connection idles and loaded
again by its next tick (``ensure_loaded`` at the connection and every
tick). Partials go to the fast engine when one is loaded (``DUAL_MODEL``),
finals to the main one; a prefix session or group member is bound to the
engine that serves partials, ``mgr.fast_engine or mgr.engine``, and bound
anew when that engine is gone (an unload released it), as JAX's
``session_for_tick`` (``server.py:684-707``); the trim quantum comes from
the same engine.

The messages and their order are the JAX server's: the greeting
``{"status": "connected", "sample_rate", "format", "buffer_size",
"window_max_s", "use_server_vad"}``; partials ``{"text", "is_partial":
true, "is_final": false}`` (only when the text is not empty); finals
(``is_final``: true); ``{"status": "buffer_reset"}``; ``{"status":
"configured", "language", "use_server_vad"}``; the structured errors
``INVALID_JSON``, ``UNKNOWN_ACTION``, ``UNSUPPORTED_SAMPLE_RATE``,
``SESSION_LIMIT_REACHED`` (then a close with 1013, past
``ASR_MAX_SESSIONS``) and ``WEBSOCKET_ERROR``; ``[timeout]`` and
``[error: ...]`` as a tick's text when its transcription fails.

A session or group member that cannot be bound is logged, counted
(``prefix_bind_failures``) and answered as the tick's ``[error: ...]``.
JAX serves the fused path in its place (``server.py:700-707``); the port
does not. A member is released when its connection closes, which frees
its slot.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import threading
import time
import uuid
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..audio.frontend import fir_bandpass_kernel, fir_same, pcm16_to_f32
from ..audio.vad import default_flush_ticks as _vad_default_flush_ticks
from ..audio.vad import is_speech
from ..config import _safe_int, resolve_ws_mode
from ..runtime.batcher import dispatch_engine
from ..runtime.queue import EXPRESS
from ..text.repetition import detect_and_fix_repetitions
from ..utils.logging import reset_request_id, set_request_id
# the codec's client stays importable from here for the module's callers
from .wsproto import CLOSE_TRY_AGAIN_LATER, connect, upgrade  # noqa: F401

log = logging.getLogger(__name__)

TARGET_SR = 16000
WS_BUFFER_SIZE = int(os.getenv("WS_BUFFER_SIZE",
                               str(int(TARGET_SR * 2 * 0.45))))
WS_FLUSH_SILENCE_MS = int(os.getenv("WS_FLUSH_SILENCE_MS", "600"))
WS_WINDOW_MAX_S = float(os.getenv("WS_WINDOW_MAX_S", "6.0"))
WS_WINDOW_MAX_BYTES = int(WS_WINDOW_MAX_S * TARGET_SR * 2)
ASR_USE_SERVER_VAD = os.getenv("ASR_USE_SERVER_VAD",
                               "true").lower() == "true"
# consecutive silent ticks before a VAD flush: 1 with the learned VAD, 2
# with the spectral one (audio/vad.py default_flush_ticks)
ASR_VAD_FLUSH_TICKS = max(1, _safe_int(
    "ASR_VAD_FLUSH_TICKS", str(_vad_default_flush_ticks())))

# prefix-mode sessions and group members that could not be bound (each
# answered as its tick's "[error: ...]")
prefix_bind_failures = 0
_failures_lock = threading.Lock()

# -- the session ----------------------------------------------------------------

_bandpass = None


def _bandpass_kernel() -> np.ndarray:
    global _bandpass
    if _bandpass is None:
        _bandpass = fir_bandpass_kernel()          # 300-3400 Hz
    return _bandpass


def _trim_exact(window: bytearray) -> None:
    """Sample-exact trim to the window cap, from the front."""
    if len(window) > WS_WINDOW_MAX_BYTES:
        del window[:((len(window) - WS_WINDOW_MAX_BYTES) // 2) * 2]


def trim_quantum_bytes(engine, prefix: bool) -> int:
    """The partial window's trim step: in mode ``prefix`` one encoder
    chunk (``n_window * 2`` frames: 2 s at preset:1.7b) of the engine that
    serves partials, so cached blocks stay on their grid between trims; a
    cap under one chunk holds no grid, and every other mode (or no engine
    loaded) trims sample-exact."""
    if not prefix or engine is None:
        return 2
    chunk_bytes = engine.model.cfg.encoder.n_window * 2 * 160 * 2
    return chunk_bytes if chunk_bytes <= WS_WINDOW_MAX_BYTES else 2


def _trim_partial(window: bytearray, quantum: int) -> None:
    """Trim the partial window to the cap, from the front, in
    ``quantum``-byte steps; never empty it (then sample-exact)."""
    if len(window) <= WS_WINDOW_MAX_BYTES:
        return
    trim = len(window) - WS_WINDOW_MAX_BYTES
    trim = -(-trim // quantum) * quantum if quantum > 2 else (trim // 2) * 2
    if trim >= len(window):
        trim = ((len(window) - WS_WINDOW_MAX_BYTES) // 2) * 2
    del window[:trim]


def partial_engine(mgr):
    """The engine that serves partials: the fast one when loaded."""
    return mgr.fast_engine or mgr.engine


def session_for_tick(mgr, session, lang_code, grouped: bool = False):
    """The connection's prefix-mode session (with ``grouped``, a member of
    a stream group) for its next partial: ``session`` while the engine it
    holds still serves partials; else a new one, built on the device
    thread (which loads the engines first when an unload won the race)
    for ``partial_engine(mgr)`` and registered with the manager. Returns
    (session, None), or (None, the exception that stopped the bind),
    logged and counted."""
    global prefix_bind_failures
    try:
        mgr.ensure_loaded()
        if session is not None and session.engine is not None \
                and session.engine is partial_engine(mgr):
            return session, None
        if session is not None:
            session.release()          # its engine is gone

        def bind():
            engine = dispatch_engine(mgr, use_fast=True)
            return (engine.stream_group_member if grouped
                    else engine.stream_session)(WS_WINDOW_MAX_S, lang_code)
        future = mgr.queue.submit(bind, priority=EXPRESS)
        session = future.result(timeout=mgr.request_timeout)
        mgr.register_stream_session(session)
        return session, None
    except Exception as e:
        with _failures_lock:
            prefix_bind_failures += 1
        log.error("[WS] prefix-cache session could not be bound: %s", e)
        return None, e


def _transcribe_with_context(mgr, audio_bytes: bytes, pad_silence: bool,
                             lang_code, use_vad: bool, resume_tokens=None,
                             tick_batch=None, session=None):
    """Bandpass, VAD gate and an express-lane transcription of a window's
    bytes → (text, token_ids). ``resume_tokens`` (the previous partial's)
    make it a resume run. A flush (``pad_silence``) appends
    ``WS_FLUSH_SILENCE_MS`` of silence; at ``ASR_WS_TICK_MIN_SESSIONS`` or
    more live sessions it goes through the micro-batcher with other
    sessions' finals. A partial in mode ``tick`` goes through the tick
    batcher, one with a prefix-mode ``session`` is ``session.update`` on
    the device thread, and one with a group member goes through the group
    tick batcher. A failure becomes ``[timeout]`` or ``[error: ...]``."""
    t0 = time.time()
    future = None
    try:
        # a tick after an idle unload loads the engines again
        mgr.ensure_loaded()
        full = bytearray(audio_bytes)
        if pad_silence:
            full.extend(bytes(int((WS_FLUSH_SILENCE_MS / 1000)
                                  * TARGET_SR * 2)))
        if not full:
            return "", None
        audio = fir_same(pcm16_to_f32(bytes(full)), _bandpass_kernel())
        if use_vad and not is_speech(audio, device=mgr.device):
            log.info("[WS] VAD: silence, skipping inference")
            return "", resume_tokens
        if session is not None and not pad_silence:
            if hasattr(session, "group"):
                future = mgr.group_tick_batcher.tick(session, audio)
            else:
                future = mgr.queue.submit(lambda: session.update(audio),
                                          priority=EXPRESS)
            raw, token_ids = future.result(timeout=mgr.request_timeout)
            return detect_and_fix_repetitions(raw), token_ids
        if tick_batch is None:
            tick_batch = os.getenv("ASR_WS_TICK_BATCH",
                                   "").lower() == "true"
        if not pad_silence and tick_batch:
            future = mgr.tick_batcher.transcribe_tick(
                audio, lang_code, resume_tokens, use_fast=True)
            raw, token_ids = future.result(timeout=mgr.request_timeout)
            return detect_and_fix_repetitions(raw), token_ids
        batch_flush = (
            pad_silence
            and os.getenv("ASR_WS_BATCH_FLUSH", "true").lower() == "true"
            and mgr.ws_sessions >= int(
                os.getenv("ASR_WS_TICK_MIN_SESSIONS", "3") or 3))
        # WS ticks keep the resume path unless ASR_POOL_WS=true, as in the
        # JAX server (qwen3_asr_tpu/serving/server.py:558-585)
        pool_ws = os.getenv("ASR_POOL_WS", "").lower() == "true"
        if batch_flush:
            # concurrent finals coalesce into one batched dispatch; their
            # results keep their token ids
            future = mgr.batcher.transcribe(audio, TARGET_SR, lang_code,
                                            priority=EXPRESS)
        elif pool_ws and mgr.pool_eligible(audio, TARGET_SR, False):
            future = mgr.transcribe_pooled(audio, TARGET_SR, lang_code)
        else:
            future = mgr.queue.submit(
                lambda: mgr.transcribe_sync(audio, TARGET_SR, lang_code,
                                            False, use_fast=not pad_silence,
                                            resume_tokens=resume_tokens),
                priority=EXPRESS)
        results = future.result(timeout=mgr.request_timeout)
        if results:
            text = detect_and_fix_repetitions(results[0].text)
            log.info("[WS] done in %.2fs, text_len=%d", time.time() - t0,
                     len(text))
            return text, results[0].token_ids
        return "", None
    except concurrent.futures.TimeoutError:
        if future is not None:
            future.cancel()
        log.warning("[WS] timed out after %.2fs (audio %.2fs)",
                    time.time() - t0, len(audio_bytes) / 2 / TARGET_SR)
        return "[timeout]", None
    except Exception as e:
        log.error("[WS] error after %.2fs: %s", time.time() - t0, e)
        return f"[error: {e}]", None


def websocket_transcribe(handler) -> None:
    """Serve one ``/ws/transcribe`` connection on ``handler``'s thread,
    from the upgrade to the close."""
    mgr = handler.server.manager
    query = {k: v[0] for k, v in
             parse_qs(urlsplit(handler.path).query).items()}
    ws = upgrade(handler)
    if ws is None:
        return
    req_id = query.get("request_id") or str(uuid.uuid4())
    # the session's lines carry its own id, as the JAX server's do
    token = set_request_id(req_id)
    log.info("[WS] client connected (%s)", req_id)
    audio_buffer, audio_window = bytearray(), bytearray()
    lang_code = "English"        # until a config action says otherwise
    use_vad = ASR_USE_SERVER_VAD
    if query.get("use_server_vad") is not None:
        use_vad = query["use_server_vad"].lower() in ("true", "1", "yes")
    sr_raw = query.get("sample_rate", str(TARGET_SR))
    try:
        client_sr = int(sr_raw)
    except ValueError:
        client_sr = -1
    resampler = None
    if client_sr == 8000:
        from ..audio.resample import StreamingResampler
        resampler = StreamingResampler(client_sr, TARGET_SR)
    chunk_count = 0
    prev_had_speech = False
    silent_ticks = 0             # consecutive silent ticks (VAD debounce)
    prev_tokens = None           # the last partial's ids (resume decoding)
    admitted = False
    # mode prefix: the connection's session, and the sample-exact window
    # that flushes and finals read (the partial window trims in chunks)
    stream_session = None
    exact_window = bytearray()
    try:
        if client_sr not in (8000, 16000):
            ws.send_json({"code": "UNSUPPORTED_SAMPLE_RATE",
                          "message": f"sample_rate must be 8000 or 16000, "
                                     f"got {sr_raw}",
                          "statusCode": 400})
            return
        max_sessions = int(os.getenv("ASR_MAX_SESSIONS", "0") or 0)
        with mgr.ws_lock:
            if max_sessions <= 0 or mgr.ws_sessions < max_sessions:
                mgr.ws_sessions += 1
                admitted = True
            sessions = mgr.ws_sessions
        if not admitted:
            log.warning("[WS] session limit reached (%d), rejecting",
                        max_sessions)
            ws.send_json({"code": "SESSION_LIMIT_REACHED",
                          "message": (f"server at capacity ({max_sessions} "
                                      "concurrent streaming sessions); "
                                      "retry later or add workers"),
                          "statusCode": 503})
            ws.close(CLOSE_TRY_AGAIN_LATER)
            return
        # fixed for the connection's lifetime
        ws_mode = resolve_ws_mode(WS_WINDOW_MAX_S, sessions)
        prefix = ws_mode.prefix
        mgr.ensure_loaded()

        def flush_bytes() -> bytes:
            return bytes(exact_window if prefix else audio_window)

        def clear_windows() -> None:
            audio_window.clear()
            exact_window.clear()
            if stream_session is not None:
                stream_session.reset()
        log.info("[WS] streaming mode: %s (cap=%ss, sessions=%d)",
                 ws_mode.name, WS_WINDOW_MAX_S, sessions)
        ws.send_json({"status": "connected", "sample_rate": client_sr,
                      "format": "pcm_s16le", "buffer_size": WS_BUFFER_SIZE,
                      "window_max_s": WS_WINDOW_MAX_S,
                      "use_server_vad": use_vad})
        while True:
            msg = ws.receive()
            if msg.kind == "close":
                break
            if msg.kind == "text":
                try:
                    cmd = json.loads(msg.data)
                    if not isinstance(cmd, dict):
                        raise ValueError("not an object")
                except ValueError:
                    log.warning("[WS] invalid JSON command: %r",
                                msg.data[:80])
                    ws.send_json({"code": "INVALID_JSON",
                                  "message": "Invalid JSON command",
                                  "statusCode": 400})
                    continue
                action = cmd.get("action", "")
                if action == "flush":
                    if audio_buffer:
                        audio_window.extend(audio_buffer)
                        if prefix:
                            exact_window.extend(audio_buffer)
                        audio_buffer.clear()
                    text = ""
                    payload = flush_bytes()
                    if payload:
                        text, _ = _transcribe_with_context(
                            mgr, payload, True, lang_code, use_vad,
                            resume_tokens=prev_tokens)
                        chunk_count += 1
                    ws.send_json({"text": text, "is_partial": False,
                                  "is_final": True})
                    clear_windows()
                    prev_tokens = None
                elif action == "reset":
                    audio_buffer.clear()
                    clear_windows()
                    prev_tokens = None
                    ws.send_json({"status": "buffer_reset"})
                elif action == "config":
                    new_lang = cmd.get("language")
                    if new_lang == "auto":
                        lang_code = None
                    elif new_lang:
                        lang_code = new_lang
                    if new_lang and stream_session is not None:
                        # the prompt changed: a new session next tick
                        stream_session.release()
                        stream_session = None
                    if "use_server_vad" in cmd:
                        use_vad = bool(cmd["use_server_vad"])
                    ws.send_json({"status": "configured",
                                  "language": lang_code or "auto",
                                  "use_server_vad": use_vad})
                else:
                    log.warning("[WS] unknown action: %r", action)
                    ws.send_json({"code": "UNKNOWN_ACTION",
                                  "message": f"Unknown action: {action!r}",
                                  "statusCode": 400})
                continue
            incoming = msg.data
            if resampler is not None:
                incoming = resampler.process_pcm(incoming)
            audio_buffer.extend(incoming)
            if len(audio_buffer) < WS_BUFFER_SIZE:
                continue
            audio_window.extend(audio_buffer)
            if prefix:
                exact_window.extend(audio_buffer)
                _trim_exact(exact_window)
            audio_buffer.clear()
            _trim_partial(audio_window,
                          trim_quantum_bytes(partial_engine(mgr), prefix))
            vad_flushed = False
            if use_vad:
                tail = bytes(audio_window[-WS_BUFFER_SIZE:])
                has_speech = is_speech(pcm16_to_f32(tail),
                                       device=mgr.device)
                if has_speech:
                    prev_had_speech, silent_ticks = True, 0
                else:
                    silent_ticks += 1
                if (not has_speech and prev_had_speech
                        and silent_ticks >= ASR_VAD_FLUSH_TICKS):
                    # a debounced speech→silence edge: a final
                    prev_had_speech, silent_ticks = False, 0
                    vad_flushed = True
                    text, _ = _transcribe_with_context(
                        mgr, flush_bytes(), True, lang_code, use_vad,
                        resume_tokens=prev_tokens)
                    chunk_count += 1
                    if text:
                        ws.send_json({"text": text, "is_partial": False,
                                      "is_final": True})
                    clear_windows()
                    prev_tokens = None
            if not vad_flushed:
                bind_error = None
                if prefix:
                    stream_session, bind_error = session_for_tick(
                        mgr, stream_session, lang_code, grouped=ws_mode.tick)
                if bind_error is not None:
                    # no fused fallback: the tick fails as it is
                    text, prev_tokens = f"[error: {bind_error}]", None
                else:
                    text, prev_tokens = _transcribe_with_context(
                        mgr, bytes(audio_window), False, lang_code,
                        use_vad, resume_tokens=prev_tokens,
                        tick_batch=ws_mode.tick, session=stream_session)
                chunk_count += 1
                if text:
                    ws.send_json({"text": text, "is_partial": True,
                                  "is_final": False})
        # disconnect: transcribe what is left, as the JAX server does
        if audio_buffer:
            audio_window.extend(audio_buffer)
            if prefix:
                exact_window.extend(audio_buffer)
        payload = flush_bytes()
        if payload:
            text, _ = _transcribe_with_context(
                mgr, payload, True, lang_code, use_vad,
                resume_tokens=prev_tokens)
            chunk_count += 1
            if text:
                log.info("[WS] final transcription on disconnect: %s", text)
        log.info("[WS] client disconnected, chunks processed: %d",
                 chunk_count)
    except Exception as e:
        log.error("WebSocket error: %s", e)
        try:
            ws.send_json({"code": "WEBSOCKET_ERROR", "message": str(e),
                          "statusCode": 500})
        except OSError:
            pass
    finally:
        if admitted:
            with mgr.ws_lock:
                mgr.ws_sessions -= 1
        if stream_session is not None:
            # its device buffers (or its group's slot) must not outlive
            # the connection
            stream_session.release()
        reset_request_id(token)
        ws.close()
