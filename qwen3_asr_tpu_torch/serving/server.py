"""HTTP server for the port, on the standard library.

Counterpart of ``qwen3_asr_tpu/serving/server.py``'s public routes, with
its request forms, answers, error codes and statuses:

- ``GET /health``, with JAX's fields (``model_loaded`` and ``model_id``,
  false and null before the first load and after an idle unload; while
  loaded ``model_params_m``, ``hbm_used_mb`` and ``hbm_limit_mb`` only for
  an engine on the card, ``device_arrays_mb``: both engines' weights and
  keys, the pool, the stream sessions' and groups' stashed state and the
  aligner's weights, ``executable_count``: both engines' bucket, spec and
  stream keys, the live stream groups and the pool's graphs; ``device``
  as the card's kind and ``num_devices`` always), the forced
  aligner's state (``aligner``: ``loaded``, ``unavailable_retrying`` or
  ``not_loaded``) and, when the decode pool runs,
  ``continuous_batching`` (``slots``, ``window``, ``depth``);
- ``POST /v1/audio/transcriptions`` (multipart ``file``, ``language``,
  ``return_timestamps``): ``{"text", "language"}`` and, with timestamps,
  ``"timestamps"``; under ``ASR_TIMESTAMP_MODE=accurate`` (the default)
  the aligner of ``FORCED_ALIGNER_ID`` is loaded first, and a failed load
  is retried no sooner than ``ASR_ALIGNER_RETRY_S`` (300 s) later, the
  words timed by char-proportional estimates meanwhile;
- ``POST /v1/audio/transcriptions/stream``: server-sent events over
  HTTP/1.1 chunked transfer, one flushed chunk an event; chunks of
  ``SSE_CHUNK_SECONDS`` stepping back by ``SSE_OVERLAP_SECONDS``, each
  through the micro-batcher (concurrent streams share dispatches), then
  ``{"done": true}``, or the ``SSE_STREAM_ERROR`` event;
- ``POST /v1/audio/subtitles`` (``mode`` ``fast`` or ``accurate``,
  ``max_line_chars``): an SRT attachment (``sidecars/subtitle.py``);
- ``POST /v1/audio/translations`` (``language`` ``en``/``zh``,
  ``response_format`` ``json`` or ``srt``): the transcript through an
  OpenAI-compatible LLM (``sidecars/translator.py``), 502
  TRANSLATION_FAILED when it fails;
- ``WS /ws/transcribe`` (``serving/ws.py``: the upgrade, the frame codec
  and the streaming session);
- ``GET /metrics`` (``qwen3_asr_tpu/serving/server.py:75-84``): the
  manager's registry (``utils/telemetry.py``) in the Prometheus text
  format, its gauges ``asr_model_loaded``, ``asr_queue_depth`` and
  ``asr_ws_sessions`` read at the scrape. Every other request is counted
  in ``asr_requests_total{path, method, status}`` under its route, or
  ``unmatched`` for a 404, and a matched route's wall goes into
  ``asr_request_duration_seconds`` (JAX's ``request_id_middleware``,
  ``http.py:30-70``): a WS session when it closes (status 101), an SSE
  stream when it ends;
- ``POST /debug/trace?seconds=N`` (``server.py:959-1001``): a
  ``torch.profiler`` capture of N seconds (3, at most 60; CPU activity, and
  CUDA activity for a manager on the card) written as a Chrome trace into
  ``ASR_TRACE_DIR`` (``/tmp/qwen3_asr_traces``); the recording stops
  early at ``TRACE_RECORD_BUDGET`` device records (a loaded server takes
  that many in about a second) and the request still takes the N seconds
  and the stop; answering ``{"trace_dir", "seconds"}`` and, beyond JAX's
  body, ``captured_seconds``, ``kernel_records`` and ``budget_reached``;
  400 ``INVALID_JSON`` for a non-number, 409 ``WORKER_ERROR``
  while another capture runs, 500 when the profiler fails. The profiler
  starts and stops under ``runtime/graphs.py`` ``capture_lock``, so neither
  falls inside a CUDA-graph capture; it starts and stops under
  ``device_lock`` too, so a replay is recorded whole or not at all and
  none runs while the profiler processes its records (a stop beside
  replays hung under load; ``PERF.md`` §6); CUPTI records the kernels
  of every thread, the device thread's and the pool's too;
- ``GET /openapi.json`` and ``GET /docs``: the JAX server's OpenAPI
  document and docs page (``serving/http.py``, ``meta.py``,
  ``schemas.py``).

Each request runs on its own thread. Every route first has the manager
load its engines if they are not loaded (``ensure_loaded``: the first
request after start or after an idle unload pays the load; a failed load
answers 500 ``MODEL_LOAD_FAILED``). All device work (loads and unloads,
transcriptions, the aligner's load and alignments) runs as jobs of the
manager's queue on its one device thread, which serializes it, so the
handlers need no lock;
concurrent same-bucket uploads and SSE chunks go through the
micro-batcher, which joins them into one batched engine run. A WS
connection holds its thread for its lifetime. Every response carries
``X-Request-ID`` (the request's own, or a new one), which the request's
log lines carry as ``requestId`` (``utils/logging.py``; a WS session's
lines carry its ``request_id`` query parameter, or a new id), and an
upload may come with ``Content-Length`` or ``Transfer-Encoding: chunked``.

Run: ``MODEL_ID=e2e/data/trained_ckpt python -m
qwen3_asr_tpu_torch.serving.server [--port 8000] [--device cuda]``: it
checks the environment (``config.py`` ``validate_env``: every problem
logged, then exit 1) and logs JSON lines at ``LOG_LEVEL``.
``MODEL_ID`` is a checkpoint directory or ``preset:NAME`` (zero weights),
loaded on the first request (``runtime/lifecycle.py``: ``IDLE_TIMEOUT``,
``ASR_WATCHDOG_INTERVAL``; ``FAST_MODEL_ID`` with ``DUAL_MODEL`` or
``USE_SPECULATIVE``, ``ASR_SPECULATIVE_MODE``, ``ASR_SPEC_GAMMA``);
``QUANTIZE`` (``int8``, ``fp8``, ``int4`` with ``ASR_INT4_GROUP``),
``ASR_KV_CACHE_DTYPE`` (``bf16``, ``fp8``, ``int4``), ``ASR_INT8_ACT``,
``ASR_MAX_BATCH`` (8),
``ASR_BATCH_WINDOW_MS`` (20) and ``REQUEST_TIMEOUT`` (300 s) tune it;
``ASR_CONTINUOUS_BATCHING=true`` sends uploads, SSE chunks and batched WS
flushes that can pool to the decode pool (``runtime/pool.py``;
``ASR_POOL_SLOTS``, ``ASR_POOL_MAX_SLOTS``, ``ASR_POOL_SEGMENT``,
``ASR_POOL_WS``);
the WS session's knobs are listed in ``serving/ws.py``, the translator's
in ``sidecars/translator.py``.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import torch

from .. import config
from ..audio.codec import AudioDecodeError, decode_audio
from ..runtime.graphs import (capture_lock, device_lock, replayed_nodes,
                              wait_for_nodes)
from ..runtime.lifecycle import ModelManager
from ..ops.quant import param_count
from ..runtime.queue import STANDARD
from ..sidecars import subtitle
from ..text.repetition import detect_and_fix_repetitions
from ..utils.logging import setup_logging
from . import ws
from .http import Answered, DOCS_HTML, JsonHandler, build_openapi, parse_bool
from .meta import API_TITLE, API_VERSION, route_metadata
from .schemas import API_DESCRIPTION, API_TAGS

log = logging.getLogger(__name__)

def merge_results(results) -> Tuple[str, str]:
    """Join per-segment results into the one response the API promises."""
    text = " ".join(r.text for r in results if r.text)
    language = next((r.language for r in results if r.language), "")
    return text, language


def merge_timestamps(results) -> Optional[list]:
    """Every segment's word timestamps in order, or None if there are none."""
    stamps = [w for r in results for w in (r.timestamps or [])]
    return stamps or None


def sse_events(manager: ModelManager, audio, sr: int,
               lang_code: Optional[str], return_timestamps: bool):
    """The SSE ``data:`` lines of one streamed transcription, as the JAX
    server's ``sse_transcribe_generator`` yields them. Each chunk is a
    micro-batcher request, so chunks of concurrent streams that land in
    one bucket share a dispatch (a stream's own chunks stay in order)."""
    audio_duration = len(audio) / sr
    t0 = time.time()
    chunk_count = 0
    log.info("SSE stream | audio=%.2fs lang=%s", audio_duration,
             lang_code or "auto")

    def transcribe(clip):
        return manager.batcher.transcribe(clip, sr, lang_code,
                                          return_timestamps).result(
            timeout=manager.request_timeout)

    try:
        target = ws.TARGET_SR
        chunk_samples = target * config.SSE_CHUNK_SECONDS
        overlap_samples = target * config.SSE_OVERLAP_SECONDS
        if sr != target:
            chunk_samples = sr * config.SSE_CHUNK_SECONDS
            overlap_samples = sr * config.SSE_OVERLAP_SECONDS
        if overlap_samples >= chunk_samples:
            # overlap >= chunk would advance by zero samples and transcribe
            # the same chunk forever
            log.warning("SSE_OVERLAP_SECONDS >= SSE_CHUNK_SECONDS; "
                        "clamping overlap to half a chunk")
            overlap_samples = chunk_samples // 2

        if len(audio) <= chunk_samples:
            results = transcribe(audio)
            if results:
                data = {"text": detect_and_fix_repetitions(results[0].text),
                        "language": results[0].language, "is_final": True}
                if return_timestamps and results[0].timestamps:
                    data["timestamps"] = results[0].timestamps
            else:
                data = {"text": "", "language": lang_code or "auto",
                        "is_final": True}
            chunk_count += 1
            yield f"data: {json.dumps(data)}\n\n"
        else:
            start = 0
            chunk_index = 0
            while start < len(audio):
                end = min(start + chunk_samples, len(audio))
                is_last = end >= len(audio)
                results = transcribe(audio[start:end])
                if results:
                    data = {"text": detect_and_fix_repetitions(results[0].text),
                            "language": results[0].language,
                            "is_final": is_last, "chunk_index": chunk_index}
                else:
                    data = {"text": "", "language": lang_code or "auto",
                            "is_final": is_last, "chunk_index": chunk_index}
                chunk_count += 1
                yield f"data: {json.dumps(data)}\n\n"
                chunk_index += 1
                if is_last:
                    break
                start = end - overlap_samples

        log.info("SSE stream | done chunks=%d elapsed=%.2fs", chunk_count,
                 time.time() - t0)
        yield f"data: {json.dumps({'done': True})}\n\n"
    except Exception as e:  # the stream ends with an error event
        log.exception("SSE stream | error after %.2fs", time.time() - t0)
        yield ("data: " + json.dumps({
            "code": "SSE_STREAM_ERROR", "message": str(e),
            "statusCode": 500}) + "\n\n")


def health_memory(device: torch.device) -> dict:
    """The card's memory in MB as JAX's ``/health`` reports it
    (``hbm_used_mb`` in use by the allocator, ``hbm_limit_mb`` the card's
    total); neither key for an engine on the CPU, which has no such stats
    (JAX's ``lifecycle.py:532``)."""
    if device.type != "cuda":
        return {}
    used = torch.cuda.memory_stats(device).get(
        "allocated_bytes.all.current", 0)
    _, total = torch.cuda.mem_get_info(device)
    return {"hbm_used_mb": round(used / 1024 ** 2),
            "hbm_limit_mb": round(total / 1024 ** 2)}


def device_bytes(mgr) -> int:
    """``/health``'s ``device_arrays_mb`` in bytes: every tensor the server
    holds on its device (the e2e memory gate's source where the device has
    no memory stats): both engines' weights, keys and stream groups'
    stashed state, the decode pool's, the registered stream sessions'
    stashed state and the forced aligner's weights, each once; 0 while
    nothing is loaded."""
    engine, fast, pool = mgr.engine, mgr.fast_engine, mgr.pool
    if engine is None:
        return 0
    return (engine.held_bytes() + (fast.held_bytes() if fast else 0)
            + (pool.held_bytes() if pool else 0)
            + mgr.stream_session_bytes()
            + subtitle.aligner_bytes(engine.model.params))


# A capture stops recording once the device records it has taken (graph
# nodes replayed, ``runtime/graphs.py`` ``replayed_nodes``) reach this
# budget: stopping the profiler and writing its trace hold the GIL
# ~60-110 µs a kernel record (PERF.md §6), so the budget, not the
# seconds asked for, bounds the stall a capture costs a loaded server
# (15-28 s). An idle server records none.
TRACE_RECORD_BUDGET = 250_000


def trace_activities(device) -> list:
    """What a capture records: the CPU's ops, and for a manager on the
    card its activity too (CUPTI: every kernel, graph nodes one by one).
    The card's activity alone is not taken: with torch 2.11 its stop held
    the GIL for over 200 s after one second of a loaded server's work,
    where both together took 19 s after two (PERF.md §6)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(device) -> torch.profiler.profile:
    """A started profiler of ``trace_activities(device)``. Started under
    ``capture_lock``, so never inside a graph capture, and under
    ``device_lock``, so no replay is being enqueued meanwhile: the replays
    after the start are recorded whole."""
    prof = torch.profiler.profile(activities=trace_activities(device))
    with capture_lock, device_lock:
        prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, trace_dir: str) -> str:
    """Stop ``prof`` as it started, under ``capture_lock`` and
    ``device_lock``, and write its Chrome trace into ``trace_dir`` (with
    no lock); returns the file's path. No replay is enqueued while the
    profiler flushes and processes CUPTI's records: a stop beside running
    replays held the GIL for over 200 s in five of seven captures under
    load, and the stop holds the GIL anyway, so replays gained nothing from
    it (PERF.md §6). Logs the stop's and the write's seconds apart."""
    t0 = time.perf_counter()
    with capture_lock, device_lock:
        prof.stop()
    t1 = time.perf_counter()
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    t2 = time.perf_counter()
    log.info("Profiler trace stopped in %.3fs, written in %.3fs | %s",
             t1 - t0, t2 - t1, path)
    return path


def capture(seconds: float, budget: int) -> Tuple[float, int]:
    """Wait while a started profiler records, for ``seconds`` or until the
    graph nodes replayed meanwhile reach ``budget``, whichever comes
    first; returns (seconds recorded, nodes replayed meanwhile)."""
    n0, t0 = replayed_nodes(), time.perf_counter()
    cut = seconds > 0 and wait_for_nodes(budget, seconds)
    return (time.perf_counter() - t0 if cut else seconds,
            replayed_nodes() - n0)


class _Handler(JsonHandler):
    server: "AsrServer"

    def routes(self, method: str) -> dict:
        if method == "GET":
            return {"/health": self._health,
                    "/ws/transcribe": self._websocket,
                    "/metrics": self._metrics,
                    "/openapi.json": self._openapi,
                    "/docs": self._docs}
        return {
            "/v1/audio/transcriptions": self._upload(self._transcriptions),
            "/v1/audio/transcriptions/stream": self._upload(self._stream),
            "/v1/audio/subtitles": self._upload(self._subtitles),
            "/v1/audio/translations": self._upload(self._translations),
            "/debug/trace": self._debug_trace}

    def count(self, route: str, method: str, status: int,
              seconds: float) -> None:
        """Counted as JAX's ``request_id_middleware`` counts: under its
        route, or ``unmatched``; a matched route's wall too; not
        ``/metrics``."""
        self.server.count_request(route, method, status, seconds)

    def _upload(self, route, load: bool = True):
        """A POST route that reads a multipart upload and (unless ``load``
        is false: the route loads them itself) needs the engines loaded."""
        def run():
            try:
                fields, file_bytes, _ = self._read_upload()
                if load:
                    self._ensure_loaded()
                route(fields, file_bytes)
            except Answered:
                pass
        return run

    def _websocket(self):
        ws.websocket_transcribe(self)

    def _health(self):
        self._json(200, {**self.server.manager_health(),
                         "aligner": self.server.aligner_state()})

    def _metrics(self):
        mgr = self.server.manager
        mgr.metrics.gauge("asr_model_loaded",
                          1.0 if mgr.engine is not None else 0.0)
        mgr.metrics.gauge("asr_queue_depth", float(mgr.queue.depth))
        mgr.metrics.gauge("asr_ws_sessions", float(mgr.ws_sessions))
        self._send(200, "text/plain; charset=utf-8",
                   mgr.metrics.render().encode("utf-8"))

    def _openapi(self):
        self._json(200, self.server.openapi)

    def _docs(self):
        self._send(200, "text/html; charset=utf-8",
                   DOCS_HTML.format(title=API_TITLE).encode("utf-8"))

    def _debug_trace(self):
        """A profiler trace of ``seconds`` (3, at most 60), one at a time.

        The request takes as long as JAX's: the seconds asked and the
        stop. But the recording stops once ``TRACE_RECORD_BUDGET`` device
        records are taken; the trace is then stopped and written at once,
        and the rest of the seconds is waited out after. The answer is JAX's
        ``{"trace_dir", "seconds"}`` and, a divergence (ROADMAP §3), the
        seconds recorded (``captured_seconds``), the records estimated
        (``kernel_records``) and whether the budget ended the recording
        (``budget_reached``)."""
        try:
            self._read_upload()
        except Answered:
            return
        query = parse_qs(urlsplit(self.path).query)
        try:
            seconds = min(float(query.get("seconds", ["3"])[0]), 60.0)
        except ValueError:
            self._error("INVALID_JSON", "seconds must be a number", 400)
            return
        lock = self.server.trace_lock
        if not lock.acquire(blocking=False):
            self._error("WORKER_ERROR",
                        "a profiler trace is already in progress", 409)
            return
        # every answer is sent once the lock is free, so a client that is
        # answered can start the next capture at once
        failure, asked = None, max(seconds, 0.0)
        captured, records = 0.0, 0
        try:
            trace_dir = os.getenv("ASR_TRACE_DIR", "/tmp/qwen3_asr_traces")
            os.makedirs(trace_dir, exist_ok=True)
            try:
                prof = start_trace(self.server.manager.device)
            except Exception as e:
                log.exception("profiler trace failed to start")
                failure = e
            else:
                try:
                    captured, records = capture(asked, TRACE_RECORD_BUDGET)
                finally:
                    try:
                        stop_trace(prof, trace_dir)
                    except Exception as e:
                        log.exception("profiler trace failed to stop")
                        failure = e
                if failure is None and captured < asked:
                    time.sleep(asked - captured)   # the budget ended it
        finally:
            lock.release()
        if failure is not None:
            self._error("WORKER_ERROR", f"trace failed: {failure}", 500)
            return
        reached = captured < asked
        log.info("Profiler trace captured | dir=%s seconds=%s recorded=%.2fs "
                 "records=%d budget_reached=%s", trace_dir, seconds, captured,
                 records, reached)
        self._json(200, {"trace_dir": trace_dir, "seconds": seconds,
                         "captured_seconds": captured,
                         "kernel_records": records,
                         "budget_reached": reached})

    # -- steps shared by the routes ------------------------------------------------
    def _ensure_loaded(self) -> None:
        """The engines loaded (a lazy manager's first request, or the first
        after an idle unload, waits for the load); a failed load answers
        500 MODEL_LOAD_FAILED."""
        try:
            self.server.manager.ensure_loaded()
        except Exception as e:
            log.exception("model load failed")
            self._error("MODEL_LOAD_FAILED", f"{type(e).__name__}: {e}", 500)
            raise Answered
    def _decode(self, file_bytes: Optional[bytes]):
        """(audio, sr) of the upload; an empty or undecodable one answers
        422 AUDIO_DECODE_FAILED, as the JAX server does."""
        if not file_bytes:
            self._error("AUDIO_DECODE_FAILED",
                        "Could not decode audio: empty file", 422, fileSize=0)
            raise Answered
        try:
            return decode_audio(file_bytes)
        except AudioDecodeError as e:
            self._error("AUDIO_DECODE_FAILED", f"Could not decode audio: {e}",
                        422, fileSize=len(file_bytes))
            raise Answered

    def _wait(self, future: concurrent.futures.Future, t0: float,
              route: str, timeout_code: str, timeout_message: str):
        """The result of a device job; past ``REQUEST_TIMEOUT`` a 504
        (the job skipped if still queued), on a failure a 500."""
        try:
            return future.result(timeout=self.server.manager.request_timeout)
        except concurrent.futures.TimeoutError:
            future.cancel()       # skips the device work if still queued
            log.warning("%s | timed out after %.2fs", route,
                        time.time() - t0)
            self._error(timeout_code, timeout_message, 504,
                        elapsed=round(time.time() - t0, 2))
            raise Answered
        except Exception as e:  # the server must keep answering
            log.exception("%s failed", route)
            self._error("TRANSCRIPTION_FAILED", f"{type(e).__name__}: {e}",
                        500)
            raise Answered

    def _transcribe_job(self, audio, sr: int, lang_code: Optional[str]
                        ) -> concurrent.futures.Future:
        """A whole upload's transcription as one standard-lane queue job."""
        mgr = self.server.manager
        return mgr.queue.submit(
            lambda: mgr.transcribe_sync(audio, sr, lang_code, False),
            priority=STANDARD)

    # -- routes ------------------------------------------------------------------------
    def _transcriptions(self, fields: dict, file_bytes: Optional[bytes]):
        route = "POST /v1/audio/transcriptions"
        # decode first, as the JAX server does: an empty or undecodable
        # upload is a 422 whatever else it asks for
        audio, sr = self._decode(file_bytes)
        language = fields.get("language", "auto")
        lang_code = None if language == "auto" else language
        stamps = parse_bool(fields.get("return_timestamps"))
        mgr = self.server.manager
        t0 = time.time()
        if stamps and os.getenv("ASR_TIMESTAMP_MODE",
                                "accurate") == "accurate":
            self.server.try_load_aligner()
        # Micro-batched: concurrent same-bucket uploads share one device
        # dispatch (a solo job when the request cannot batch).
        results = self._wait(
            mgr.batcher.transcribe(audio, sr, lang_code, stamps), t0, route,
            "TRANSCRIPTION_TIMEOUT", "Transcription timed out")
        if results:
            text, language_code = merge_results(results)
            text = detect_and_fix_repetitions(text)
        else:
            text, language_code = "", (lang_code or language)
        body = {"text": text, "language": language_code}
        log.debug("%s | token ids %s", route,
                  json.dumps([r.token_ids for r in results or []]))
        timestamps = merge_timestamps(results) if results else None
        if stamps and timestamps:
            body["timestamps"] = timestamps
        log.info("%s | %.2fs text_len=%d lang=%s", route, time.time() - t0,
                 len(text), language_code)
        self._json(200, body)

    def _stream(self, fields: dict, file_bytes: Optional[bytes]):
        audio, sr = self._decode(file_bytes)
        language = fields.get("language", "auto")
        lang_code = None if language == "auto" else language
        self.send_response(200)
        for k, v in (("Content-Type", "text/event-stream"),
                     ("Cache-Control", "no-cache"),
                     ("Connection", "keep-alive"),
                     ("X-Accel-Buffering", "no"),
                     ("Transfer-Encoding", "chunked"),
                     ("X-Request-ID", self.request_id)):
            self.send_header(k, v)
        self.end_headers()
        events = sse_events(self.server.manager, audio, sr, lang_code,
                            parse_bool(fields.get("return_timestamps")))
        try:
            for event in events:
                data = event.encode("utf-8")
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except ConnectionError:
            # the client went away: end the stream (and its chunks)
            log.info("SSE stream | client disconnected")
            self.close_connection = True
        finally:
            events.close()

    def _subtitles(self, fields: dict, file_bytes: Optional[bytes]):
        route = "POST /v1/audio/subtitles"
        mode = fields.get("mode", "accurate")
        t0 = time.time()
        if mode not in ("fast", "accurate"):
            self._error("INVALID_MODE",
                        f"mode must be 'fast' or 'accurate', got '{mode}'",
                        422)
            return
        audio, sr = self._decode(file_bytes)
        self._subtitle_core(fields, audio, sr, mode, route, t0, lambda e: (
            "SUBTITLE_TIMEOUT" if "timeout" in str(e).lower()
            else "WORKER_ERROR"))

    def _subtitle_core(self, fields: dict, audio, sr: int, mode: str,
                       route: str, t0: float, aligner_code) -> None:
        """The subtitle flow shared with the worker's route (JAX's
        ``subtitle_core``): the aligner's load in mode ``accurate`` (a
        failure answers 503 with ``aligner_code(e)``), the transcription,
        the repetition fix and the SRT."""
        language = fields.get("language", "auto")
        lang_code = None if language == "auto" else language
        try:
            max_line_chars = int(fields.get("max_line_chars", "42"))
        except ValueError:
            max_line_chars = 42
        if mode == "accurate":
            try:
                self.server.load_aligner()
            except Exception as e:
                log.error("%s | aligner load failed: %s", route, e)
                self._error(aligner_code(e),
                            f"ForcedAligner unavailable: {e}", 503)
                return
        results = self._wait(self._transcribe_job(audio, sr, lang_code), t0,
                             route, "SUBTITLE_TIMEOUT",
                             "Subtitle generation timed out")
        if not results:
            self._text("", "subtitles.srt")
            return
        for r in results:
            r.text = detect_and_fix_repetitions(r.text)
        # accurate mode aligns on the device thread
        srt = self._wait(self.server.manager.queue.submit(
            lambda: subtitle.generate_srt_from_results(
                results=results, audio=audio, sr=sr, mode=mode,
                max_line_chars=max_line_chars), priority=STANDARD),
            t0, route, "SUBTITLE_TIMEOUT", "Subtitle generation timed out")
        log.info("%s | completed in %.2fs mode=%s srt_len=%d", route,
                 time.time() - t0, mode, len(srt))
        self._text(srt, "subtitles.srt")

    def _translations(self, fields: dict, file_bytes: Optional[bytes]):
        t0 = time.time()
        audio, sr = self._decode(file_bytes)
        self._translate_core(fields, audio, sr, "fast",
                             "translated_subtitles.srt",
                             "POST /v1/audio/translations", t0)

    def _translate_core(self, fields: dict, audio, sr: int, srt_mode: str,
                        srt_filename: Optional[str], route: str,
                        t0: float) -> None:
        """The translation flow shared with the worker's route: the
        transcript translated as JSON, or its SRT in ``srt_mode`` (in mode
        ``accurate`` the aligner is loaded first, a failure answering 503
        WORKER_ERROR) translated and sent as ``srt_filename``."""
        from ..sidecars.translator import translate_srt, translate_text
        language = fields.get("language", "en")
        response_format = fields.get("response_format", "json")
        target = ("en" if language.lower() not in ("en", "zh")
                  else language.lower())
        srt = response_format.lower() == "srt"
        if srt and srt_mode == "accurate":
            try:
                self.server.load_aligner()
            except Exception as e:
                self._error("WORKER_ERROR", f"ForcedAligner unavailable: {e}",
                            503)
                return
        results = self._wait(self._transcribe_job(audio, sr, None), t0,
                             route, "TRANSCRIPTION_TIMEOUT",
                             "Transcription timed out")
        if srt:
            if not results:
                self._text("")
                return
            for r in results:
                r.text = detect_and_fix_repetitions(r.text)
            def make_srt():
                return subtitle.generate_srt_from_results(
                    results, audio, sr, mode=srt_mode, max_line_chars=42)
            if srt_mode == "accurate":    # aligns on the device thread
                original = self._wait(
                    self.server.manager.queue.submit(make_srt,
                                                     priority=STANDARD),
                    t0, route, "TRANSCRIPTION_TIMEOUT",
                    "Transcription timed out")
            else:                         # host work only
                original = make_srt()
            translated = self._translate(translate_srt, original, target,
                                         route, t0)
            log.info("%s | completed in %.2fs format=%s", route,
                     time.time() - t0, response_format)
            self._text(translated, srt_filename)
            return
        text = (detect_and_fix_repetitions(merge_results(results)[0])
                if results else "")
        translated = (self._translate(translate_text, text, target, route, t0)
                      if text.strip() else "")
        log.info("%s | completed in %.2fs format=%s", route,
                 time.time() - t0, response_format)
        self._json(200, {"text": translated, "language": target})

    def _translate(self, fn, content: str, target: str, route: str,
                   t0: float) -> str:
        """``fn(content, target)`` on this thread; a failure answers 502
        TRANSLATION_FAILED."""
        try:
            return fn(content, target)
        except Exception as e:
            log.error("%s | translation API failed in %.2fs error=%s", route,
                      time.time() - t0, e)
            self._error("TRANSLATION_FAILED", f"Translation API failed: {e}",
                        502)
            raise Answered


class AsrServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, manager: ModelManager, host: str, port: int,
                 handler=None):
        # the worker serves its own route table (serving/worker.py)
        super().__init__((host, port), handler or _Handler)
        self.manager = manager
        self.openapi = build_openapi(API_TITLE, API_VERSION, API_DESCRIPTION,
                                     API_TAGS, route_metadata())
        # one profiler capture at a time (/debug/trace)
        self.trace_lock = threading.Lock()
        # when a failed aligner load for word timestamps may be retried
        # (time.monotonic()); 0.0: no failure pending
        self.aligner_retry_at = 0.0

    def load_aligner(self) -> None:
        """Load ``FORCED_ALIGNER_ID`` on the engine's device, as a job of
        the device thread (a no-op once loaded); raises what the load
        raises."""
        mgr = self.manager
        device = mgr.serving_engine().device
        mgr.queue.submit(lambda: subtitle.load_aligner(device),
                         priority=STANDARD).result(
            timeout=mgr.request_timeout)

    def try_load_aligner(self) -> None:
        """For word timestamps: load the aligner unless it is loaded or a
        failed load is inside its ``ASR_ALIGNER_RETRY_S`` backoff. A
        failure is not an error (the engine estimates the words instead);
        it starts the backoff. Two requests may both load at once: the
        device thread runs the loads one after the other, and the second
        finds the aligner loaded."""
        if subtitle.aligner_loaded() or \
                time.monotonic() < self.aligner_retry_at:
            return
        try:
            self.load_aligner()
            self.aligner_retry_at = 0.0
        except Exception as e:
            self.aligner_retry_at = time.monotonic() + float(
                os.getenv("ASR_ALIGNER_RETRY_S", "300"))
            log.info("Aligner unavailable for timestamps (%s); "
                     "char-proportional estimates until the next retry "
                     "window", e)

    def count_request(self, route: str, method: str, status: int,
                      seconds: float) -> None:
        """``asr_requests_total`` and, for a matched route,
        ``asr_request_duration_seconds``; ``/metrics`` is not counted."""
        if route == "/metrics":
            return
        metrics = self.manager.metrics
        metrics.inc("asr_requests_total", path=route, method=method,
                    status=str(status))
        if route != "unmatched":
            metrics.observe("asr_request_duration_seconds", seconds,
                            path=route)

    def manager_health(self) -> dict:
        """``/health``'s fields of the manager, from one snapshot of its
        engines and pool (an unload may null them meanwhile), so a body
        never has a ``model_id`` without a model."""
        mgr = self.manager
        engine, fast, pool = mgr.engine, mgr.fast_engine, mgr.pool
        body = {"status": "ok", "model_loaded": engine is not None,
                "model_id": engine.model_id if engine is not None else None}
        device = torch.device(engine.device if engine is not None
                              else mgr.device)
        cuda = device.type == "cuda" and torch.cuda.is_available()
        body.update(device=(torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                    num_devices=torch.cuda.device_count() if cuda else 1)
        if engine is not None:
            engines = [e for e in (engine, fast) if e is not None]
            body.update(
                model_params_m=round(
                    param_count(engine.model.params) / 1e6, 1),
                dtype=str(engine.dtype).replace("torch.", ""),
                kv_cache_dtype=str(engine.cache_dtype).replace("torch.",
                                                               ""),
                **health_memory(engine.device),
                device_arrays_mb=round(device_bytes(mgr) / 1024 ** 2),
                executable_count=(
                    sum(e.executable_count for e in engines)
                    + (pool.executable_count if pool else 0)))
        if pool is not None:
            body["continuous_batching"] = {"slots": pool.max_slots,
                                           "window": pool.window,
                                           "depth": pool.depth}
        body["active_ws_sessions"] = mgr.ws_sessions
        return body

    def aligner_state(self) -> str:
        """``/health``'s ``aligner``."""
        if subtitle.aligner_loaded():
            return "loaded"
        if self.aligner_retry_at:
            return "unavailable_retrying"
        return "not_loaded"


def build_server(manager: ModelManager, host: str = "127.0.0.1",
                 port: int = 0) -> AsrServer:
    """A server for a started manager (port 0 picks a free port; read it
    from ``server.server_address``). Call ``serve_forever()`` to run it and
    ``shutdown()`` then ``server_close()`` to stop it; the caller stops the
    manager."""
    return AsrServer(manager, host, port)


def main():
    import argparse
    parser = argparse.ArgumentParser(description="Qwen3-ASR server (PyTorch)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int,
                        default=int(os.getenv("PORT", "8000")))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    setup_logging()
    config.validate_env()
    model_id = os.environ["MODEL_ID"]
    # lazy, as the JAX server's manager: the first request loads MODEL_ID
    # (the log names the device then), and an idle unload frees the card
    manager = ModelManager(device=args.device)
    manager.start()
    server = build_server(manager, args.host, args.port)
    log.info("serving %s on %s:%d (device %s, loaded on first use)",
             model_id, args.host, server.server_address[1], args.device)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        manager.stop()


if __name__ == "__main__":
    main()
