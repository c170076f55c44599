"""HTTP server for the port, on the standard library.

Counterpart of ``qwen3_asr_tpu/serving/server.py``'s batch and real-time
routes: ``GET /health``, ``POST /v1/audio/transcriptions`` (multipart
upload with ``file`` and an optional ``language``), answering ``{"text",
"language"}`` or the same error bodies (422 AUDIO_DECODE_FAILED, 504
TRANSCRIPTION_TIMEOUT), and ``WS /ws/transcribe`` (``serving/ws.py``: the
upgrade, the frame codec and the streaming session). Each request runs on
its own thread and goes through the manager's micro-batcher, which joins
concurrent same-bucket uploads into one batched engine run on the queue's
one device thread (that thread serializes all device work, so the
handlers need no lock); a WS connection holds its thread for its
lifetime. The other routes are not ported yet; ``return_timestamps=true``
on decodable audio answers 501 until the aligner is.
Every response carries ``X-Request-ID`` (the request's own, or a new
one), and an upload may come with ``Content-Length`` or
``Transfer-Encoding: chunked``.

Run: ``MODEL_ID=e2e/data/trained_ckpt python -m
qwen3_asr_tpu_torch.serving.server [--port 8000] [--device cuda]``.
``MODEL_ID`` is a checkpoint directory or ``preset:NAME`` (zero weights);
``QUANTIZE`` (``int8``, ``fp8``, ``int4`` with ``ASR_INT4_GROUP``),
``ASR_KV_CACHE_DTYPE`` (``bf16``, ``fp8``, ``int4``), ``ASR_INT8_ACT``,
``ASR_MAX_BATCH`` (8),
``ASR_BATCH_WINDOW_MS`` (20) and ``REQUEST_TIMEOUT`` (300 s) tune it;
the WS session's knobs are listed in ``serving/ws.py``.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import time
import uuid
from email import policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import torch

from ..audio.codec import AudioDecodeError, decode_audio
from ..runtime.lifecycle import ModelManager, load_engine
from ..text.repetition import detect_and_fix_repetitions
from ..utils.errors import error_body
from . import ws

log = logging.getLogger(__name__)

MAX_UPLOAD_BYTES = 512 * 1024 ** 2


def merge_results(results) -> Tuple[str, str]:
    """Join per-segment results into the one response the API promises."""
    text = " ".join(r.text for r in results if r.text)
    language = next((r.language for r in results if r.language), "")
    return text, language


def parse_bool(raw: Optional[str], default: bool = False) -> bool:
    if raw is None:
        return default
    return str(raw).lower() in ("true", "1", "yes", "on")


def parse_multipart(content_type: str, body: bytes
                    ) -> Tuple[dict, Optional[bytes], str]:
    """A multipart/form-data body → (fields, file_bytes, filename)."""
    fields: dict = {}
    file_bytes: Optional[bytes] = None
    filename = ""
    if not content_type.startswith("multipart/"):
        return fields, file_bytes, filename
    msg = BytesParser(policy=policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n"
        + body)
    if not msg.is_multipart():
        return fields, file_bytes, filename
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        payload = part.get_payload(decode=True) or b""
        if name == "file":
            file_bytes = payload
            filename = part.get_filename() or ""
        elif name:
            fields[name] = payload.decode("utf-8", errors="replace")
    return fields, file_bytes, filename


class BodyTooLarge(Exception):
    pass


def read_chunked(rfile, limit: int) -> bytes:
    """A ``Transfer-Encoding: chunked`` body, read whole (trailers
    dropped). Raises BodyTooLarge past ``limit`` bytes and ValueError on a
    malformed chunk."""
    parts, size = [], 0
    while True:
        line = rfile.readline(65537)
        n = int(line.split(b";", 1)[0].strip(), 16)   # ValueError if bad
        if n == 0:
            break
        size += n
        if size > limit:
            raise BodyTooLarge
        parts.append(rfile.read(n))
        if rfile.readline(3) not in (b"\r\n", b"\n"):
            raise ValueError("chunk not followed by CRLF")
    while rfile.readline(65537) not in (b"\r\n", b"\n", b""):
        pass                                  # trailer fields
    return b"".join(parts)


def health_memory(device: torch.device) -> dict:
    """The card's memory in MB as JAX's ``/health`` reports it
    (``hbm_used_mb`` in use by the allocator, ``hbm_limit_mb`` the card's
    total), or nulls for an engine on the CPU."""
    if device.type != "cuda":
        return {"hbm_used_mb": None, "hbm_limit_mb": None}
    used = torch.cuda.memory_stats(device).get(
        "allocated_bytes.all.current", 0)
    _, total = torch.cuda.mem_get_info(device)
    return {"hbm_used_mb": round(used / 1024 ** 2),
            "hbm_limit_mb": round(total / 1024 ** 2)}


class _Handler(BaseHTTPRequestHandler):
    server: "AsrServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, status: int, body: dict) -> None:
        data = json.dumps(body, ensure_ascii=False).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Request-ID", self.headers.get("X-Request-ID")
                         or str(uuid.uuid4()))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, code: str, message: str, status: int, **context) -> None:
        self._json(status, error_body(code, message, status, **context))

    def do_GET(self):
        route = self.path.split("?", 1)[0]
        if route == "/ws/transcribe":
            ws.websocket_transcribe(self)
            return
        if route != "/health":
            self._error("NOT_FOUND", f"no route {self.path}", 404)
            return
        engine = self.server.manager.engine
        self._json(200, {"status": "ok",
                         "model_loaded": True,
                         "model_id": engine.model_id,
                         "device": str(engine.device),
                         "dtype": str(engine.dtype).replace("torch.", ""),
                         "kv_cache_dtype": str(engine.cache_dtype).replace(
                             "torch.", ""),
                         **health_memory(engine.device),
                         "device_arrays_mb": round(engine.held_bytes()
                                                   / 1024 ** 2),
                         "executable_count": engine.executable_count,
                         "active_ws_sessions":
                             self.server.manager.ws_sessions})

    def do_POST(self):
        if self.path.split("?", 1)[0] != "/v1/audio/transcriptions":
            self._error("NOT_FOUND", f"no route {self.path}", 404)
            return
        chunked = "chunked" in self.headers.get("Transfer-Encoding",
                                                "").lower()
        length = int(self.headers.get("Content-Length") or 0)
        try:
            if length > MAX_UPLOAD_BYTES:
                raise BodyTooLarge
            body = (read_chunked(self.rfile, MAX_UPLOAD_BYTES) if chunked
                    else self.rfile.read(length))
        except BodyTooLarge:
            self.close_connection = True
            self._error("PAYLOAD_TOO_LARGE", "upload exceeds 512 MiB", 413)
            return
        except ValueError:
            self.close_connection = True
            self._error("BAD_REQUEST", "malformed chunked body", 400)
            return
        fields, file_bytes, _ = parse_multipart(
            self.headers.get("Content-Type", ""), body)
        # decode first, as the JAX server does: an empty or undecodable
        # upload is a 422 whatever else it asks for
        if not file_bytes:
            self._error("AUDIO_DECODE_FAILED",
                        "Could not decode audio: empty file", 422, fileSize=0)
            return
        try:
            audio, sr = decode_audio(file_bytes)
        except AudioDecodeError as e:
            self._error("AUDIO_DECODE_FAILED", f"Could not decode audio: {e}",
                        422, fileSize=len(file_bytes))
            return
        if parse_bool(fields.get("return_timestamps")):
            self._error("NOT_IMPLEMENTED",
                        "return_timestamps is not supported yet", 501)
            return
        language = fields.get("language", "auto")
        lang_code = None if language == "auto" else language
        mgr = self.server.manager
        t0 = time.time()
        try:
            # Micro-batched: concurrent same-bucket uploads share one
            # device dispatch (a solo job when the request cannot batch).
            future = mgr.batcher.transcribe(audio, sr, lang_code)
            results = future.result(timeout=mgr.request_timeout)
        except concurrent.futures.TimeoutError:
            future.cancel()       # skips the device work if still queued
            log.warning("POST /v1/audio/transcriptions | timed out after "
                        "%.2fs", time.time() - t0)
            self._error("TRANSCRIPTION_TIMEOUT", "Transcription timed out",
                        504, elapsed=round(time.time() - t0, 2))
            return
        except Exception as e:  # the server must keep answering
            log.exception("transcription failed")
            self._error("TRANSCRIPTION_FAILED", f"{type(e).__name__}: {e}",
                        500)
            return
        if results:
            text, language_code = merge_results(results)
            text = detect_and_fix_repetitions(text)
        else:
            text, language_code = "", (lang_code or language)
        log.info("POST /v1/audio/transcriptions | %.2fs text_len=%d lang=%s",
                 time.time() - t0, len(text), language_code)
        self._json(200, {"text": text, "language": language_code})


class AsrServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, manager: ModelManager, host: str, port: int):
        super().__init__((host, port), _Handler)
        self.manager = manager


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
    logging.basicConfig(level=logging.INFO)
    model_id = os.environ.get("MODEL_ID")
    if not model_id:
        parser.error("set MODEL_ID to a checkpoint directory or preset:NAME")
    manager = ModelManager(load_engine(model_id, device=args.device))
    manager.start()
    server = build_server(manager, args.host, args.port)
    log.info("serving %s on %s:%d (%s, KV cache %s)", model_id, args.host,
             server.server_address[1], manager.engine.device,
             manager.engine.cache_dtype)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        manager.stop()


if __name__ == "__main__":
    main()
