"""The API's response schemas and tags, for ``GET /openapi.json``.

Counterpart of ``qwen3_asr_tpu/serving/schemas.py``. The card's machine has
no pydantic, so each model is the plain JSON-schema dict that JAX's
pydantic model emits (``model_json_schema``), built by ``_model`` from the
same fields, descriptions and examples; ``API_TAGS`` is JAX's, and so is
``API_DESCRIPTION`` but for its "Audio formats" paragraph, which says what
the port decodes.
"""
from __future__ import annotations

from typing import Optional

_JSON_TYPES = {str: "string", int: "integer", float: "number",
               bool: "boolean", dict: "object"}


def _type(py: type) -> dict:
    if py is dict:
        return {"additionalProperties": True, "type": "object"}
    return {"type": _JSON_TYPES[py]}


def _model(name: str, doc: str, fields, example: Optional[dict] = None
           ) -> dict:
    """A pydantic model's JSON schema from ``fields``: (name, type,
    description, required, examples or None) each; an optional field
    defaults to None."""
    props, required = {}, []
    for fname, py, desc, req, examples in fields:
        title = fname.replace("_", " ").title()
        if req:
            prop = {**_type(py), "description": desc, "title": title}
            required.append(fname)
        else:
            prop = {"anyOf": [_type(py), {"type": "null"}], "default": None,
                    "description": desc, "title": title}
        if examples is not None:
            prop["examples"] = examples
        props[fname] = prop
    schema = {"description": doc, "properties": props, "required": required,
              "title": name, "type": "object"}
    if example is not None:
        schema["examples"] = [example]
    return schema


ErrorResponse = _model(
    "ErrorResponse",
    "Standardized error payload ({code, message, statusCode, context}).",
    [("code", str, "Machine-readable error identifier, e.g. "
      "AUDIO_DECODE_FAILED", True, None),
     ("message", str, "Human-readable error description", True, None),
     ("context", dict, "Debug data: requestId, input params", False, None),
     ("statusCode", int, "HTTP status code", True, None)],
    {"code": "AUDIO_DECODE_FAILED",
     "message": "Could not decode audio: unknown format",
     "context": {"fileSize": 1024}, "statusCode": 422})

HealthResponse = _model(
    "HealthResponse", "Service liveness + model/accelerator state.",
    [("status", str, "Service status", True, ["ok"]),
     ("mode", str, "'gateway' (proxied), 'worker', or absent for "
      "standalone", False, None),
     ("model_loaded", bool, "Whether the ASR model is resident on the "
      "accelerator", True, None),
     ("model_id", str, "Loaded model identifier", False, None),
     ("device", str, "Accelerator kind", False, ["TPU v5 lite"]),
     ("num_devices", int, "Visible accelerator chips", False, None),
     ("hbm_used_mb", int, "Accelerator memory in use (MB)", False, None),
     ("hbm_limit_mb", int, "Accelerator memory capacity (MB)", False, None),
     ("device_arrays_mb", int, "Total bytes of live framework arrays (MB) "
      "— leak accounting on backends without memory_stats", False, None),
     ("aligner", str, "ForcedAligner state: loaded | not_loaded | "
      "unavailable_retrying (failed loads retry with backoff)", False,
      None),
     ("worker_alive", bool, "Worker process responsive (gateway mode)",
      False, None)])

TranscriptionResponse = _model(
    "TranscriptionResponse", "Result of POST /v1/audio/transcriptions.",
    [("text", str, "Transcribed text", True, None),
     ("language", str, "Detected or requested language code", True, None)],
    {"text": "Hello, how are you today?", "language": "en"})

TranslationResponse = _model(
    "TranslationResponse",
    "Result of POST /v1/audio/translations (json format).",
    [("text", str, "Translated text", True, None),
     ("language", str, "Target language code used", True, None)],
    {"text": "Hello, how are you?", "language": "en"})

SSEChunkEvent = _model(
    "SSEChunkEvent", "One `data:` event of the SSE streaming transcription.",
    [("text", str, "Transcribed text for this chunk", True, None),
     ("chunk_index", int, "Zero-based chunk index", True, None),
     ("is_final", bool, "True on the last chunk", True, None),
     ("language", str, "Detected language code", True, None)],
    {"text": "This is the first part", "chunk_index": 0, "is_final": False,
     "language": "en"})

WebSocketHandshake = _model(
    "WebSocketHandshake",
    "First message the server sends after a WS connection is accepted.",
    [("status", str, "Connection status", True, ["connected"]),
     ("sample_rate", int, "Expected PCM input rate (Hz)", True, None),
     ("buffer_size", int, "Bytes buffered before each partial "
      "transcription", True, None),
     ("window_max_s", float, "Sliding-window cap (seconds)", True, None),
     ("use_server_vad", bool, "Server-side VAD active for this connection",
      True, None)],
    {"status": "connected", "sample_rate": 16000, "buffer_size": 14400,
     "window_max_s": 6.0, "use_server_vad": True})

WebSocketPartial = _model(
    "WebSocketPartial",
    "Streaming partial: cumulative transcript of the current window.",
    [("partial", str, "Cumulative transcript — replace, don't append", True,
      None),
     ("language", str, "Detected language code", True, None)],
    {"partial": "Hello how are you", "language": "en"})

# /openapi.json's components, in JAX's order
COMPONENTS = {s["title"]: s for s in (
    ErrorResponse, HealthResponse, TranscriptionResponse,
    TranslationResponse, SSEChunkEvent, WebSocketHandshake,
    WebSocketPartial)}

API_TAGS = [
    {"name": "Transcription",
     "description": "Speech-to-text endpoints. Upload audio (WAV, FLAC, MP3, OGG, AIFF, CAF, AU) and get text back."},
    {"name": "Streaming",
     "description": "Real-time WebSocket and SSE transcription for low-latency use."},
    {"name": "Subtitles",
     "description": "SRT generation — 'fast' heuristic timing or 'accurate' forced alignment."},
    {"name": "Translation",
     "description": "Transcribe then translate to English or Chinese via an external LLM."},
    {"name": "System",
     "description": "Health, model state, diagnostics, profiler traces."},
]

API_DESCRIPTION = """\
TPU-accelerated speech-to-text API powered by [Qwen3-ASR](https://huggingface.co/Qwen/Qwen3-ASR-1.7B),
rebuilt on JAX/XLA/Pallas.

## Features
- **OpenAI-compatible** `/v1/audio/transcriptions` endpoint
- **Multilingual**: English, Chinese, Japanese, Cantonese, Hindi, Thai, and more
- **Real-time WebSocket** streaming with sliding window and VAD
- **SSE streaming** for chunked transcription of long files
- **SRT subtitle** generation (fast and accurate modes)
- **Translation** via external LLM API

## Audio formats
WAV (PCM/float), AIFF/AIFC, AU, RF64, W64, CAF, FLAC, MPEG audio (Layer
III of MPEG-1, 2 and 2.5; Layer I and II of MPEG-1 and 2), Ogg Vorbis and
Ogg Opus (SILK, CELT and hybrid), each decoded natively at the stream's
own sample rate (Opus at 48 kHz). M4A/AAC is not supported.

## WebSocket protocol
Connect to `/ws/transcribe`, stream raw PCM (s16le, mono, 16 kHz), and use
JSON actions `flush` / `reset` / `config`. See docs/WEBSOCKET_USAGE.md.
"""
