"""The API's title, version and per-route metadata for ``/openapi.json``.

Counterpart of ``qwen3_asr_tpu/serving/meta.py``: the same routes, request
forms and responses, so the port's document equals JAX's.
"""
from .http import multipart_body

API_TITLE = "Qwen3-ASR"
API_VERSION = "0.14.0"


def route_metadata() -> list:
    audio_field = {"type": "string", "format": "binary",
                   "description": "Audio file", "x-required": True}
    return [
        {"path": "/health", "method": "GET", "tags": ["System"],
         "summary": "Health check",
         "description": "Returns service status, model loading state, and accelerator info.",
         "responses": {"200": {
             "description": "Service health",
             "content": {"application/json": {"schema": {
                 "$ref": "#/components/schemas/HealthResponse"}}}}}},
        {"path": "/v1/audio/transcriptions", "method": "POST",
         "tags": ["Transcription"], "summary": "Transcribe audio file",
         "description": "Upload an audio file and get the transcribed text back. Language is auto-detected by default.",
         "request_body": multipart_body({
             "file": dict(audio_field),
             "language": {"type": "string", "default": "auto"},
             "return_timestamps": {"type": "boolean", "default": False}}),
         "responses": {"200": {
             "description": "Transcription",
             "content": {"application/json": {"schema": {
                 "$ref": "#/components/schemas/TranscriptionResponse"}}}},
             "422": {"description": "Audio decode or validation error",
                     "content": {"application/json": {"schema": {
                         "$ref": "#/components/schemas/ErrorResponse"}}}},
             "504": {"description": "Inference timed out",
                     "content": {"application/json": {"schema": {
                         "$ref": "#/components/schemas/ErrorResponse"}}}}}},
        {"path": "/v1/audio/translations", "method": "POST",
         "tags": ["Translation"], "summary": "Translate audio file",
         "description": "Transcribe audio and translate the text into English or Chinese using an external LLM. Returns JSON by default, or SRT subtitles with `response_format=srt`.",
         "request_body": multipart_body({
             "file": dict(audio_field),
             "language": {"type": "string", "default": "en"},
             "response_format": {"type": "string", "default": "json"}}),
         "responses": {"200": {
             "description": "Translation",
             "content": {"application/json": {"schema": {
                 "$ref": "#/components/schemas/TranslationResponse"}}}}}},
        {"path": "/v1/audio/subtitles", "method": "POST",
         "tags": ["Subtitles"], "summary": "Generate SRT subtitles",
         "description": "Generate SRT subtitle file from audio. **fast** mode uses heuristic timestamps (no extra model). **accurate** mode uses ForcedAligner for word-level timing.",
         "request_body": multipart_body({
             "file": dict(audio_field),
             "language": {"type": "string", "default": "auto"},
             "mode": {"type": "string", "default": "accurate"},
             "max_line_chars": {"type": "integer", "default": 42}}),
         "responses": {"200": {"description": "SRT subtitle file",
                               "content": {"text/plain": {}}}}},
        {"path": "/v1/audio/transcriptions/stream", "method": "POST",
         "tags": ["Streaming"], "summary": "Stream transcription (SSE)",
         "description": "Upload a long audio file and receive transcription results as Server-Sent Events. Audio is split into overlapping chunks transcribed progressively.",
         "request_body": multipart_body({
             "file": dict(audio_field),
             "language": {"type": "string", "default": "auto"},
             "return_timestamps": {"type": "boolean", "default": False}}),
         "responses": {"200": {"description": "SSE stream of transcription chunks",
                               "content": {"text/event-stream": {}}}}},
    ]

