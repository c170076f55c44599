"""HTTP helpers shared by the server, the worker and the gateway: the
upload's parsing, and the API's OpenAPI document and its docs page.

Counterpart of ``qwen3_asr_tpu/serving/http.py``: ``parse_bool``, the
multipart upload (``parse_multipart``; JAX's ``read_upload``) and a
``Transfer-Encoding: chunked`` body (``read_chunked``, ``BodyTooLarge``),
and the OpenAPI half (``build_openapi``, ``multipart_body``,
``_DOCS_HTML``, ``:106-193``): ``GET /openapi.json`` answers JAX's document
and ``GET /docs`` its page. The schemas are ``serving/schemas.py``'s plain
dicts. ``JsonHandler`` is the request handler that the server, the worker
and the gateway share: JSON and text answers with ``X-Request-ID``, the
structured errors, and a route table per method run with the request's id
in the logging context. No ``torch`` and no ``numpy``: the gateway imports
this module.
"""
from __future__ import annotations

import copy
import json
import logging
import time
import uuid
from email import policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, Optional, Tuple

from ..utils.errors import error_body
from ..utils.logging import reset_request_id, set_request_id
from .schemas import COMPONENTS

MAX_UPLOAD_BYTES = 512 * 1024 ** 2


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


def read_body(headers, rfile, limit: int = MAX_UPLOAD_BYTES) -> bytes:
    """A request's body, by ``Content-Length`` or ``Transfer-Encoding:
    chunked``; raises BodyTooLarge past ``limit`` and ValueError on a
    malformed chunked body."""
    length = int(headers.get("Content-Length") or 0)
    if length > limit:
        raise BodyTooLarge
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        return read_chunked(rfile, limit)
    return rfile.read(length)


class Answered(Exception):
    """Raised by a step of a route that has already answered the request
    (with an error)."""


class JsonHandler(BaseHTTPRequestHandler):
    """HTTP/1.1 handler with a route table per method (``routes``). Every
    answer carries ``X-Request-ID``: the request's own, or a new id, which
    is the request's id in the logging context while its route runs."""
    protocol_version = "HTTP/1.1"
    request_id = ""

    def log_message(self, fmt, *args):     # access lines at debug level
        logging.getLogger(type(self).__module__).debug(
            "%s " + fmt, self.address_string(), *args)

    def send_response(self, code, message=None):
        self.status_code = code   # the request's status, for counting
        super().send_response(code, message)

    def routes(self, method: str) -> Dict[str, Callable[[], None]]:
        return {}

    def do_GET(self):
        self._serve("GET")

    def do_POST(self):
        self._serve("POST")

    def count(self, route: str, method: str, status: int,
              seconds: float) -> None:
        """Called once a request has been answered (``route`` is
        ``unmatched`` for a 404)."""

    def _serve(self, method: str) -> None:
        route = self.path.split("?", 1)[0]
        handler = self.routes(method).get(route)
        self.request_id = (self.headers.get("X-Request-ID")
                           or str(uuid.uuid4()))
        self.status_code = None
        token = set_request_id(self.request_id)
        t0 = time.time()
        try:
            if handler is None:
                self._error("NOT_FOUND", f"no route {self.path}", 404)
            else:
                handler()
        finally:
            reset_request_id(token)
            self.count(route if handler else "unmatched", method,
                       self.status_code or 500, time.time() - t0)

    def _send(self, status: int, content_type: str, data: bytes,
              filename: Optional[str] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        if filename:
            self.send_header("Content-Disposition",
                             f'attachment; filename="{filename}"')
        self.send_header("X-Request-ID", self.request_id)
        self.end_headers()
        self.wfile.write(data)

    def _json(self, status: int, body) -> None:
        self._send(status, "application/json; charset=utf-8",
                   json.dumps(body, ensure_ascii=False).encode("utf-8"))

    def _text(self, text: str, filename: Optional[str] = None) -> None:
        self._send(200, "text/plain; charset=utf-8", text.encode("utf-8"),
                   filename)

    def _error(self, code: str, message: str, status: int, **context) -> None:
        self._json(status, error_body(code, message, status, **context))

    def _read_upload(self) -> Tuple[dict, Optional[bytes], str]:
        """The multipart upload's (fields, file bytes, filename); 413 or 400
        (then Answered) for a body too large or malformed."""
        try:
            body = read_body(self.headers, self.rfile)
        except BodyTooLarge:
            self.close_connection = True
            self._error("PAYLOAD_TOO_LARGE", "upload exceeds 512 MiB", 413)
            raise Answered
        except ValueError:
            self.close_connection = True
            self._error("BAD_REQUEST", "malformed chunked body", 400)
            raise Answered
        return parse_multipart(self.headers.get("Content-Type", ""), body)


def build_openapi(title: str, version: str, description: str, tags: list,
                  routes: list) -> dict:
    """An OpenAPI 3.1 document from per-route metadata dicts."""
    paths: dict = {}
    for r in routes:
        entry = {
            "summary": r.get("summary", ""),
            "description": r.get("description", ""),
            "tags": r.get("tags", []),
            "operationId": r.get("operation_id",
                                 r["path"].strip("/").replace("/", "_")
                                 or "root"),
            "responses": r.get("responses", {"200": {"description": "OK"}}),
        }
        if r.get("request_body"):
            entry["requestBody"] = r["request_body"]
        paths.setdefault(r["path"], {})[r["method"].lower()] = entry
    return {
        "openapi": "3.1.0",
        "info": {"title": title, "version": version,
                 "description": description},
        "tags": tags,
        "paths": paths,
        "components": {"schemas": copy.deepcopy(COMPONENTS)},
    }


def multipart_body(fields: dict) -> dict:
    """OpenAPI requestBody for a multipart upload with the given fields
    (an ``x-required`` field is listed as required, and the key dropped)."""
    return {
        "required": True,
        "content": {"multipart/form-data": {"schema": {
            "type": "object",
            "properties": fields,
            "required": [k for k, v in fields.items()
                         if v.pop("x-required", False)],
        }}},
    }


DOCS_HTML = """<!DOCTYPE html>
<html>
<head>
  <title>{title} — Swagger UI</title>
  <meta charset="utf-8"/>
  <link rel="stylesheet"
        href="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
  <div id="swagger-ui"><h1>{title}</h1>
  <p>API docs. If the interactive UI fails to load (offline deployment),
  the raw schema is at <a href="/openapi.json">/openapi.json</a>.</p></div>
  <script src="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
  <script>
    window.onload = () => {{
      if (window.SwaggerUIBundle)
        SwaggerUIBundle({{url: "/openapi.json", dom_id: "#swagger-ui"}});
    }};
  </script>
</body>
</html>"""
