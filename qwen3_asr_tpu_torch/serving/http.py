"""The API's OpenAPI document and its docs page.

Counterpart of the OpenAPI half of ``qwen3_asr_tpu/serving/http.py``
(``build_openapi``, ``multipart_body``, ``_DOCS_HTML``, ``:106-193``):
``GET /openapi.json`` answers JAX's document and ``GET /docs`` its page.
The schemas are ``serving/schemas.py``'s plain dicts.
"""
from __future__ import annotations

import copy

from .schemas import COMPONENTS


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
