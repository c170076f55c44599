"""Standardized error payloads: ``{code, message, statusCode, context}``.

The same shape as the JAX package's ``utils/errors.py``, without its
request-id logging coupling.
"""
from __future__ import annotations

from typing import Any


def error_body(code: str, message: str, status_code: int, **context: Any) -> dict:
    """Build the standardized error payload dict."""
    body: dict[str, Any] = {
        "code": code,
        "message": message,
        "statusCode": status_code,
    }
    if context:
        body["context"] = dict(context)
    return body
