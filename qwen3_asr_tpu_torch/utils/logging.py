"""JSON log lines with request ids, on the standard library's logging.

Counterpart of ``qwen3_asr_tpu/utils/logging.py``: one JSON line an event
on stdout, ``{timestamp, level, message, service: "qwen3-asr",
requestId?, logger, err?}``, the level names of the JAX package
(``critical`` -> ``fatal``, ``warning`` -> ``warn``) and ``LOG_LEVEL`` with
its levels and aliases (``trace``, ``warn``, ``fatal``). The port's modules
log through ``logging.getLogger(__name__)``; ``setup_logging`` sends every
logger to the JSON sink, as the JAX server's ``intercept_stdlib_logging``
does, so a line equals the one JAX's ``InterceptHandler`` writes for the
same record but for its timestamp.

The request id lives in a ``contextvars`` variable that the server sets for
each request. A request runs on its own thread, and its device work runs
on the queue's thread in a copy of the request's context
(``runtime/queue.py``), so the device thread's lines carry the id too.
"""
from __future__ import annotations

import contextvars
import datetime
import json
import logging
import os
import sys
from typing import Optional

_request_id_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("request_id", default=None)

SERVICE_NAME = "qwen3-asr"

# output level names (critical -> fatal, warning -> warn)
_LEVEL_MAP = {"critical": "fatal", "warning": "warn"}
_STD_TO_NAME = {logging.DEBUG: "debug", logging.INFO: "info",
                logging.WARNING: "warning", logging.ERROR: "error",
                logging.CRITICAL: "critical"}
# LOG_LEVEL's names on the standard library's scale
_ENV_TO_STD = {"TRACE": "DEBUG", "WARN": "WARNING", "FATAL": "CRITICAL"}


def set_request_id(req_id: str) -> contextvars.Token:
    """Set the request id of the current context; returns a reset token."""
    return _request_id_var.set(req_id)


def reset_request_id(token: contextvars.Token) -> None:
    _request_id_var.reset(token)


def get_request_id() -> Optional[str]:
    return _request_id_var.get()


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).astimezone() \
        .isoformat()


class JsonFormatter(logging.Formatter):
    """A record as the JAX package's JSON line."""

    def format(self, record: logging.LogRecord) -> str:
        level = _STD_TO_NAME.get(record.levelno)
        if level is None:
            level = "info" if record.levelno < logging.WARNING else "error"
        try:
            message = record.getMessage()
        except Exception:
            message = str(record.msg)
        entry = {"timestamp": _now_iso(),
                 "level": _LEVEL_MAP.get(level, level),
                 "message": message, "service": SERVICE_NAME}
        req_id = _request_id_var.get()
        if req_id:
            entry["requestId"] = req_id
        entry["logger"] = record.name
        if record.exc_info and record.exc_info[1] is not None:
            entry["err"] = str(record.exc_info[1])
        try:
            return json.dumps(entry, default=str)
        except (TypeError, ValueError):
            return json.dumps({k: str(v) for k, v in entry.items()})


def setup_logging(stream=None) -> None:
    """Send every logger's records to one JSON handler on ``stream``
    (stdout), at ``LOG_LEVEL`` (``info``; an unknown name logs at info)."""
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stdout)
    handler.setFormatter(JsonFormatter())
    logging.root.handlers = [handler]
    level = os.getenv("LOG_LEVEL", "info").upper()
    try:
        logging.root.setLevel(_ENV_TO_STD.get(level, level))
    except ValueError:
        logging.root.setLevel(logging.INFO)
    for name in list(logging.root.manager.loggerDict.keys()):
        logger = logging.getLogger(name)
        logger.handlers = []
        logger.propagate = True
