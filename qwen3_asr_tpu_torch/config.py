"""The tuning constants of the sidecar routes, and the WebSocket
streaming policy: which mode a connection runs in.

Counterpart of parts of ``qwen3_asr_tpu/config.py``: the ``_safe_int`` /
``_safe_float`` readers, the SSE, translation and subtitle constants
(``:43-51, 56-63``: same names and defaults), and ``WsMode``,
``resolve_ws_mode`` and ``ws_warmup_profile`` (``:199-265``), with the JAX
package's environment variables and meanings:

- ``solo``: one session's ticks as B=1 resume decoding;
- ``tick``: concurrent sessions' ticks coalesced into one batched resume
  run (``runtime/batcher.py`` ``TickBatcher``);
- ``prefix``: one session's ticks with cached encoder blocks and decoder
  KV across ticks (``runtime/stream.py``);
- ``grouped``: the same, with concurrent sessions' ticks in one pooled
  dispatch (``runtime/stream_group.py``, ``GroupTickBatcher``). The
  ``auto`` policy at a cap of ``ASR_WS_GROUP_MIN_CAP_S`` or more names
  both ``prefix`` and ``grouped`` in its warmup profile.

``check_ws_modes`` refuses, at start, a mode name it does not know,
rather than serving another mode in its place.

``validate_env`` (``:75-288``) checks the environment when the server
starts with every one of JAX's rules (``MODEL_ID``, ``REQUEST_TIMEOUT``,
``IDLE_TIMEOUT``, ``LOG_LEVEL``, ``QUANTIZE``, the gateway's
``WORKER_PORT`` and the fleet's ``WORKER_PORTS``/``WORKER_HOSTS``,
``WS_WINDOW_MAX_S``, ``ASR_MAX_SESSIONS``, ``ASR_WS_STREAM_MODE``), logs
every problem and exits 1; then it says what the port does with the
CUDA-era flags.

Priority: ``ASR_WS_STREAM_MODE`` names a mode (``auto`` = the policy); else
the legacy flags ``ASR_WS_PREFIX_CACHE`` / ``ASR_WS_TICK_BATCH``, if either
is set; else the policy: a cap of ``ASR_WS_GROUP_MIN_CAP_S`` (10 s) or more
picks the prefix-cached modes, and below it ``tick`` at
``ASR_WS_TICK_MIN_SESSIONS`` (3) or more concurrent sessions, ``solo``
otherwise.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import List, NamedTuple

log = logging.getLogger(__name__)

PORTED_WS_MODES = ("solo", "tick", "prefix", "grouped")


def _safe_parse(name: str, default: str, cast):
    raw = os.getenv(name, default)
    try:
        return cast(raw)
    except ValueError:
        kind = "a float" if cast is float else "an integer"
        log.error("Config error: %s must be %s, got '%s' — using default %s",
                  name, kind, raw, default)
        return cast(default)


def _safe_float(name: str, default: str) -> float:
    return _safe_parse(name, default, float)


def _safe_int(name: str, default: str) -> int:
    return _safe_parse(name, default, int)


def _safe_bool(name: str, default: str = "false") -> bool:
    return os.getenv(name, default).lower() in ("true", "1", "yes")


TRANSLATE_TEMPERATURE = _safe_float("TRANSLATE_TEMPERATURE", "0.3")
TRANSLATE_SRT_TEMPERATURE = _safe_float("TRANSLATE_SRT_TEMPERATURE", "0.1")
SSE_CHUNK_SECONDS = _safe_int("SSE_CHUNK_SECONDS", "5")
SSE_OVERLAP_SECONDS = _safe_int("SSE_OVERLAP_SECONDS", "1")
SUBTITLE_MAX_DURATION = _safe_float("SUBTITLE_MAX_DURATION", "7.0")
SUBTITLE_PAUSE_THRESHOLD = _safe_float("SUBTITLE_PAUSE_THRESHOLD", "0.5")
SUBTITLE_MIN_DURATION = _safe_float("SUBTITLE_MIN_DURATION", "0.833")
SUBTITLE_MIN_GAP = _safe_float("SUBTITLE_MIN_GAP", "0.083")


class WsMode(NamedTuple):
    prefix: bool     # bind a stream session (cached encoder blocks + KV)
    tick: bool       # coalesce concurrent sessions' ticks into one dispatch
    name: str        # solo | tick | prefix | grouped

    @classmethod
    def named(cls, name: str) -> "WsMode":
        return cls(prefix=name in ("prefix", "grouped"),
                   tick=name in ("tick", "grouped"), name=name)


def resolve_ws_mode(cap_s: float, sessions: int) -> WsMode:
    """The WS mode of a new connection at window cap ``cap_s`` with
    ``sessions`` concurrent sessions (the new one included). Fixed for the
    connection's lifetime."""
    explicit = os.getenv("ASR_WS_STREAM_MODE", "").lower()
    if explicit and explicit != "auto":
        return WsMode.named(explicit)
    legacy_prefix = os.getenv("ASR_WS_PREFIX_CACHE")
    legacy_tick = os.getenv("ASR_WS_TICK_BATCH")
    if not explicit and (legacy_prefix is not None
                         or legacy_tick is not None):
        prefix = (legacy_prefix or "").lower() == "true"
        tick = (legacy_tick or "").lower() == "true"
        return WsMode(prefix, tick,
                      {(False, False): "solo", (False, True): "tick",
                       (True, False): "prefix", (True, True): "grouped"}
                      [(prefix, tick)])
    min_cap = _safe_float("ASR_WS_GROUP_MIN_CAP_S", "10.0")
    min_sessions = _safe_int("ASR_WS_TICK_MIN_SESSIONS", "3")
    batch = sessions >= min_sessions
    if cap_s >= min_cap:
        return WsMode.named("grouped" if batch else "prefix")
    return WsMode.named("tick" if batch else "solo")


def ws_warmup_profile() -> List[WsMode]:
    """The modes a warmup should build keys for: under the policy, both
    that ``resolve_ws_mode`` can pick at ``WS_WINDOW_MAX_S`` (a lone
    session and a busy server); an explicit or legacy configuration, its
    one mode."""
    cap = _safe_float("WS_WINDOW_MAX_S", "6.0")
    lone = resolve_ws_mode(cap, 1)
    busy = resolve_ws_mode(cap, 10 ** 9)
    return [lone] if lone == busy else [lone, busy]


def check_ws_modes() -> List[WsMode]:
    """``ws_warmup_profile()``, or ValueError if it names a mode the port
    does not serve (an unknown name in ``ASR_WS_STREAM_MODE``)."""
    modes = ws_warmup_profile()
    refused = [m.name for m in modes if m.name not in PORTED_WS_MODES]
    if refused:
        raise ValueError(
            f"WS stream mode(s) {refused} are not ported: no such mode; "
            f"ASR_WS_STREAM_MODE takes auto or one of "
            f"{list(PORTED_WS_MODES)}")
    return modes


# -- fail-fast validation at start ------------------------------------------------
# Each rule returns a problem or None; every problem is logged before the
# exit, so an operator sees them all at once.

_LOG_LEVELS = {"TRACE", "DEBUG", "INFO", "WARNING", "WARN", "ERROR",
               "CRITICAL", "FATAL"}
_LOG_ALIASES = {"WARN": "WARNING", "FATAL": "CRITICAL"}
_QUANTIZE_MODES = {"", "int8", "fp8", "int4"}
_WS_STREAM_MODES = {"", "auto", "solo", "tick", "prefix", "grouped"}


def _check_model_id():
    if not os.getenv("MODEL_ID", ""):
        return "MODEL_ID is required but empty or unset"


def _check_request_timeout():
    try:
        value = int(os.getenv("REQUEST_TIMEOUT", "300"))
    except ValueError as e:
        return f"REQUEST_TIMEOUT must be an integer: {e}"
    if value <= 0:
        return f"REQUEST_TIMEOUT must be positive, got {value}"


def _check_idle_timeout():
    try:
        value = int(os.getenv("IDLE_TIMEOUT", "120"))
    except ValueError as e:
        return f"IDLE_TIMEOUT must be an integer: {e}"
    if value < 0:
        return f"IDLE_TIMEOUT must be non-negative, got {value}"


def _check_log_level():
    level = os.getenv("LOG_LEVEL", "info").upper()
    level = _LOG_ALIASES.get(level, level)
    if level not in _LOG_LEVELS:
        return f"LOG_LEVEL must be one of {_LOG_LEVELS}, got '{level}'"


def _check_quantize():
    mode = os.getenv("QUANTIZE", "")
    if mode not in _QUANTIZE_MODES:
        return f"QUANTIZE must be one of {_QUANTIZE_MODES}, got '{mode}'"


def _check_worker_port():
    if os.getenv("GATEWAY_MODE", "false").lower() != "true":
        return None
    try:
        port = int(os.getenv("WORKER_PORT", "8001"))
    except ValueError as e:
        return f"WORKER_PORT must be an integer: {e}"
    if not 1 <= port <= 65535:
        return f"WORKER_PORT must be 1-65535, got {port}"


def _check_worker_fleet():
    """``WORKER_PORTS`` / ``WORKER_HOSTS`` (the gateway's fleet), checked
    whenever they are set, not only under ``GATEWAY_MODE``."""
    for p in os.getenv("WORKER_PORTS", "").split(","):
        p = p.strip()
        if not p:
            continue
        if not p.isdigit() or not 1 <= int(p) <= 65535:
            return f"WORKER_PORTS entries must be ports 1-65535, got {p!r}"
    for spec in os.getenv("WORKER_HOSTS", "").split(","):
        spec = spec.strip()
        if not spec:
            continue
        host, _, port = spec.partition(":")
        if not host:
            return f"WORKER_HOSTS entries must be host[:port], got {spec!r}"
        if port and (not port.isdigit() or not 1 <= int(port) <= 65535):
            return (f"WORKER_HOSTS port must be 1-65535, got {port!r} "
                    f"in {spec!r}")


def _check_ws_window():
    try:
        value = float(os.getenv("WS_WINDOW_MAX_S", "6.0"))
    except ValueError as e:
        return f"WS_WINDOW_MAX_S must be a float: {e}"
    if value <= 0:
        return f"WS_WINDOW_MAX_S must be positive, got {value}"


def _check_max_sessions():
    raw = os.getenv("ASR_MAX_SESSIONS", "0") or "0"
    try:
        value = int(raw)
    except ValueError as e:
        return f"ASR_MAX_SESSIONS must be an integer: {e}"
    if value < 0:
        return f"ASR_MAX_SESSIONS must be >= 0 (0 = unlimited), got {value}"


def _check_ws_stream_mode():
    mode = os.getenv("ASR_WS_STREAM_MODE", "").lower()
    if mode not in _WS_STREAM_MODES:
        return (f"ASR_WS_STREAM_MODE must be one of "
                f"{sorted(_WS_STREAM_MODES - {''})}, got {mode!r}")


_VALIDATORS = (_check_model_id, _check_request_timeout, _check_idle_timeout,
               _check_log_level, _check_quantize, _check_worker_port,
               _check_worker_fleet, _check_ws_window, _check_max_sessions,
               _check_ws_stream_mode)


def validate_env() -> None:
    """Check the environment at start; log every problem, then exit 1."""
    errors = [err for err in (rule() for rule in _VALIDATORS) if err]
    if errors:
        for err in errors:
            log.error("Config validation failed: %s", err)
        sys.exit(1)
    # the CUDA-era flags, and what the port does with them
    if _safe_bool("USE_CUDA_GRAPHS"):
        log.info("USE_CUDA_GRAPHS=true: the warmup captures the CUDA graphs "
                 "of every bucket of the ladder (requests on the card "
                 "always run as graph replays)")
    for flag in ("ONNX_ENCODER_PATH", "TRT_ENCODER_PATH"):
        if os.getenv(flag, ""):
            log.info("%s set: ignored — the encoder runs as the port's own "
                     "CUDA graphs and kernels", flag)
    if _safe_bool("USE_GRANIAN"):
        log.info("USE_GRANIAN=true: n/a — this build serves HTTP/WS/SSE on "
                 "the standard library's threading HTTP server in-process "
                 "(no ASGI server layer)")
    log.info("Config validation passed")
