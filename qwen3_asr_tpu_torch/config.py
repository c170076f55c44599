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
