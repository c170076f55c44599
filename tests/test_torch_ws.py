"""``WS /ws/transcribe`` on the port's server (``serving/ws.py``), on the
CPU with the trained checkpoint, driven through the port's stdlib client
(``ws.connect``).

The WS cases of ``tests/test_serving.py`` (handshake and flush, cumulative
partials, tick batching of two sessions, the config action, an unknown
action and bad JSON, an unsupported rate, an 8 kHz client, the VAD flush
debounce and the single-tick flush, the session limit on and off), then
parity with the JAX server: the same PCM message sequence to JAX's app
(through aiohttp's test client) and to the port, on the same checkpoint,
gives the same JSON messages in the same order, with the server VAD off
and on. Then the tick batcher: concurrent ticks coalesce into fewer
dispatches, each row with its solo resume tokens; a refused WS mode; and
the frame codec's edges (fragments, ping, a large frame)."""
import asyncio
import concurrent.futures
import contextlib
import json
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.runtime import batcher as batcher_mod
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
from qwen3_asr_tpu_torch.serving import ws as ws_mod
from qwen3_asr_tpu_torch.serving import wsproto
from qwen3_asr_tpu_torch.serving.server import build_server
from tests.util_audio import speech_like

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
TICK = ws_mod.WS_BUFFER_SIZE


@pytest.fixture(scope="module", autouse=True)
def _skip_warmup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKIP_WARMUP", "true")
        mp.setenv("REQUEST_TIMEOUT", "120")
        for var in ("ASR_WS_TICK_BATCH", "ASR_WS_STREAM_MODE",
                    "ASR_WS_PREFIX_CACHE", "ASR_MAX_SESSIONS", "ASR_VAD"):
            mp.delenv(var, raising=False)
        yield


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def serving(manager):
    """The server for ``manager`` on an ephemeral port; yields its ws://
    base URL."""
    manager.start()
    server = build_server(manager, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"ws://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        manager.stop()
        thread.join(timeout=10)


@pytest.fixture(scope="module")
def engine():
    return load_engine(CKPT, device="cpu")


@pytest.fixture(scope="module")
def manager(engine):
    return ModelManager(engine)


@pytest.fixture(scope="module")
def base(manager):
    with serving(manager) as u:
        yield u


def _pcm(audio: np.ndarray) -> bytes:
    return np.clip(audio * 32767, -32768, 32767).astype("<i2").tobytes()


def _real_pcm(name: str, seconds: float = None) -> bytes:
    with open(os.path.join(ROOT, "real", name), "rb") as f:
        audio, sr = decode_audio(f.read())
    assert sr == 16000
    if seconds:
        audio = audio[:int(seconds * sr)]
    # the WAV's s16 samples, exactly (the decoder scales them by 2^-15)
    return np.round(audio * 32768.0).astype("<i2").tobytes()


def _connect(base, query=""):
    return ws_mod.connect(base + "/ws/transcribe" + query, timeout=120)


def test_ws_handshake_and_flush(base):
    ws = _connect(base)
    hello = ws.receive_json()
    assert hello == {"status": "connected", "sample_rate": 16000,
                     "format": "pcm_s16le", "buffer_size": 14400,
                     "window_max_s": 6.0,
                     "use_server_vad": ws_mod.ASR_USE_SERVER_VAD}
    ws.send_bytes(_pcm(speech_like(0.3, seed=2)))
    ws.send_json({"action": "flush"})
    msg = ws.receive_json()
    assert msg["is_final"] is True and msg["is_partial"] is False
    ws.close()


def test_ws_partials_cumulative(base):
    """Real speech in 450 ms messages, VAD off: partials arrive, each a
    transcript of the growing window, and reset answers buffer_reset."""
    ws = _connect(base, "?use_server_vad=false")
    ws.receive_json()
    pcm = _real_pcm("english_01.wav", 3.0)
    for i in range(0, len(pcm), TICK):
        ws.send_bytes(pcm[i:i + TICK])
    ws.send_json({"action": "reset"})
    msgs = [ws.receive_json()]
    while msgs[-1] != {"status": "buffer_reset"}:
        msgs.append(ws.receive_json())
    ws.close()
    partials = [m["text"] for m in msgs[:-1]]
    assert all(m["is_partial"] and not m["is_final"] for m in msgs[:-1])
    assert len(partials) >= 3
    assert len(partials[-1]) > len(partials[0]) > 0


def test_ws_tick_batching_two_sessions(base, monkeypatch):
    """ASR_WS_TICK_BATCH=true: two concurrent sessions' partials go
    through the tick batcher."""
    monkeypatch.setenv("ASR_WS_TICK_BATCH", "true")
    calls = []
    orig = batcher_mod.TickBatcher.transcribe_tick

    def spy(self, audio, language, resume_tokens, use_fast):
        calls.append(len(audio))
        return orig(self, audio, language, resume_tokens, use_fast)

    monkeypatch.setattr(batcher_mod.TickBatcher, "transcribe_tick", spy)
    errors = []

    def session(seed):
        ws = _connect(base, "?use_server_vad=false")
        ws.receive_json()
        pcm = _pcm(speech_like(1.2, seed=seed))
        for i in range(0, len(pcm), TICK):
            ws.send_bytes(pcm[i:i + TICK])
        ws.send_json({"action": "flush"})
        while True:
            msg = ws.receive_json()
            if "error" in msg.get("text", ""):
                errors.append(msg)
            if msg.get("is_final"):
                break
        ws.close()

    threads = [threading.Thread(target=session, args=(s,)) for s in (5, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert calls and not errors


def test_ws_config_action(base):
    ws = _connect(base)
    ws.receive_json()
    ws.send_json({"action": "config", "language": "zh",
                  "use_server_vad": False})
    assert ws.receive_json() == {"status": "configured", "language": "zh",
                                 "use_server_vad": False}
    ws.send_json({"action": "config", "language": "auto"})
    assert ws.receive_json()["language"] == "auto"
    ws.close()


def test_ws_unknown_action_and_bad_json(base):
    ws = _connect(base)
    ws.receive_json()
    ws.send_json({"action": "bogus"})
    msg = ws.receive_json()
    assert msg["code"] == "UNKNOWN_ACTION" and msg["statusCode"] == 400
    ws.send_text("{not json")
    msg = ws.receive_json()
    assert msg["code"] == "INVALID_JSON" and msg["statusCode"] == 400
    ws.close()


def test_ws_unsupported_sample_rate(base):
    ws = _connect(base, "?sample_rate=44100")
    msg = ws.receive_json()
    assert msg["code"] == "UNSUPPORTED_SAMPLE_RATE"
    assert msg["statusCode"] == 400
    assert ws.receive().kind == "close"


def test_ws_8k_resample(base):
    ws = _connect(base, "?sample_rate=8000")
    assert ws.receive_json()["sample_rate"] == 8000
    ws.send_bytes(_pcm(speech_like(0.3, sr=8000, seed=4)))
    ws.send_json({"action": "flush"})
    assert ws.receive_json()["is_final"] is True
    ws.close()


def _scripted(monkeypatch, script, flush_ticks):
    monkeypatch.setattr(ws_mod, "ASR_VAD_FLUSH_TICKS", flush_ticks)
    it = iter(script)
    monkeypatch.setattr(ws_mod, "is_speech", lambda a, **k: next(it))
    monkeypatch.setattr(ws_mod, "_transcribe_with_context",
                        lambda *a, **k: ("TEXT", None))


def _ticks(base, n):
    ws = _connect(base, "?use_server_vad=true")
    ws.receive_json()
    pcm = b"\x01\x00" * (TICK // 2)
    msgs = []
    for _ in range(n):
        ws.send_bytes(pcm)
        msgs.append(ws.receive_json(timeout=30))
    ws.close()
    return msgs


def test_ws_vad_flush_debounce(base, monkeypatch):
    """A 2-tick debounce: one silent tick mid-speech stays a partial; two
    in a row flush a final."""
    script = [True, True, False, True, True, False, False]
    _scripted(monkeypatch, script, 2)
    msgs = _ticks(base, len(script))
    finals = [m for m in msgs if m.get("is_final")]
    partials = [m for m in msgs if m.get("is_partial")]
    assert len(finals) == 1 and msgs[-1].get("is_final")
    assert len(partials) == len(script) - 1


def test_ws_vad_flush_single_tick(base, monkeypatch):
    """With the learned VAD's default of one tick, the first silent tick
    after speech flushes."""
    script = [True, True, False, True]
    _scripted(monkeypatch, script, 1)
    msgs = _ticks(base, len(script))
    assert len([m for m in msgs if m.get("is_final")]) == 1
    assert msgs[2].get("is_final")


def _wait_no_live_session(base, timeout=60.0):
    """Until the server counts no live WS session: an earlier test's
    session ends on the server's thread after its client has closed."""
    import time
    import urllib.request
    http = base.replace("ws://", "http://") + "/health"
    deadline = time.monotonic() + timeout
    while True:
        with urllib.request.urlopen(http, timeout=30) as r:
            live = json.loads(r.read())["active_ws_sessions"]
        if live == 0 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert live == 0


def test_ws_session_limit_rejects_then_recovers(base, monkeypatch):
    import urllib.request
    _wait_no_live_session(base)
    monkeypatch.setenv("ASR_MAX_SESSIONS", "1")
    ws1 = _connect(base)
    assert ws1.receive_json()["status"] == "connected"
    ws2 = _connect(base)
    msg = ws2.receive_json()
    assert msg["code"] == "SESSION_LIMIT_REACHED"
    assert msg["statusCode"] == 503
    closed = ws2.receive()
    assert closed.kind == "close"
    assert closed.data == ws_mod.CLOSE_TRY_AGAIN_LATER
    http = base.replace("ws://", "http://") + "/health"
    with urllib.request.urlopen(http, timeout=30) as r:
        assert json.loads(r.read())["active_ws_sessions"] == 1
    ws1.send_bytes(_pcm(speech_like(0.3, seed=11)))
    ws1.send_json({"action": "flush"})
    assert ws1.receive_json()["is_final"] is True
    ws1.close()
    assert ws1.receive().kind == "close"
    ws3 = _connect(base)
    assert ws3.receive_json()["status"] == "connected"
    ws3.close()


def test_ws_session_limit_off_by_default(base, monkeypatch):
    monkeypatch.delenv("ASR_MAX_SESSIONS", raising=False)
    sockets = [_connect(base) for _ in range(3)]
    for ws in sockets:
        assert ws.receive_json()["status"] == "connected"
    for ws in sockets:
        ws.close()


# -- parity with the JAX server --------------------------------------------------

def _script(name: str):
    """A session's messages: a real clip in 450 ms binary messages with a
    stretch of silence inside (a VAD edge), a flush, then a reset that
    marks the end."""
    pcm = _real_pcm(name)
    silence = bytes(3 * TICK)
    pcm = pcm[:len(pcm) // 2] + silence + pcm[len(pcm) // 2:]
    out = [("bytes", pcm[i:i + TICK]) for i in range(0, len(pcm), TICK)]
    return out + [("json", {"action": "flush"}),
                  ("json", {"action": "reset"})]


def _port_session(base, query, script):
    ws = _connect(base, query)
    got = [ws.receive_json()]
    for kind, data in script:
        (ws.send_bytes if kind == "bytes" else ws.send_json)(data)
    while got[-1] != {"status": "buffer_reset"}:
        got.append(ws.receive_json())
    ws.close()
    return got


def _jax_session(query, script):
    from aiohttp.test_utils import TestClient, TestServer
    from qwen3_asr_tpu.serving.server import build_app

    async def go():
        client = TestClient(TestServer(build_app()))
        await client.start_server()
        try:
            ws = await client.ws_connect("/ws/transcribe" + query)
            got = [await ws.receive_json()]
            for kind, data in script:
                if kind == "bytes":
                    await ws.send_bytes(data)
                else:
                    await ws.send_json(data)
            while got[-1] != {"status": "buffer_reset"}:
                got.append(await asyncio.wait_for(ws.receive_json(), 300))
            await ws.close()
            return got
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


@pytest.mark.parametrize("vad", ["false", "true"], ids=["vad_off",
                                                        "vad_on"])
def test_ws_messages_match_jax_server(base, monkeypatch, vad):
    monkeypatch.setenv("MODEL_ID", CKPT)
    script = _script("english_02.wav")
    query = f"?use_server_vad={vad}"
    ours = _port_session(base, query, script)
    ref = _jax_session(query, script)
    assert ours == ref
    kinds = [("final" if m.get("is_final") else "partial")
             for m in ours if "text" in m]
    assert "partial" in kinds and kinds[-1] == "final"
    if vad == "true":
        # the silence inside the clip is a VAD edge: a final before the end
        assert kinds.count("final") >= 2
    texts = [m["text"] for m in ours if "text" in m]
    assert any(len(t) > 10 for t in texts)


# -- the tick batcher ----------------------------------------------------------------

def test_tick_batcher_coalesces_and_matches_solo(engine):
    """Three sessions' ticks inside one window: one dispatch at B=4 (a pad
    row), each row's tokens those of its solo resume run."""
    from qwen3_asr_tpu_torch.audio.frontend import pcm16_to_f32
    manager = ModelManager(engine)
    manager.tick_batcher = batcher_mod.TickBatcher(manager, window_ms=2000,
                                                   max_batch=8)
    manager.ws_sessions = 3
    clips = [pcm16_to_f32(_real_pcm(n, 1.8)) for n in
             ("english_01.wav", "chinese_02.wav", "japanese_01.wav")]
    drafts = [None, [5, 9, 2], None]
    solo = [engine.transcribe(c, 16000, "en", resume_tokens=d)[0]
            for c, d in zip(clips, drafts)]
    manager.start()
    try:
        futures = [manager.tick_batcher.transcribe_tick(c, "en", d, True)
                   for c, d in zip(clips, drafts)]
        results = [f.result(timeout=300) for f in futures]
    finally:
        manager.stop()
    assert manager.tick_batcher.dispatches == 1
    assert manager.tick_batcher.groups == {3: 1}
    assert engine.last_run["batch"] == 4 and engine.last_run["resume"]
    assert [ids for _, ids in results] == [r.token_ids for r in solo]
    assert [t for t, _ in results] == [r.text for r in solo]


def test_refused_ws_modes_raise_at_start(engine, monkeypatch):
    """An unknown mode name is refused at start (every named mode, the
    ``auto`` policy at a 12 s cap too, is served)."""
    monkeypatch.setenv("ASR_WS_STREAM_MODE", "turbo")
    with pytest.raises(ValueError, match="not ported"):
        ModelManager(engine).start()


# -- mode prefix (runtime/stream.py) --------------------------------------------------

def _prefix_mode(monkeypatch, cap_s):
    """ASR_WS_STREAM_MODE=prefix at a ``cap_s`` window cap (the server's
    module constants, read at import)."""
    monkeypatch.setenv("ASR_WS_STREAM_MODE", "prefix")
    monkeypatch.setattr(ws_mod, "WS_WINDOW_MAX_S", cap_s)
    monkeypatch.setattr(ws_mod, "WS_WINDOW_MAX_BYTES", int(cap_s * 16000 * 2))


def _until_final(ws):
    msgs = [ws.receive_json(timeout=120)]
    while not msgs[-1].get("is_final"):
        msgs.append(ws.receive_json(timeout=120))
    return msgs


def test_ws_prefix_partials_equal_a_session_and_final_the_fused_path(
        base, engine, manager, monkeypatch):
    """One prefix-mode connection (cap 3 s, trained_ckpt's 1 s chunks):
    its partials are those of a StreamSession fed the same bandpassed
    windows, trimmed in 1 s steps; its final is the fused path's on the
    sample-exact window and the flush's silence; the session had tail
    ticks and was bound once."""
    from qwen3_asr_tpu_torch.audio.frontend import fir_same, pcm16_to_f32
    from qwen3_asr_tpu_torch.text.repetition import \
        detect_and_fix_repetitions
    _prefix_mode(monkeypatch, 3.0)
    quantum = ws_mod.trim_quantum_bytes(engine, True)
    assert quantum == 32000
    pcm = _real_pcm("english_02.wav", 5.5)
    bandpass = ws_mod._bandpass_kernel()
    ref = engine.stream_session(3.0, "English")
    window, exact, want, prev = bytearray(), bytearray(), [], None
    for i in range(0, len(pcm) - TICK + 1, TICK):
        window += pcm[i:i + TICK]
        exact += pcm[i:i + TICK]
        ws_mod._trim_partial(window, quantum)
        ws_mod._trim_exact(exact)
        text, prev = ref.update(fir_same(pcm16_to_f32(bytes(window)),
                                         bandpass))
        if text:
            want.append(detect_and_fix_repetitions(text))
    assert ref.stats["tail"] > 0 and len(want) >= 5, (ref.stats, want)
    ref.release()
    full = fir_same(pcm16_to_f32(bytes(exact) + bytes(
        int(ws_mod.WS_FLUSH_SILENCE_MS / 1000 * 16000) * 2)), bandpass)
    final = engine.transcribe(full, 16000, "English", resume_tokens=prev)

    failures = ws_mod.prefix_bind_failures
    ws = _connect(base, "?use_server_vad=false")
    ws.receive_json()
    n = len(pcm) - len(pcm) % TICK
    for i in range(0, n, TICK):
        ws.send_bytes(pcm[i:i + TICK])
    ws.send_json({"action": "flush"})
    msgs = _until_final(ws)
    # the flush's reset is done once the next action is answered
    ws.send_json({"action": "reset"})
    assert ws.receive_json(timeout=60) == {"status": "buffer_reset"}
    sess = manager.last_stream_session
    ws.close()
    assert [m["text"] for m in msgs[:-1]] == want
    assert all(m["is_partial"] for m in msgs[:-1])
    assert msgs[-1]["text"] == detect_and_fix_repetitions(final[0].text)
    assert ws_mod.prefix_bind_failures == failures
    assert sess is not None and sess.stats["tail"] > 0, sess and sess.stats
    assert not sess.has_state()      # the flush reset it


@pytest.mark.parametrize("mode,bind", [("prefix", "stream_session"),
                                       ("grouped", "stream_group_member")])
def test_ws_prefix_bind_failure_answers_error(base, engine, manager,
                                              monkeypatch, mode, bind):
    """A session (mode ``prefix``) or a group member (mode ``grouped``)
    that cannot be bound: the tick answers "[error: ...]", the failure is
    counted, and nothing serves it on the fused path."""
    # an earlier connection's final on its close takes the fused path
    _wait_no_live_session(base)
    _prefix_mode(monkeypatch, 3.0)
    monkeypatch.setenv("ASR_WS_STREAM_MODE", mode)

    def refuse(*a, **k):
        raise RuntimeError("no room for a session")
    monkeypatch.setattr(engine, bind, refuse)
    fused = []
    orig = manager.transcribe_sync
    monkeypatch.setattr(manager, "transcribe_sync",
                        lambda *a, **k: fused.append(1) or orig(*a, **k))
    failures = ws_mod.prefix_bind_failures
    ws = _connect(base, "?use_server_vad=false")
    ws.receive_json()
    ws.send_bytes(_real_pcm("english_01.wav", 0.45)[:TICK])
    msg = ws.receive_json(timeout=60)
    # before the close, whose final of what is left takes the fused path
    assert not fused
    ws.close()
    assert msg == {"text": "[error: no room for a session]",
                   "is_partial": True, "is_final": False}
    assert ws_mod.prefix_bind_failures == failures + 1


# -- mode grouped (runtime/stream_group.py) -------------------------------------------

def _jax_sessions(query, scripts):
    """JAX's app, one connection a script, all at once; each connection's
    messages up to its ``buffer_reset``."""
    from aiohttp.test_utils import TestClient, TestServer
    from qwen3_asr_tpu.serving.server import build_app

    async def one(client, script):
        ws = await client.ws_connect("/ws/transcribe" + query)
        got = [await ws.receive_json()]
        for kind, data in script:
            if kind == "bytes":
                await ws.send_bytes(data)
            else:
                await ws.send_json(data)
        while got[-1] != {"status": "buffer_reset"}:
            got.append(await asyncio.wait_for(ws.receive_json(), 300))
        await ws.close()
        return got

    async def go():
        client = TestClient(TestServer(build_app()))
        await client.start_server()
        try:
            return await asyncio.gather(*[one(client, s) for s in scripts])
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


@pytest.mark.parametrize("flags", [
    {"ASR_WS_STREAM_MODE": "grouped"},
    {"ASR_WS_PREFIX_CACHE": "true", "ASR_WS_TICK_BATCH": "true"}],
    ids=["grouped", "legacy_both"])
def test_ws_grouped_sessions_join_one_group_and_match_jax(engine,
                                                          monkeypatch,
                                                          flags):
    """Two connections in mode ``grouped`` (named, or by both legacy
    flags) at the default 6 s cap: they join ONE group, their partials
    coalesce through the group tick batcher (fewer dispatches than
    ticks), every message (partials, the flush's final, the reset) equals
    JAX's server's for the same PCM, and a close releases the member's
    slot (the emptied group leaves the registry)."""
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("MODEL_ID", CKPT)
    scripts = []
    for name in ("english_01.wav", "english_02.wav"):
        pcm = _real_pcm(name, 7.2)
        scripts.append([("bytes", pcm[i:i + TICK])
                        for i in range(0, len(pcm), TICK)]
                       + [("json", {"action": "flush"}),
                          ("json", {"action": "reset"})])
    query = "?use_server_vad=false"
    manager = ModelManager(engine)
    manager.group_tick_batcher = batcher_mod.GroupTickBatcher(
        manager, window_ms=1000, max_batch=2)
    groups = []
    orig = engine.stream_group_member

    def keep(*a, **k):
        member = orig(*a, **k)
        groups.append(member.group)
        return member
    monkeypatch.setattr(engine, "stream_group_member", keep)
    failures = ws_mod.prefix_bind_failures
    with serving(manager) as u:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            ours = list(pool.map(lambda s: _port_session(u, query, s),
                                 scripts))
        for _ in range(200):            # the handlers release on close
            if not any(engine._stream_groups.values()):
                break
            time.sleep(0.05)
    ref = _jax_sessions(query, scripts)
    assert ours == ref
    assert len(groups) == 2 and groups[0] is groups[1]
    assert groups[0].live_members == 0
    assert not any(engine._stream_groups.values())
    batcher = manager.group_tick_batcher
    assert batcher.ticks == sum(len(s) - 2 for s in scripts)
    assert batcher.dispatches < batcher.ticks and 2 in batcher.groups
    assert ws_mod.prefix_bind_failures == failures
    kinds = [("final" if m.get("is_final") else "partial")
             for msgs in ours for m in msgs if "text" in m]
    assert kinds.count("partial") > 10 and "final" in kinds


# -- the frame codec -----------------------------------------------------------------

def test_fragments_ping_and_large_frames(base):
    """A text command in three fragments with a ping between them, and a
    binary message past 64 KiB: the ping is answered, the command runs,
    the large message is taken."""
    ws = _connect(base, "?use_server_vad=false")
    ws.receive_json()
    cmd = json.dumps({"action": "config", "language": "en"}).encode()
    frames = [(wsproto.OP_TEXT, cmd[:5], False),
              (wsproto.OP_PING, b"hi", True),
              (wsproto.OP_CONT, cmd[5:9], False),
              (wsproto.OP_CONT, cmd[9:], True)]
    for op, data, fin in frames:
        _send_frame(ws, op, data, fin)
    got = ws.receive_json()
    assert got["status"] == "configured" and got["language"] == "en"
    ws.send_bytes(bytes(70000))
    ws.send_json({"action": "reset"})
    msgs = []
    while True:
        msgs.append(ws.receive_json())
        if msgs[-1] == {"status": "buffer_reset"}:
            break
    ws.close()


def _send_frame(ws, op, data, fin):
    mask = b"\x01\x02\x03\x04"
    head = bytes([(0x80 if fin else 0) | op, 0x80 | len(data)]) + mask
    ws.wfile.write(head + wsproto._apply_mask(data, mask))
    ws.wfile.flush()


def test_accept_key_is_rfc6455s_example():
    assert wsproto.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    assert struct.pack(">H", ws_mod.CLOSE_TRY_AGAIN_LATER) == b"\x03\xf5"
