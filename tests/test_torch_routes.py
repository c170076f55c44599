"""The port's sidecar routes (``serving/server.py``) against the JAX
package's aiohttp app, both serving ``e2e/data/trained_ckpt`` on the CPU
in f32, with ``FORCED_ALIGNER_ID`` at the same checkpoint: the same
uploads to both must give the same statuses, error bodies, SSE events,
SRT bytes and translation answers (an OpenAI-compatible fake on the
standard library plays the LLM for both), and ``return_timestamps``
bodies with every start and end within 1e-3 s. Then what only the port
can show: concurrent SSE streams sharing dispatches, a client that leaves
mid-stream, the aligner's ``/health`` states and its retry backoff, and
device work on the queue's thread."""
import asyncio
import contextlib
import http.client
import json
import os
import threading
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from qwen3_asr_tpu.serving import server as jserver
from qwen3_asr_tpu.sidecars import subtitle as jsub
from qwen3_asr_tpu_torch.audio.codec import decode_audio, encode_wav
from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
from qwen3_asr_tpu_torch.serving import server as server_mod
from qwen3_asr_tpu_torch.serving.server import build_server
from qwen3_asr_tpu_torch.sidecars import subtitle as sub

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.abspath(os.path.join(ROOT, "trained_ckpt"))
TIME_ATOL = 1e-3
NO_SAMPLES = encode_wav(np.zeros(0, np.float32), 16000)


def _wav(name):
    with open(os.path.join(ROOT, "real", name), "rb") as f:
        return f.read()


def _audio(name):
    """A real clip's samples, f32 at 16 kHz."""
    audio, sr = decode_audio(_wav(name))
    assert sr == 16000
    return audio.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {"SKIP_WARMUP": "true", "REQUEST_TIMEOUT": "300",
                     "IDLE_TIMEOUT": "0", "MODEL_ID": CKPT,
                     "ASR_TIMESTAMP_MODE": "accurate",
                     "TRANSLATE_TIMEOUT": "30",
                     "TRANSLATE_MODEL": "test-model"}.items():
            mp.setenv(k, v)
        mp.setattr(sub, "FORCED_ALIGNER_ID", CKPT)
        mp.setattr(jsub, "FORCED_ALIGNER_ID", CKPT)
        yield


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def serving(manager):
    manager.start()
    server = build_server(manager, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        manager.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def engine():
    return load_engine(CKPT, device="cpu")


@pytest.fixture(scope="module")
def port(engine):
    """The port's server, its batcher's window widened so concurrent SSE
    chunks meet."""
    manager = ModelManager(engine)
    manager.batcher = MicroBatcher(manager, window_ms=300, max_batch=8)
    with serving(manager) as server:
        yield server


@pytest.fixture(scope="module")
def jax_app():
    """JAX's app on aiohttp's test server, in an event loop of its own:
    yields a function that runs a coroutine of (client) there."""
    from aiohttp.test_utils import TestClient, TestServer
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(jserver.build_app()), loop=loop)
    loop.run_until_complete(client.start_server())

    def run(fn):
        return loop.run_until_complete(asyncio.wait_for(fn(client), 600))

    yield run
    loop.run_until_complete(client.close())
    loop.close()


@pytest.fixture(autouse=True)
def _aligner_unloaded():
    """Each test starts with no aligner loaded and no backoff pending."""
    sub.unload_aligner()
    jsub.unload_aligner()
    jserver._aligner_retry_at = 0.0
    yield
    sub.unload_aligner()
    jsub.unload_aligner()
    jserver._aligner_retry_at = 0.0


def _form(data: bytes, fields):
    bnd = uuid.uuid4().hex
    body = b""
    for k, v in fields.items():
        body += (f"--{bnd}\r\nContent-Disposition: form-data; name=\"{k}\""
                 f"\r\n\r\n{v}\r\n").encode()
    body += (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
             f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
             ).encode() + data + f"\r\n--{bnd}--\r\n".encode()
    return body, f"multipart/form-data; boundary={bnd}"


def post_port(server, path, data, **fields):
    """(status, headers, body bytes) from the port's server."""
    body, ctype = _form(data, fields)
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.server_address[1]}{path}", data=body,
        method="POST", headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def post_jax(jax_app, path, data, **fields):
    """(status, headers, body bytes) from JAX's app, for the same form."""
    body, ctype = _form(data, fields)

    async def go(client):
        resp = await client.post(path, data=body,
                                 headers={"Content-Type": ctype})
        return resp.status, resp.headers, await resp.read()

    return jax_app(go)


def post_both(port, jax_app, path, data, **fields):
    ours = post_port(port, path, data, **fields)
    ref = post_jax(jax_app, path, data, **fields)
    assert ours[0] == ref[0], (ours[0], ours[2][:300], ref[2][:300])
    return ours, ref


def _events(raw: bytes):
    return [json.loads(line[6:]) for line in raw.decode().splitlines()
            if line.startswith("data: ")]


def _jax_error(raw: bytes) -> dict:
    """JAX's error body without the request id its context adds (the
    port sends the id as the ``X-Request-ID`` header only)."""
    body = json.loads(raw)
    ctx = {k: v for k, v in body.pop("context", {}).items()
           if k != "requestId"}
    return {**body, **({"context": ctx} if ctx else {})}


def _health(server):
    url = f"http://127.0.0.1:{server.server_address[1]}/health"
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


# -- SSE -----------------------------------------------------------------------------

@pytest.mark.parametrize("clip,fields", [
    ("thai_02.wav", {}),                           # 7.2 s: chunked
    ("english_01.wav", {"language": "en"}),        # 10.56 s: 3 chunks
    ("cantonese_02.wav", {"return_timestamps": "true"}),
])
def test_sse_events_match_jax(port, jax_app, clip, fields):
    (st, hdr, raw), (_, jhdr, jraw) = post_both(
        port, jax_app, "/v1/audio/transcriptions/stream", _wav(clip),
        **fields)
    assert st == 200
    for h in ("Content-Type", "Cache-Control", "X-Accel-Buffering"):
        assert hdr[h] == jhdr[h]
    assert hdr["Transfer-Encoding"] == "chunked"
    assert hdr["X-Request-ID"]
    ours, ref = _events(raw), _events(jraw)
    assert ours == ref
    chunked = [e for e in ours if "chunk_index" in e]
    assert len(chunked) >= 2 and chunked[-1]["is_final"]
    assert [e["chunk_index"] for e in chunked] == list(range(len(chunked)))
    assert ours[-1] == {"done": True}


def test_sse_short_upload_is_one_final_event(port, jax_app):
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/transcriptions/stream",
        encode_wav(_audio("english_02.wav")[:4 * 16000], 16000),
        language="en", return_timestamps="true")
    ours = _events(raw)
    assert ours == _events(jraw)
    assert len(ours) == 2 and ours[0]["is_final"] and ours[0]["text"]
    assert "chunk_index" not in ours[0] and ours[1] == {"done": True}


@pytest.mark.parametrize("data", [b"", b"not audio" * 9],
                         ids=["empty", "garbage"])
def test_sse_decode_error_is_a_422_body(port, jax_app, data):
    """The body JAX's server gives (its context also carries its request
    id, and its codec error names more formats than the port reads)."""
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/transcriptions/stream", data)
    ours, ref = json.loads(raw), json.loads(jraw)
    assert st == 422 and ours["code"] == ref["code"] == "AUDIO_DECODE_FAILED"
    assert ours["statusCode"] == ref["statusCode"] == 422
    assert ours["context"]["fileSize"] == ref["context"]["fileSize"]
    if not data:
        assert ours["message"] == ref["message"]


def test_sse_overlap_clamped_and_error_event(port, monkeypatch):
    """A misconfigured overlap (>= the chunk) is clamped to half a chunk;
    a failing chunk ends the stream with the SSE_STREAM_ERROR event."""
    from qwen3_asr_tpu_torch import config
    monkeypatch.setattr(config, "SSE_OVERLAP_SECONDS", 5)
    _, _, raw = post_port(port, "/v1/audio/transcriptions/stream",
                          _wav("english_02.wav"))
    chunks = [e for e in _events(raw) if "chunk_index" in e]
    assert len(chunks) == 3          # 8.76 s in 5 s chunks stepping 2.5 s

    def broken(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(port.manager.batcher, "transcribe", broken)
    _, _, raw = post_port(port, "/v1/audio/transcriptions/stream",
                          _wav("english_02.wav"))
    assert _events(raw) == [{"code": "SSE_STREAM_ERROR",
                             "message": "device fault", "statusCode": 500}]


def test_sse_concurrent_streams_share_dispatches(port, jax_app):
    """Four streams at once: every stream's events are its JAX events, in
    order, and their chunks rode fewer dispatches than chunks."""
    clips = ["english_01.wav", "chinese_01.wav", "hindi_01.wav",
             "japanese_01.wav"]
    want = {c: _events(post_jax(jax_app, "/v1/audio/transcriptions/stream",
                                _wav(c))[2]) for c in clips}
    before = port.manager.batcher.dispatches
    got = {}
    threads = [threading.Thread(target=lambda c=c: got.__setitem__(
        c, _events(post_port(port, "/v1/audio/transcriptions/stream",
                             _wav(c))[2]))) for c in clips]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert got == want
    chunks = sum(len(e) - 1 for e in want.values())
    dispatches = port.manager.batcher.dispatches - before
    assert dispatches < chunks, (dispatches, chunks)


def test_sse_client_that_leaves_ends_the_stream(port, monkeypatch):
    """A client that closes after the first event: the stream ends on the
    next write, nothing reaches the server's error handler, and the
    server goes on answering."""
    errors = []
    monkeypatch.setattr(port, "handle_error",
                        lambda request, address: errors.append(address))
    body, ctype = _form(encode_wav(np.tile(_audio("english_02.wav"), 4),
                                   16000), {})
    conn = http.client.HTTPConnection("127.0.0.1", port.server_address[1],
                                      timeout=300)
    conn.request("POST", "/v1/audio/transcriptions/stream", body,
                 {"Content-Type": ctype})
    resp = conn.getresponse()
    assert resp.status == 200
    first = resp.fp.readline()
    assert first.strip()                          # the first chunk's size
    conn.sock.close()
    conn.close()
    # the queue drains the stream's last chunk, then answers this one
    assert post_port(port, "/v1/audio/subtitles", _wav("thai_02.wav"),
                     mode="fast")[0] == 200
    assert _health(port)["status"] == "ok"
    assert errors == []


# -- subtitles -------------------------------------------------------------------------

@pytest.mark.parametrize("mode,clip,fields", [
    ("fast", "english_02.wav", {}),
    ("fast", "chinese_02.wav", {"max_line_chars": "12"}),
    ("accurate", "english_01.wav", {"language": "en"}),
    ("accurate", "japanese_02.wav", {}),
    ("accurate", "hindi_02.wav", {"max_line_chars": "bogus"}),
])
def test_subtitles_match_jax(port, jax_app, mode, clip, fields):
    (st, hdr, srt), (_, jhdr, jsrt) = post_both(
        port, jax_app, "/v1/audio/subtitles", _wav(clip), mode=mode,
        **fields)
    assert st == 200
    assert srt == jsrt and b"-->" in srt
    assert hdr["Content-Disposition"] == jhdr["Content-Disposition"] == \
        'attachment; filename="subtitles.srt"'
    assert hdr["Content-Type"] == jhdr["Content-Type"]
    if mode == "accurate":
        assert sub.aligner_loaded()


def test_subtitles_invalid_mode_before_decoding(port, jax_app):
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/subtitles", b"", mode="wrong")
    assert st == 422
    assert json.loads(raw) == _jax_error(jraw)
    assert json.loads(raw)["code"] == "INVALID_MODE"


@pytest.mark.parametrize("failure", ["missing", "timeout"])
def test_subtitles_aligner_load_failure_is_503(port, jax_app, monkeypatch,
                                               failure):
    if failure == "missing":
        missing = os.path.join(ROOT, "no_such_aligner")
        monkeypatch.setattr(sub, "FORCED_ALIGNER_ID", missing)
        monkeypatch.setattr(jsub, "FORCED_ALIGNER_ID", missing)
    else:
        def slow(*a, **k):
            raise RuntimeError("aligner load timeout")
        monkeypatch.setattr(sub, "load_aligner", slow)
        monkeypatch.setattr(jsub, "load_aligner", slow)
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/subtitles", _wav("thai_02.wav"))
    assert st == 503
    assert json.loads(raw) == _jax_error(jraw)
    want = "WORKER_ERROR" if failure == "missing" else "SUBTITLE_TIMEOUT"
    assert json.loads(raw)["code"] == want


def test_subtitles_empty_transcript_is_an_empty_srt(port, jax_app):
    """A WAV with no samples transcribes to no result: an empty SRT."""
    (st, hdr, srt), (_, _, jsrt) = post_both(
        port, jax_app, "/v1/audio/subtitles", NO_SAMPLES, mode="fast")
    assert st == 200 and srt == jsrt == b""
    assert "subtitles.srt" in hdr["Content-Disposition"]


# -- translations ------------------------------------------------------------------------

class FakeLLM:
    """An OpenAI-compatible chat endpoint: records each request body and
    answers a translation that names the request's prompt length, or 500
    with ``fail``."""

    def __init__(self):
        self.bodies, self.fail = [], False
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                fake.bodies.append(body)
                user = body["messages"][1]["content"]
                if "SRT" in user:
                    srt = user.split("SRT Content:\n", 1)[1]
                    content = "```srt\n" + srt.replace(" ", "_") + "\n```"
                else:
                    content = f"[{len(user)}] translated"
                data = json.dumps({"choices": [{"message": {
                    "content": content}}]}).encode()
                self.send_response(500 if fake.fail else 200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def llm(monkeypatch):
    fake = FakeLLM()
    monkeypatch.setenv("OPENAI_BASE_URL",
                       f"http://127.0.0.1:{fake.server.server_address[1]}/v1")
    yield fake
    fake.close()


@pytest.mark.parametrize("fmt,language", [("json", "en"), ("json", "zh"),
                                          ("json", "fr"), ("srt", "zh"),
                                          ("srt", "EN")])
def test_translations_match_jax(port, jax_app, llm, fmt, language):
    (st, hdr, raw), (_, jhdr, jraw) = post_both(
        port, jax_app, "/v1/audio/translations", _wav("chinese_01.wav"),
        language=language, response_format=fmt)
    assert st == 200
    if fmt == "srt":
        assert raw == jraw
    else:
        assert json.loads(raw) == json.loads(jraw)
    assert len(llm.bodies) == 2 and llm.bodies[0] == llm.bodies[1]
    target = "en" if language.lower() not in ("en", "zh") else \
        language.lower()
    if fmt == "json":
        assert json.loads(raw)["language"] == target
        assert json.loads(raw)["text"].endswith("translated")
        assert llm.bodies[0]["temperature"] == 0.3
    else:
        assert hdr["Content-Disposition"] == jhdr["Content-Disposition"] == \
            'attachment; filename="translated_subtitles.srt"'
        assert b"-->" in raw and not raw.startswith(b"```")
        assert llm.bodies[0]["temperature"] == 0.1


@pytest.mark.parametrize("fmt", ["json", "srt"])
def test_translation_failure_is_502(port, jax_app, llm, fmt):
    llm.fail = True
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/translations", _wav("english_02.wav"),
        response_format=fmt)
    assert st == 502
    ours, ref = json.loads(raw), json.loads(jraw)
    assert ours["code"] == ref["code"] == "TRANSLATION_FAILED"
    assert ours["statusCode"] == 502
    assert ours["message"].startswith("Translation API failed: ")
    assert "500" in ours["message"] and "500" in ref["message"]


def test_translation_of_an_empty_transcript(port, jax_app, llm):
    """No result: an empty text or SRT, and no call to the LLM."""
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/translations", NO_SAMPLES, language="zh")
    assert st == 200
    assert json.loads(raw) == json.loads(jraw) == {"text": "",
                                                   "language": "zh"}
    (st, hdr, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/translations", NO_SAMPLES,
        response_format="srt")
    assert st == 200 and raw == jraw == b""
    assert "Content-Disposition" not in hdr
    assert llm.bodies == []


# -- word timestamps ---------------------------------------------------------------------

def _same_stamps(ours, ref):
    assert [w["word"] for w in ours] == [w["word"] for w in ref]
    for a, b in zip(ours, ref):
        assert abs(a["start"] - b["start"]) <= TIME_ATOL, (a, b)
        assert abs(a["end"] - b["end"]) <= TIME_ATOL, (a, b)


@pytest.mark.parametrize("mode", ["accurate", "fast"])
@pytest.mark.parametrize("clip", ["english_01.wav", "chinese_02.wav"])
def test_timestamps_match_jax(port, jax_app, monkeypatch, mode, clip):
    monkeypatch.setenv("ASR_TIMESTAMP_MODE", mode)
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/transcriptions", _wav(clip),
        return_timestamps="true")
    ours, ref = json.loads(raw), json.loads(jraw)
    assert st == 200 and ours.keys() == ref.keys() == {"text", "language",
                                                       "timestamps"}
    assert (ours["text"], ours["language"]) == (ref["text"], ref["language"])
    _same_stamps(ours["timestamps"], ref["timestamps"])
    assert sub.aligner_loaded() == (mode == "accurate")


def test_timestamps_of_a_long_upload_match_jax(port, jax_app):
    """45 s: two segments, each aligned on its own and offset by its
    start."""
    audio = np.concatenate([_audio(n) for n in (
        "english_01.wav", "english_02.wav", "hindi_02.wav",
        "japanese_02.wav")])[:45 * 16000]
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/transcriptions", encode_wav(audio, 16000),
        return_timestamps="true")
    ours, ref = json.loads(raw), json.loads(jraw)
    assert st == 200 and ours["text"] == ref["text"]
    _same_stamps(ours["timestamps"], ref["timestamps"])
    assert ours["timestamps"][-1]["start"] > 30.0


def test_no_timestamps_key_without_the_flag(port, jax_app):
    (st, _, raw), (_, _, jraw) = post_both(
        port, jax_app, "/v1/audio/transcriptions", _wav("english_02.wav"),
        return_timestamps="false")
    assert st == 200 and json.loads(raw) == json.loads(jraw)
    assert "timestamps" not in json.loads(raw)


# -- /health's aligner state and the retry backoff ------------------------------------------

def test_health_aligner_states_and_backoff(port, jax_app, monkeypatch):
    """The same requests to both servers move ``aligner`` through the same
    states: not_loaded; a failed load for timestamps → unavailable_retrying,
    with no new attempt inside the backoff window and one after it;
    then loaded."""
    calls = {"port": 0, "jax": 0}

    def failing(name):
        def load(*a, **k):
            calls[name] += 1
            raise RuntimeError("no aligner checkpoint")
        return load

    def jax_health():
        async def go(client):
            return (await (await client.get("/health")).json())["aligner"]
        return jax_app(go)

    def states():
        return _health(port)["aligner"], jax_health()

    def post_ts():
        post_both(port, jax_app, "/v1/audio/transcriptions",
                  _wav("thai_02.wav"), return_timestamps="true")

    assert states() == ("not_loaded", "not_loaded")
    with monkeypatch.context() as mp:
        mp.setattr(sub, "load_aligner", failing("port"))
        mp.setattr(jsub, "load_aligner", failing("jax"))
        post_ts()
        assert calls == {"port": 1, "jax": 1}
        assert states() == ("unavailable_retrying", "unavailable_retrying")
        post_ts()                                 # inside the window
        assert calls == {"port": 1, "jax": 1}
        port.aligner_retry_at = 0.0               # the window expired
        jserver._aligner_retry_at = 0.0
        post_ts()
        assert calls == {"port": 2, "jax": 2}
    port.aligner_retry_at = 0.0
    jserver._aligner_retry_at = 0.0
    post_ts()
    assert states() == ("loaded", "loaded")


def test_backoff_window_is_asr_aligner_retry_s(port, monkeypatch):
    import time
    monkeypatch.setenv("ASR_ALIGNER_RETRY_S", "1000")

    def failing(*a, **k):
        raise FileNotFoundError("none")

    monkeypatch.setattr(sub, "load_aligner", failing)
    t0 = time.monotonic()
    port.try_load_aligner()
    assert 999 <= port.aligner_retry_at - t0 <= 1001
    port.aligner_retry_at = 0.0


def test_device_work_runs_on_the_device_thread(port, monkeypatch):
    """The aligner's load and every alignment run on the queue's one
    device thread, not on the request's."""
    seen = []
    load, align = sub.load_aligner, sub.align_audio

    def spy(fn, name):
        def wrapped(*a, **k):
            seen.append((name, threading.current_thread().name))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sub, "load_aligner", spy(load, "load"))
    monkeypatch.setattr(sub, "align_audio", spy(align, "align"))
    post_port(port, "/v1/audio/subtitles", _wav("thai_01.wav"))
    post_port(port, "/v1/audio/transcriptions", _wav("thai_01.wav"),
              return_timestamps="true")
    assert [n for n, _ in seen] == ["load", "align", "align"]
    assert {t for _, t in seen} == {"device-dispatch"}


def test_manager_stop_unloads_the_aligner(engine):
    sub.load_aligner("cpu")
    assert sub.aligner_loaded()
    manager = ModelManager(engine)
    manager.start()
    manager.stop()
    assert not sub.aligner_loaded()

