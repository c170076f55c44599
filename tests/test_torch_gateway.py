"""Gateway mode on the CPU: the port's gateway (``serving/gateway.py``) and
worker (``serving/worker.py``), real worker processes spawned with
``--device cpu`` on ``e2e/data/trained_ckpt`` in f32.

- A counterpart of every case of ``tests/test_gateway_worker.py`` (the
  route tables, ``/health`` with no worker, a real worker spawned, a
  respawn after the worker dies, the fleet from the environment and its
  routing, a two-worker fleet, a startup crash that fails fast).
- Parity: the port's gateway in front of the port's worker against JAX's
  gateway in front of JAX's worker: the same upload answers, SRTs, SSE
  events, WS messages, ``/health`` keys with no worker and error bodies.
- A stub worker on the standard library: the SSE and WS relays pass its
  bytes through and end a broken stream with ``SSE_STREAM_ERROR``; an
  ``Insufficient HBM`` snapshot refuses the spawn.
- A fresh interpreter: importing the gateway loads no ``torch``; a worker
  on the default device (``cuda``) fails here and the gateway answers 503
  ``WORKER_STARTUP_FAILED``: no CPU fallback.
Every wait is bounded.
"""
import asyncio
import contextlib
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.serving import gateway as gw
from qwen3_asr_tpu_torch.serving import wsproto
from qwen3_asr_tpu_torch.serving.server import _Handler
from qwen3_asr_tpu_torch.serving.worker import WorkerHandler

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "e2e", "data")
CKPT = os.path.join(DATA, "trained_ckpt")
TICK = 14400                      # the WS session's 450 ms of s16le PCM
WAIT = 60                         # every wait's bound, in seconds


def _wav(name: str) -> bytes:
    with open(os.path.join(DATA, "real", name), "rb") as f:
        return f.read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    """What the workers inherit: the checkpoint, no warmup, few threads,
    the checkpoint as the forced aligner."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {"MODEL_ID": CKPT, "SKIP_WARMUP": "true",
                     "REQUEST_TIMEOUT": "120", "WORKER_STARTUP_TIMEOUT": "60",
                     "FORCED_ALIGNER_ID": CKPT, "OMP_NUM_THREADS": "2",
                     "JAX_PLATFORMS": "cpu", "IDLE_TIMEOUT": "120"}.items():
            mp.setenv(k, v)
        mp.delenv("WORKER_PORTS", raising=False)
        mp.delenv("WORKER_HOSTS", raising=False)
        mp.delenv("WORKER_DEVICES", raising=False)
        yield


@contextlib.contextmanager
def gateway(fleet):
    """The port's gateway over ``fleet`` on a free port: its base URL."""
    server = gw.build_gateway(fleet)
    fleet.start_watchdog()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        fleet.stop_watchdog()
        fleet.kill_all()
        for s in fleet.supervisors:
            if s.proc is not None and s.proc.poll() is None:
                s.proc.kill()


@contextlib.contextmanager
def jax_gateway(supervisor):
    """JAX's aiohttp gateway over ``supervisor`` on a loop of its own."""
    from aiohttp import web
    from qwen3_asr_tpu.serving import gateway as jgw
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(jgw.build_app(supervisor))
    loop.run_until_complete(runner.setup())
    port = _free_port()
    loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(WAIT)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(WAIT)
        if supervisor.proc is not None and supervisor.proc.poll() is None:
            supervisor.proc.kill()
        loop.close()


def without_request_id(raw: bytes) -> dict:
    """An error body without the request id that JAX's error context adds
    (the port sends the id as the ``X-Request-ID`` header only)."""
    body = json.loads(raw)
    ctx = {k: v for k, v in body.pop("context", {}).items()
           if k != "requestId"}
    return {**body, **({"context": ctx} if ctx else {})}


def post(base, path, data=b"", fields=None, headers=None, filename="a.wav"):
    """(status, headers, body) of a multipart upload."""
    ctype, body = gw.multipart(fields or {}, data, filename)
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT * 4)
    try:
        conn.request("POST", path, body=body, headers={
            "Content-Type": ctype, **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def get_json(base, path="/health"):
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def transcribe(base, name="english_02.wav", fields=None, tries=4):
    """An upload through the gateway, following the documented 503 'still
    starting' contract as JAX's test does."""
    for _ in range(tries):
        status, headers, body = post(base, "/v1/audio/transcriptions",
                                     _wav(name), fields)
        if status != 503 or b"still starting" not in body:
            break
    assert status == 200, body
    return json.loads(body)


def ws_session(base, query="?use_server_vad=false", name="english_02.wav"):
    """A WS session's messages: the clip in 450 ms messages, a flush, a
    reset; up to the reset's answer."""
    audio, _ = decode_audio(_wav(name))
    pcm = (audio.clip(-1, 1) * 32767).astype("<i2").tobytes()
    ws = wsproto.connect(base.replace("http", "ws") + "/ws/transcribe"
                         + query, timeout=WAIT * 4)
    got = [ws.receive_json(timeout=WAIT * 4)]
    for i in range(0, len(pcm), TICK):
        ws.send_bytes(pcm[i:i + TICK])
    ws.send_json({"action": "flush"})
    ws.send_json({"action": "reset"})
    while got[-1] != {"status": "buffer_reset"}:
        got.append(ws.receive_json(timeout=WAIT * 4))
    ws.close()
    return got


# -- routes ------------------------------------------------------------------------

def _route_table(cls):
    handler = object.__new__(cls)
    return {(m, p) for m in ("GET", "POST") for p in handler.routes(m)}


PUBLIC = ("/health", "/v1/audio/transcriptions", "/v1/audio/translations",
          "/v1/audio/subtitles", "/v1/audio/transcriptions/stream",
          "/ws/transcribe", "/docs", "/openapi.json")


def test_server_routes():
    paths = {p for _, p in _route_table(_Handler)}
    assert set(PUBLIC) <= paths


def test_worker_routes():
    assert _route_table(WorkerHandler) == {
        ("GET", "/health"), ("GET", "/ws/transcribe"),
        ("POST", "/transcribe"), ("POST", "/subtitles"),
        ("POST", "/translate"), ("POST", "/transcribe/stream")}


def test_gateway_routes():
    assert {p for _, p in _route_table(gw._GatewayHandler)} == set(PUBLIC)


def test_gateway_health_no_worker():
    """Without a live worker: ``worker_alive`` and ``model_loaded`` false,
    and the same keys and values as JAX's gateway."""
    port = _free_port()
    with gateway(gw.WorkerFleet([gw.WorkerSupervisor(port=port)])) as base:
        status, body = get_json(base)
    assert status == 200
    assert body == {"status": "ok", "mode": "gateway", "worker_alive": False,
                    "model_loaded": False, "model_id": None}
    from qwen3_asr_tpu.serving.gateway import WorkerSupervisor
    with jax_gateway(WorkerSupervisor(port=port)) as base:
        assert get_json(base) == (status, body)


def test_gateway_openapi_and_docs_equal_jax():
    from qwen3_asr_tpu.serving.gateway import WorkerSupervisor
    port = _free_port()
    with gateway(gw.WorkerFleet([gw.WorkerSupervisor(port=port)])) as ours, \
            jax_gateway(WorkerSupervisor(port=port)) as ref:
        from qwen3_asr_tpu.serving.schemas import API_DESCRIPTION as jax_desc
        from tests.test_torch_contract import port_description
        status, want = get_json(ref, "/openapi.json")
        want["info"]["description"] = port_description(jax_desc)
        assert get_json(ours, "/openapi.json") == (status, want)
        pages = []
        for base in (ours, ref):
            host, p = base.split("//")[1].split(":")
            conn = http.client.HTTPConnection(host, int(p), timeout=WAIT)
            conn.request("GET", "/docs")
            pages.append(conn.getresponse().read())
            conn.close()
        assert pages[0] == pages[1]


# -- a real worker -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gw():
    """JAX's gateway over JAX's worker on the CPU; the worker starts
    spawning at once, while the port's tests run."""
    from qwen3_asr_tpu.serving.gateway import WorkerSupervisor
    sup = WorkerSupervisor(port=_free_port())
    with jax_gateway(sup) as base:
        def spawn():
            try:
                post(base, "/v1/audio/translations", b"")
            except OSError:
                pass
        threading.Thread(target=spawn, daemon=True).start()
        yield base


@pytest.fixture(scope="module")
def port_gw(tmp_path_factory, jax_gw):
    """The port's gateway over one managed worker on the CPU, its watchdog
    every 0.2 s (shared by the tests below; the respawn and idle-kill tests
    leave it alive again)."""
    log_path = str(tmp_path_factory.mktemp("worker") / "worker.log")
    sup = gw.WorkerSupervisor(port=_free_port(), device="cpu",
                              log_path=log_path, watchdog_interval=0.2)
    with gateway(gw.WorkerFleet([sup])) as base:
        yield base, sup, log_path


def test_gateway_spawns_real_worker(port_gw):
    """The process split: the gateway spawns a worker, proxies an upload
    (its X-Request-ID through to the worker's log lines), merges /health,
    and pumps a WS session."""
    base, sup, log_path = port_gw
    body = transcribe(base, fields={"language": "en"})
    assert body["language"] == "en" and body["text"]
    req_id = str(uuid.uuid4())
    status, headers, _ = post(base, "/v1/audio/transcriptions",
                              _wav("english_01.wav"),
                              headers={"X-Request-ID": req_id})
    assert status == 200 and headers["X-Request-ID"] == req_id
    with open(log_path, encoding="utf-8") as f:
        assert req_id in f.read()
    status, health = get_json(base)
    assert health["worker_alive"] is True and health["model_loaded"] is True
    assert health["mode"] == "gateway" and health["device"] == "cpu"
    ws = wsproto.connect(base.replace("http", "ws") + "/ws/transcribe",
                         timeout=WAIT)
    assert ws.receive_json(timeout=WAIT)["status"] == "connected"
    ws.send_json({"action": "flush"})
    assert ws.receive_json(timeout=WAIT)["is_final"] is True
    ws.close()
    assert ws.receive(timeout=WAIT).kind == "close"


def test_parity_uploads(port_gw, jax_gw):
    base = port_gw[0]
    for name, fields in (("english_02.wav", {}),
                         ("chinese_01.wav", {"language": "zh"}),
                         ("japanese_02.wav", {"language": "auto"})):
        assert transcribe(base, name, fields) == transcribe(jax_gw, name,
                                                            fields)


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_parity_subtitles(port_gw, jax_gw, mode):
    got = [post(b, "/v1/audio/subtitles", _wav("english_01.wav"),
                {"mode": mode}) for b in (port_gw[0], jax_gw)]
    assert [g[0] for g in got] == [200, 200]
    assert got[0][2] == got[1][2] and got[0][2].startswith(b"1\n")
    for g in got:
        assert 'filename="subtitles.srt"' in g[1]["Content-Disposition"]


def test_parity_sse(port_gw, jax_gw):
    got = [post(b, "/v1/audio/transcriptions/stream",
                _wav("english_02.wav")) for b in (port_gw[0], jax_gw)]
    assert [g[0] for g in got] == [200, 200]
    events = [[json.loads(e[len("data: "):]) for e in g[2].decode().split(
        "\n\n") if e] for g in got]
    assert events[0] == events[1]
    assert events[0][-1] == {"done": True} and len(events[0]) >= 2
    assert got[0][1]["Content-Type"] == "text/event-stream"


def test_parity_ws(port_gw, jax_gw):
    ours, ref = ws_session(port_gw[0]), ws_session(jax_gw)
    assert ours == ref
    assert any(m.get("is_partial") for m in ours)
    assert sum(1 for m in ours if m.get("is_final")) == 1


@pytest.mark.parametrize("path,data,fields", [
    ("/v1/audio/subtitles", b"x", {"mode": "bad"}),
    ("/v1/audio/translations", b"", {}),
    ("/v1/audio/subtitles", b"", {}),
    ("/v1/audio/transcriptions", b"not audio", {})],
    ids=["invalid_mode", "empty_translate", "empty_subtitles",
         "undecodable"])
def test_parity_worker_errors_pass_through(port_gw, jax_gw, path, data,
                                           fields):
    """A worker's structured 4xx reaches the client with its status and
    body (the worker's 400s: INVALID_MODE, EMPTY_AUDIO; its 422)."""
    ours = post(port_gw[0], path, data, fields)
    ref = post(jax_gw, path, data, fields)
    assert ours[0] == ref[0] and ours[0] in (400, 422)
    assert json.loads(ours[2]) == without_request_id(ref[2])


def test_parity_startup_failure_body():
    """A worker that dies at start (an empty MODEL_ID fails its
    validate_env): the same 503 WORKER_STARTUP_FAILED body from both."""
    from qwen3_asr_tpu.serving.gateway import WorkerSupervisor
    bodies = [None, None]
    with gateway(gw.WorkerFleet([gw.WorkerSupervisor(
            port=_free_port(), device="cpu",
            spawn_env={"MODEL_ID": ""})])) as ours, \
            jax_gateway(WorkerSupervisor(port=_free_port(),
                                         spawn_env={"MODEL_ID": ""})) as ref:
        def send(i, base):
            bodies[i] = post(base, "/v1/audio/transcriptions",
                             _wav("english_01.wav"))
        threads = [threading.Thread(target=send, args=a)
                   for a in ((0, ours), (1, ref))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    assert [b[0] for b in bodies] == [503, 503]
    assert json.loads(bodies[0][2]) == without_request_id(bodies[1][2]) == {
        "code": "WORKER_STARTUP_FAILED",
        "message": "Worker startup failed: worker failed to become ready",
        "statusCode": 503}


def test_gateway_respawns_dead_worker(port_gw):
    """A killed worker is seen dead (Popen.poll) and respawned by the next
    request."""
    base, sup, _ = port_gw
    transcribe(base, "english_01.wav")
    first = sup.proc.pid
    sup.proc.kill()
    sup.proc.wait(timeout=WAIT)
    assert not sup.alive()
    transcribe(base, "english_01.wav")
    assert sup.alive() and sup.proc.pid != first


def test_idle_kill_and_respawn(port_gw):
    """IDLE_TIMEOUT (1 s here) with the watchdog every 0.2 s: the idle
    worker is killed (its process reaped) and the next request respawns
    it."""
    base, sup, _ = port_gw
    transcribe(base, "english_01.wav")
    proc = sup.proc
    sup.idle_timeout = 1
    try:
        deadline = time.time() + WAIT
        while (sup.alive() or proc.poll() is None) \
                and time.time() < deadline:
            time.sleep(0.1)
    finally:
        sup.idle_timeout = 120
    assert not sup.alive() and proc.poll() is not None
    assert get_json(base)[1]["worker_alive"] is False
    transcribe(base, "english_01.wav")
    assert sup.alive() and sup.proc.pid != proc.pid


# -- the fleet ---------------------------------------------------------------------

def test_fleet_from_env(monkeypatch):
    """WORKER_PORTS spawns managed workers (a card each, in order, through
    CUDA_VISIBLE_DEVICES); WORKER_HOSTS appends external workers; unset,
    one managed local worker; the gateway's device goes to each."""
    fleet = gw.WorkerFleet.from_env()
    assert len(fleet.supervisors) == 1 and fleet.supervisors[0].managed
    assert fleet.supervisors[0].spawn_env == {}
    assert fleet.supervisors[0].device == "cuda"
    monkeypatch.setenv("WORKER_PORTS", "18401,18402")
    monkeypatch.setenv("WORKER_DEVICES", "0,1")
    monkeypatch.setenv("WORKER_HOSTS", "10.9.9.9:9001")
    sups = gw.WorkerFleet.from_env(device="cpu").supervisors
    assert [s.port for s in sups] == [18401, 18402, 9001]
    assert [s.managed for s in sups] == [True, True, False]
    assert sups[0].spawn_env == {"CUDA_VISIBLE_DEVICES": "0"}
    assert sups[1].spawn_env == {"CUDA_VISIBLE_DEVICES": "1"}
    assert sups[2].host == "10.9.9.9" and sups[2].spawn_env == {}
    assert {s.device for s in sups} == {"cpu"}


def test_fleet_choose_least_outstanding():
    """The live worker with the fewest in flight; a dormant managed worker
    pre-warmed when every live one is busy."""
    a, b, c = (gw.WorkerSupervisor(port=18403 + i, index=i)
               for i in range(3))
    fleet = gw.WorkerFleet([a, b, c])
    assert fleet.choose() is a          # none live: the first managed one

    class Live:
        @staticmethod
        def poll():
            return None
    for s in (a, b):
        s._ready, s.proc = True, Live()
    a.inflight, b.inflight = 2, 1
    prewarmed, started = [], threading.Event()

    def fake_prewarm(sup):
        prewarmed.append(sup)
        started.set()
    fleet._prewarm = fake_prewarm
    assert fleet.choose() is b          # least outstanding
    assert started.wait(WAIT)
    assert prewarmed == [c]             # all live busy: warm the dormant
    b.inflight = 0
    prewarmed.clear()
    started.clear()
    assert fleet.choose() is b
    assert not started.wait(0.5)
    assert prewarmed == []              # someone idle: no pre-warm
    a.inflight = 0
    picks = {fleet.choose() for _ in range(4)}
    assert picks == {a, b}              # ties: round-robin


def test_gateway_two_worker_fleet(tmp_path):
    """Two managed workers: the first request spawns and is served by
    worker 0 while worker 1 warms; /health lists both; worker 0 killed, the
    live worker 1 answers (no respawn needed); WS sticks to the survivor.
    Each worker serves at least one request."""
    s0, s1 = (gw.WorkerSupervisor(port=_free_port(), index=i, device="cpu",
                                  log_path=str(tmp_path / f"w{i}.log"))
              for i in range(2))
    fleet = gw.WorkerFleet([s0, s1])
    with gateway(fleet) as base:
        warm = threading.Thread(target=s1.ensure, daemon=True)
        warm.start()                       # the pre-warm path, driven
        body = transcribe(base, fields={"language": "en"})
        assert s0.served == 1 and s1.served == 0
        warm.join(WAIT)
        assert s1.alive()
        status, health = get_json(base)
        assert len(health["workers"]) == 2
        assert all(w["alive"] and w["model_loaded"]
                   for w in health["workers"])
        s0.proc.kill()
        s0.proc.wait(timeout=WAIT)
        body2 = transcribe(base, fields={"language": "en"})
        assert s1.served >= 1 and body2 == body
        ws = wsproto.connect(base.replace("http", "ws") + "/ws/transcribe",
                             timeout=WAIT)
        assert ws.receive_json(timeout=WAIT)["status"] == "connected"
        ws.send_json({"action": "flush"})
        assert ws.receive_json(timeout=WAIT)["is_final"] is True
        ws.close()
        assert s1.served >= 2 and not s0.alive()


def test_gateway_startup_crash_fails_fast():
    """A worker that dies during startup fails ensure() as soon as it
    exits, not after WORKER_STARTUP_TIMEOUT."""
    sup = gw.WorkerSupervisor(port=_free_port(), device="cpu",
                              spawn_env={"MODEL_ID": ""})
    try:
        t0 = time.time()
        with pytest.raises(gw.WorkerStartupError, match="failed to become"):
            sup.ensure()
        assert time.time() - t0 < 45, "polled a dead worker too long"
        assert sup.proc is None
    finally:
        if sup.proc is not None and sup.proc.poll() is None:
            sup.proc.kill()


# -- a stub worker: the relays byte for byte ------------------------------------------

SSE_LINES = [b'data: {"text": "a", "is_final": false}\n', b"\n",
             b'data: {"text": "ab \\u00e9", "is_final": false, '
             b'"chunk_index": 1}\n', b"\n",
             b'data: {"text": "an event whose blank line never came"}\n']
WS_FRAMES = [("text", '{"status": "connected", "sample_rate": 16000}'),
             ("text", '{"text": "x",  "is_partial": true}'),
             ("binary", bytes(range(256)) * 3),
             ("text", "é中")]


class _Stub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    health = {"status": "ok", "model_loaded": True, "model_id": "stub",
              "hbm_used_mb": 1000, "hbm_limit_mb": 81000}

    def log_message(self, *args):
        pass

    def do_GET(self):
        if self.path.startswith("/ws/transcribe"):
            ws = wsproto.upgrade(self)
            for kind, data in WS_FRAMES:
                (ws.send_text if kind == "text" else ws.send_bytes)(data)
            self.connection.shutdown(socket.SHUT_RDWR)   # breaks off
            return
        data = json.dumps(self.health).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for line in SSE_LINES:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
            self.wfile.flush()
        self.wfile.write(b"5\r\nda")        # a chunk cut short, then gone
        self.wfile.flush()
        self.close_connection = True


@pytest.fixture
def stub():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()


def test_sse_relay_passes_bytes_and_ends_with_stream_error(stub):
    sup = gw.WorkerSupervisor(port=stub, managed=False)
    with gateway(gw.WorkerFleet([sup])) as base:
        status, headers, body = post(base,
                                     "/v1/audio/transcriptions/stream",
                                     b"RIFF")
    assert status == 200 and headers["Content-Type"] == "text/event-stream"
    relayed = b"".join(SSE_LINES)
    assert body.startswith(relayed)
    tail = body[len(relayed):].decode()
    assert tail.startswith("data: ")
    error = json.loads(tail[len("data: "):])
    assert error["code"] == "SSE_STREAM_ERROR"
    assert error["statusCode"] == 502
    assert error["message"].startswith("worker stream interrupted")
    assert tail.endswith("\n\n") and sup.inflight == 0


def test_ws_relay_passes_frames_and_ends(stub):
    sup = gw.WorkerSupervisor(port=stub, managed=False)
    with gateway(gw.WorkerFleet([sup])) as base:
        ws = wsproto.connect(base.replace("http", "ws")
                             + "/ws/transcribe?sample_rate=8000",
                             timeout=WAIT)
        got = []
        while True:
            msg = ws.receive(timeout=WAIT)
            if msg.kind == "close":
                break
            got.append((msg.kind, msg.data))
        assert got == WS_FRAMES
        deadline = time.time() + WAIT
        while sup.ws_sessions and time.time() < deadline:
            time.sleep(0.05)
        assert sup.ws_sessions == 0 and sup.served == 1


def test_insufficient_hbm_refuses_the_spawn(stub):
    """The last /health snapshot leaves 2000 MB of the 3500 needed: no
    process is started, and the gateway answers 503."""
    sup = gw.WorkerSupervisor(port=_free_port(), device="cpu")
    sup._last_health = {"hbm_used_mb": 79000, "hbm_limit_mb": 81000}
    with pytest.raises(gw.WorkerStartupError,
                       match="Insufficient HBM: 2000MB free"):
        sup.ensure()
    assert sup.proc is None
    with gateway(gw.WorkerFleet([sup])) as base:
        status, _, body = post(base, "/v1/audio/transcriptions", b"RIFF")
    assert status == 503
    assert json.loads(body)["message"] == \
        "Worker startup failed: Insufficient HBM: 2000MB free"
    assert sup.proc is None
    # a snapshot with room (a worker's /health on the card) lets it through
    ext = gw.WorkerSupervisor(port=stub, managed=False)
    ext.ensure()
    assert ext._check_hbm_available() == (True, 80000)


def test_ws_startup_failure_is_a_message():
    sup = gw.WorkerSupervisor(port=_free_port(), device="cpu",
                              spawn_env={"MODEL_ID": ""})
    with gateway(gw.WorkerFleet([sup])) as base:
        ws = wsproto.connect(base.replace("http", "ws") + "/ws/transcribe",
                             timeout=WAIT)
        msg = ws.receive_json(timeout=WAIT)
        assert msg == {"code": "WORKER_STARTUP_FAILED",
                       "message": "Worker startup failed: worker failed to "
                                  "become ready", "statusCode": 503}
        assert ws.receive(timeout=WAIT).kind == "close"


# -- a fresh interpreter ----------------------------------------------------------------

def test_gateway_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, qwen3_asr_tpu_torch.serving.gateway; "
         "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_worker_fails_without_a_card(tmp_path):
    """No CPU fallback: a gateway (its own process) in front of a worker on
    the default device answers 503 WORKER_STARTUP_FAILED within the bound,
    the worker having exited on the missing card."""
    port = _free_port()
    env = {**os.environ, "GATEWAY_MODE": "true",
           "WORKER_PORT": str(_free_port())}
    with open(tmp_path / "gateway.log", "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "qwen3_asr_tpu_torch.serving.gateway",
             "--host", "127.0.0.1", "--port", str(port)], cwd=ROOT, env=env,
            stdout=out, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + WAIT
        while time.time() < deadline:
            try:
                assert get_json(base)[1]["worker_alive"] is False
                break
            except OSError:
                time.sleep(0.2)
        t0 = time.time()
        status, _, body = post(base, "/v1/audio/transcriptions",
                               _wav("english_01.wav"))
        assert time.time() - t0 < WAIT
        assert status == 503
        assert json.loads(body) == {
            "code": "WORKER_STARTUP_FAILED",
            "message": "Worker startup failed: worker failed to become "
                       "ready", "statusCode": 503}
    finally:
        proc.terminate()
        proc.wait(WAIT)
    # the worker (its output is the gateway's) exited on the missing card
    log = (tmp_path / "gateway.log").read_text()
    assert "no CUDA device is available" in log
    assert "Worker process exited before becoming ready" in log
