"""Gateway process: the public API in front of supervised worker processes.

Counterpart of ``qwen3_asr_tpu/serving/gateway.py`` on the standard
library (``ThreadingHTTPServer``, ``http.client``, ``subprocess``, and a
thread where JAX runs an asyncio task). It imports neither ``torch`` nor
``numpy``: a CUDA context in the gateway would hold card memory for its
whole life, which the idle kill exists to give back.

- ``WorkerSupervisor`` spawns ``python -m
  qwen3_asr_tpu_torch.serving.worker`` (``--device`` and ``--dtype`` as the
  gateway's), polls
  its ``/health`` once a second up to ``WORKER_STARTUP_TIMEOUT`` (120 s),
  fails fast when the process dies during startup, leaves a still-starting
  worker running (the request answers 503, the next one waits on the same
  process), kills a worker idle for ``IDLE_TIMEOUT`` seconds with nothing
  in flight (terminate, 10 s, kill, reap) and respawns it on the next
  request. Before a spawn it refuses when the last ``/health`` snapshot
  (``hbm_used_mb``, ``hbm_limit_mb``) leaves less than ``MIN_FREE_HBM_MB``
  (3500) free; it never asks the card itself. Its watchdog checks every
  ``watchdog_interval`` seconds (30).
- ``WorkerFleet`` routes over ``WORKER_PORTS`` (managed local workers; with
  ``WORKER_DEVICES``, worker i gets ``CUDA_VISIBLE_DEVICES`` = its entry)
  and ``WORKER_HOSTS`` (external workers, never spawned or killed): the
  live worker with the fewest requests and WS sessions in flight, ties
  round-robin; a dormant managed worker is pre-warmed when every live one
  is busy; a WS session stays on the worker chosen at connect. Unset: one
  managed worker on ``WORKER_HOST``:``WORKER_PORT`` (127.0.0.1:8001).
- The routes: uploads re-sent to the worker as multipart with JAX's field
  defaults, a structured worker error passed through with its status,
  ``X-Request-ID`` forwarded; SSE relayed line by line, one flush an event,
  a broken stream ended by an ``SSE_STREAM_ERROR`` event; WS pumped by two
  threads (either side's end ends both), the worker's greeting first, with
  the session's ``request_id``, ``use_server_vad`` and ``sample_rate``;
  ``/health`` merged from the first answering worker (``workers`` for a
  fleet of more than one); ``/openapi.json`` and ``/docs`` as the server's.
  A worker that cannot start answers 503 ``WORKER_STARTUP_FAILED`` (a WS
  session gets it as a message, or ``WORKER_CONNECTION_FAILED``).

Run: ``GATEWAY_MODE=true MODEL_ID=... python -m
qwen3_asr_tpu_torch.serving.gateway [--port 8000] [--device cuda]
[--dtype float32]``;
``IDLE_TIMEOUT=0`` spawns the workers at start and never kills them.
"""
from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid
from http.server import ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlsplit

from .. import config
from ..utils.logging import reset_request_id, set_request_id, setup_logging
from .http import DOCS_HTML, Answered, JsonHandler, build_openapi
from .meta import API_TITLE, API_VERSION, route_metadata
from .schemas import API_DESCRIPTION, API_TAGS
from .wsproto import WebSocket, connect, upgrade

log = logging.getLogger(__name__)

WORKER_MODULE = "qwen3_asr_tpu_torch.serving.worker"
POLL_S = 1.0                  # between /health polls of a starting worker


def _env_int(name: str, default: str) -> int:
    return int(os.getenv(name, default))


class WorkerStartupError(RuntimeError):
    """Worker could not be spawned or never became ready."""


def _get_json(host: str, port: int, path: str, timeout: float,
              headers: Optional[dict] = None) -> Optional[dict]:
    """A 200 answer's JSON body, or None for any other answer or failure."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        body = resp.read()
        return json.loads(body) if resp.status == 200 else None
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        conn.close()


class WorkerSupervisor:
    """Owns one worker: spawn (managed), readiness poll, idle kill.

    ``managed=False`` marks an external worker (another host): it is
    health-checked and routed to but never spawned or killed from here.
    ``log_path`` appends the worker's stdout and stderr to a file (else it
    inherits the gateway's)."""

    def __init__(self, host: Optional[str] = None, port: Optional[int] = None,
                 *, managed: bool = True, spawn_env: Optional[dict] = None,
                 index: int = 0, device: str = "cuda",
                 dtype: Optional[str] = None,
                 watchdog_interval: float = 30.0,
                 log_path: Optional[str] = None):
        self.host = host or os.getenv("WORKER_HOST", "127.0.0.1")
        self.port = port or _env_int("WORKER_PORT", "8001")
        self.managed = managed
        self.spawn_env = dict(spawn_env or {})
        self.index = index
        self.device, self.dtype = device, dtype
        self.watchdog_interval = watchdog_interval
        self.log_path = log_path
        self.idle_timeout = _env_int("IDLE_TIMEOUT", "120")
        self.min_free_mb = _env_int("MIN_FREE_HBM_MB", "3500")
        self.proc: Optional[subprocess.Popen] = None
        self.last_used = time.time()
        self.inflight = 0     # proxied requests awaiting the worker
        self.ws_sessions = 0  # live WS pumps (routing load, not idle
                              # activity: frames are)
        self.served = 0       # requests routed here
        self._lock = threading.Lock()      # a spawn or a kill at a time
        self._counts = threading.Lock()    # inflight, ws_sessions, served
        self._last_health: dict = {}
        self._ready = False   # /health answered since the last (re)spawn

    def url(self, path: str) -> str:
        return f"http://{self.host}:{self.port}{path}"

    def alive(self) -> bool:
        if not self.managed:
            return self._ready
        return self.proc is not None and self.proc.poll() is None

    def add(self, name: str, n: int) -> None:
        """Move ``inflight``, ``ws_sessions`` or ``served`` by ``n``."""
        with self._counts:
            setattr(self, name, getattr(self, name) + n)

    def _check_hbm_available(self) -> tuple:
        """Card headroom from the last worker health snapshot: the gateway
        never opens the card itself."""
        used = self._last_health.get("hbm_used_mb")
        limit = self._last_health.get("hbm_limit_mb")
        if used is None or limit is None or not limit:
            return True, -1     # cannot check: proceed
        free = limit - used
        return free >= self.min_free_mb, free

    def health(self, headers: Optional[dict] = None) -> Optional[dict]:
        return _get_json(self.host, self.port, "/health", 3, headers)

    def _spawn(self) -> subprocess.Popen:
        env = {**os.environ, **self.spawn_env}
        cmd = [sys.executable, "-m", WORKER_MODULE, "--host", self.host,
               "--port", str(self.port), "--device", self.device]
        if self.dtype:
            cmd += ["--dtype", self.dtype]
        if self.log_path is None:
            return subprocess.Popen(cmd, env=env)
        with open(self.log_path, "ab") as out:
            return subprocess.Popen(cmd, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)

    def ensure(self) -> None:
        """The worker up and answering ``/health``, spawning it if need be;
        raises WorkerStartupError."""
        with self._lock:
            if not self.managed:
                body = self.health()
                if body is not None:
                    self._last_health, self._ready = body, True
                    self.last_used = time.time()
                    return
                self._ready = False
                raise WorkerStartupError(
                    f"external worker {self.host}:{self.port} unreachable")
            if not self.alive():
                if self.proc is not None:
                    # died on its own (crash, OOM): its snapshot describes
                    # memory freed with it and must not veto the respawn
                    self.proc = None
                    self._last_health = {}
                self._ready = False
                ok, free_mb = self._check_hbm_available()
                if not ok:
                    log.error("Not enough HBM to start worker: %sMB free, "
                              "need ~%sMB", free_mb, self.min_free_mb)
                    raise WorkerStartupError(
                        f"Insufficient HBM: {free_mb}MB free")
                log.info("Starting worker process %d on :%d... (HBM free: "
                         "%sMB)", self.index, self.port, free_mb)
                self.proc = self._spawn()
            if not self._ready:
                deadline = time.time() + _env_int("WORKER_STARTUP_TIMEOUT",
                                                  "120")
                while time.time() < deadline:
                    time.sleep(POLL_S)
                    if self.proc is not None and not self.alive():
                        break       # crashed at startup: fail fast
                    body = self.health()
                    if body is not None:
                        self._last_health, self._ready = body, True
                        log.info("Worker process ready")
                        break
                if not self._ready:
                    if self.alive():
                        # still loading: leave it running, so the next
                        # request waits on this process, not a new one
                        log.error("Worker not ready within "
                                  "WORKER_STARTUP_TIMEOUT; still starting")
                        raise WorkerStartupError(
                            "worker still starting (model load/compile in "
                            "progress) — retry shortly")
                    log.error("Worker process exited before becoming ready")
                    self._terminate()
                    raise WorkerStartupError("worker failed to become ready")
            self.last_used = time.time()

    def _terminate(self) -> None:
        """Stop the worker: terminate, wait 10 s, kill, reap."""
        proc, self.proc = self.proc, None
        # the snapshot described that worker's memory: stale once it is gone
        self._last_health = {}
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(5)             # reap: no zombies
            except subprocess.TimeoutExpired:
                log.warning("worker PID %d unreaped after SIGKILL", proc.pid)

    def kill(self, only_if_idle: bool = False) -> None:
        if not self.managed:
            return
        with self._lock:
            if only_if_idle and (
                    self.inflight > 0
                    or time.time() - self.last_used <= self.idle_timeout):
                # an ensure() that held the lock through a slow start has
                # just marked the worker used: leave it to its request
                return
            if self.alive():
                log.info("Killing worker process %d (idle timeout)...",
                         self.index)
                self._terminate()
                log.info("Worker process killed -- RAM reclaimed")

    def watchdog_tick(self) -> None:
        """One check of the idle clock; requests in flight count as
        activity (a long first request must not be killed mid-flight)."""
        if self.idle_timeout <= 0:
            return
        if self.inflight > 0:
            self.last_used = time.time()
            return
        if self.alive() and time.time() - self.last_used > self.idle_timeout:
            self.kill(only_if_idle=True)

    def idle_watchdog(self, stop: threading.Event) -> None:
        while not stop.wait(self.watchdog_interval):
            self.watchdog_tick()


class WorkerFleet:
    """N supervisors and the routing over them. One managed local worker by
    default; ``WORKER_PORTS`` / ``WORKER_HOSTS`` scale it out."""

    def __init__(self, supervisors: List[WorkerSupervisor]):
        if not supervisors:
            raise ValueError("fleet needs at least one supervisor")
        self.supervisors = list(supervisors)
        self._rr = 0               # round-robin tie-break cursor
        self._prewarming: set = set()
        self._route_lock = threading.Lock()
        self._stop = threading.Event()
        self._watchdogs: List[threading.Thread] = []

    @classmethod
    def from_env(cls, device: str = "cuda", **kwargs) -> "WorkerFleet":
        """The fleet the environment names; ``kwargs`` go to every
        supervisor."""
        devices = [d.strip() for d in os.getenv("WORKER_DEVICES",
                                                "").split(",") if d.strip()]

        def dev_env(i: int) -> dict:
            # one card (or a subset) per managed worker
            return ({"CUDA_VISIBLE_DEVICES": devices[i]}
                    if i < len(devices) else {})

        sups: List[WorkerSupervisor] = []
        host = os.getenv("WORKER_HOST", "127.0.0.1")
        for p in os.getenv("WORKER_PORTS", "").split(","):
            if p.strip():
                sups.append(WorkerSupervisor(
                    host, int(p), spawn_env=dev_env(len(sups)),
                    index=len(sups), device=device, **kwargs))
        for spec in os.getenv("WORKER_HOSTS", "").split(","):
            spec = spec.strip()
            if not spec:
                continue
            h, _, port = spec.partition(":")
            sups.append(WorkerSupervisor(h, int(port or "8001"),
                                         managed=False, index=len(sups),
                                         device=device, **kwargs))
        if not sups:
            sups.append(WorkerSupervisor(spawn_env=dev_env(0), device=device,
                                         **kwargs))
        return cls(sups)

    def choose(self) -> WorkerSupervisor:
        """Least outstanding requests over live workers, round-robin on
        ties (concurrent arrivals land before each other's counts move, so
        the tie-break spreads a burst); a not-yet-ready managed worker is
        pre-warmed in the background when every live one is busy. The
        caller still calls ``ensure()``: routing never waits on another
        worker's start."""
        with self._route_lock:
            live = [s for s in self.supervisors if s.alive() and s._ready]
            if not live:
                managed = [s for s in self.supervisors if s.managed]
                return managed[0] if managed else self.supervisors[0]
            self._rr += 1
            n = len(self.supervisors)
            best = min(live, key=lambda s: (s.inflight + s.ws_sessions,
                                            (s.index - self._rr) % n))
            if best.inflight + best.ws_sessions > 0:
                dormant = next(
                    (s for s in self.supervisors
                     if s.managed and not (s.alive() and s._ready)
                     and s.index not in self._prewarming), None)
                if dormant is not None:
                    self._prewarming.add(dormant.index)
                    threading.Thread(target=self._prewarm, args=(dormant,),
                                     name=f"prewarm-{dormant.index}",
                                     daemon=True).start()
            return best

    def _prewarm(self, sup: WorkerSupervisor) -> None:
        """``ensure()`` waits on a still-starting process again, so repeated
        pre-warms converge rather than thrash."""
        try:
            sup.ensure()
            log.info("Pre-warmed worker %d under load", sup.index)
        except Exception as e:
            log.warning("Worker %d pre-warm failed: %s", sup.index, e)
        finally:
            with self._route_lock:
                self._prewarming.discard(sup.index)

    def _each(self, fn, sups) -> list:
        """``fn(s)`` for each supervisor on a thread of its own; their
        exceptions, in order (None for a success)."""
        errors: list = [None] * len(sups)

        def run(i, s):
            try:
                fn(s)
            except Exception as e:
                errors[i] = e
        threads = [threading.Thread(target=run, args=(i, s), daemon=True)
                   for i, s in enumerate(sups)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return errors

    def ensure_all_managed(self) -> None:
        for e in self._each(lambda s: s.ensure(),
                            [s for s in self.supervisors if s.managed]):
            if e is not None:
                raise e

    def kill_all(self) -> None:
        self._each(lambda s: s.kill(), self.supervisors)

    def start_watchdog(self) -> None:
        """One idle watchdog thread a supervisor."""
        self._stop.clear()
        for s in self.supervisors:
            t = threading.Thread(target=s.idle_watchdog, args=(self._stop,),
                                 name=f"worker-watchdog-{s.index}",
                                 daemon=True)
            t.start()
            self._watchdogs.append(t)

    def stop_watchdog(self) -> None:
        self._stop.set()
        for t in self._watchdogs:
            t.join(timeout=10)
        self._watchdogs = []


# -- the routes --------------------------------------------------------------------

def multipart(fields: dict, file_bytes: bytes, filename: str):
    """(content type, body) of a multipart/form-data upload: ``file`` as
    ``audio/wav``, then the fields in order."""
    boundary = uuid.uuid4().hex
    parts = [(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
              f'filename="{filename}"\r\nContent-Type: audio/wav\r\n\r\n'
              ).encode("utf-8") + file_bytes + b"\r\n"]
    for key, value in fields.items():
        parts.append((f'--{boundary}\r\nContent-Disposition: form-data; '
                      f'name="{key}"\r\n\r\n{value}\r\n').encode("utf-8"))
    parts.append(f"--{boundary}--\r\n".encode("ascii"))
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


class _GatewayHandler(JsonHandler):
    server: "GatewayServer"

    def routes(self, method: str) -> dict:
        if method == "GET":
            return {"/health": self._health, "/ws/transcribe": self._ws,
                    "/openapi.json": lambda: self._json(200,
                                                        self.server.openapi),
                    "/docs": lambda: self._send(
                        200, "text/html; charset=utf-8",
                        DOCS_HTML.format(title=API_TITLE).encode("utf-8"))}
        return {
            "/v1/audio/transcriptions": self._proxied(self._transcribe),
            "/v1/audio/translations": self._proxied(self._translate),
            "/v1/audio/subtitles": self._proxied(self._subtitles),
            "/v1/audio/transcriptions/stream": self._proxied(self._stream)}

    def _proxied(self, route):
        """A route that needs a worker: a WorkerStartupError answers 503
        WORKER_STARTUP_FAILED (JAX's ``_worker_failure_middleware``)."""
        def run():
            try:
                route()
            except Answered:
                pass
            except WorkerStartupError as e:
                self._error("WORKER_STARTUP_FAILED",
                            f"Worker startup failed: {e}", 503)
            except (OSError, http.client.HTTPException) as e:
                log.error("Gateway proxy failed | %s: %s", self.path, e)
                self._error("WORKER_ERROR", f"worker request failed: {e}",
                            500)
        return run

    def _forward(self, path: str, defaults: dict):
        """Re-send the public upload to the chosen worker's ``path``:
        (supervisor, connection, response, fields). The supervisor's
        ``inflight`` stays raised until the caller's ``_done``: a stream's
        headers come before its inference, and the idle watchdog must not
        kill the worker in that gap."""
        # the body first: a request refused after it keeps its connection
        fields, file_bytes, filename = self._read_upload()
        sup = self.server.fleet.choose()
        sup.ensure()
        ctype, body = multipart(
            {k: str(fields.get(k, d)) for k, d in defaults.items()},
            file_bytes or b"", filename or "audio.wav")
        conn = http.client.HTTPConnection(
            sup.host, sup.port, timeout=_env_int("REQUEST_TIMEOUT", "300"))
        sup.add("inflight", 1)
        sup.add("served", 1)
        try:
            conn.request("POST", path, body=body, headers={
                "Content-Type": ctype, "Content-Length": str(len(body)),
                "X-Request-ID": self.request_id})
            resp = conn.getresponse()
        except BaseException:
            self._done(sup, conn)
            raise
        sup.last_used = time.time()
        return sup, conn, resp, fields

    @staticmethod
    def _done(sup: WorkerSupervisor, conn) -> None:
        sup.add("inflight", -1)
        sup.last_used = time.time()
        conn.close()

    def _proxy_error(self, resp, path: str) -> None:
        """A worker's structured error with its status; anything else as
        WORKER_ERROR."""
        body = resp.read().decode("utf-8", errors="replace")
        log.error("Gateway proxy error | url=%s status=%d", path, resp.status)
        try:
            worker_error = json.loads(body)
            if isinstance(worker_error, dict) and "code" in worker_error:
                self._json(resp.status, worker_error)
                return
        except ValueError:
            pass
        self._error("WORKER_ERROR", body, resp.status)

    def _transcribe(self):
        t0 = time.time()
        sup, conn, resp, _ = self._forward(
            "/transcribe", {"language": "auto", "return_timestamps": "false"})
        try:
            if resp.status != 200:
                self._proxy_error(resp, "/transcribe")
                return
            body = json.loads(resp.read())
            log.info("Gateway POST /v1/audio/transcriptions | proxied in "
                     "%.2fs", time.time() - t0)
            self._json(200, body)
        finally:
            self._done(sup, conn)

    def _translate(self):
        t0 = time.time()
        sup, conn, resp, fields = self._forward(
            "/translate", {"language": "en", "response_format": "json"})
        try:
            if resp.status != 200:
                self._proxy_error(resp, "/translate")
                return
            log.info("Gateway POST /v1/audio/translations | proxied in "
                     "%.2fs", time.time() - t0)
            data = resp.read()
            if fields.get("response_format", "json").lower() == "srt":
                self._text(data.decode("utf-8"), "translated_subtitles.srt")
            else:
                self._json(200, json.loads(data))
        finally:
            self._done(sup, conn)

    def _subtitles(self):
        t0 = time.time()
        sup, conn, resp, _ = self._forward(
            "/subtitles", {"language": "auto", "mode": "accurate",
                           "max_line_chars": "42"})
        try:
            if resp.status != 200:
                self._proxy_error(resp, "/subtitles")
                return
            srt = resp.read().decode("utf-8")
            log.info("Gateway POST /v1/audio/subtitles | proxied in %.2fs",
                     time.time() - t0)
            self._text(srt, "subtitles.srt")
        finally:
            self._done(sup, conn)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _stream(self):
        """The worker's SSE stream relayed line by line, one chunk (and
        flush) an event; a stream that breaks ends with SSE_STREAM_ERROR."""
        t0 = time.time()
        sup, conn, resp, _ = self._forward(
            "/transcribe/stream",
            {"language": "auto", "return_timestamps": "false"})
        try:
            if resp.status != 200:
                self._proxy_error(resp, "/transcribe/stream")
                return
            self.send_response(200)
            for k, v in (("Content-Type", "text/event-stream"),
                         ("Cache-Control", "no-cache"),
                         ("Connection", "keep-alive"),
                         ("X-Accel-Buffering", "no"),
                         ("Transfer-Encoding", "chunked"),
                         ("X-Request-ID", self.request_id)):
                self.send_header(k, v)
            self.end_headers()
            lines, event, error = 0, b"", None
            try:
                while True:
                    try:
                        line = resp.readline()
                    except (OSError, http.client.HTTPException) as e:
                        error = e                  # the worker's side broke
                        break
                    if not line:
                        break
                    sup.last_used = time.time()
                    lines += 1
                    event += line
                    if line in (b"\n", b"\r\n"):      # the event's end
                        self._chunk(event)
                        event = b""
                if event:
                    self._chunk(event)
                if error is None:
                    log.info("Gateway POST /v1/audio/transcriptions/stream "
                             "| done chunks=%d elapsed=%.2fs", lines,
                             time.time() - t0)
                else:
                    log.error("Gateway POST /v1/audio/transcriptions/stream "
                              "| error after %.2fs: %s", time.time() - t0,
                              error)
                    # clients must tell a truncated stream from a whole one
                    self._chunk(("data: " + json.dumps({
                        "code": "SSE_STREAM_ERROR",
                        "message": f"worker stream interrupted: {error}",
                        "statusCode": 502}) + "\n\n").encode("utf-8"))
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except OSError:                        # the client went away
                log.info("Gateway SSE relay | client disconnected")
                self.close_connection = True
        finally:
            self._done(sup, conn)

    def _ws(self):
        """The WS session pumped to a worker (sticky to it) by two threads,
        one a direction; when either side ends, both end."""
        sup = self.server.fleet.choose()
        client = upgrade(self)
        if client is None:
            return
        ws_req_id = str(uuid.uuid4())
        token = set_request_id(ws_req_id)
        log.info("[GW-WS] Client connected, proxying to worker %d", sup.index)
        sup.add("ws_sessions", 1)
        worker = None
        try:
            try:
                sup.ensure()
            except Exception as e:
                client.send_json({"code": "WORKER_STARTUP_FAILED",
                                  "message": f"Worker startup failed: {e}",
                                  "statusCode": 503})
                return
            query = parse_qs(urlsplit(self.path).query)
            qs = [f"request_id={ws_req_id}"] + [
                f"{p}={query[p][0]}" for p in ("use_server_vad",
                                               "sample_rate") if p in query]
            worker = connect(f"ws://{sup.host}:{sup.port}/ws/transcribe?"
                             + "&".join(qs),
                             timeout=_env_int("REQUEST_TIMEOUT", "300"))
            sup.add("served", 1)
            greeting = worker.receive()
            if greeting.kind != "text":
                raise ConnectionError(f"worker greeting {greeting.kind}")
            client.send_text(greeting.data)
            self._pump(sup, client, worker)
        except Exception as e:
            try:
                client.send_json({"code": "WORKER_CONNECTION_FAILED",
                                  "message": f"Worker connection failed: {e}",
                                  "statusCode": 502})
            except OSError:
                pass
        finally:
            sup.add("ws_sessions", -1)
            log.info("[GW-WS] Proxy session ended")
            reset_request_id(token)
            if worker is not None:
                _shut(worker)
            client.close()

    @staticmethod
    def _pump(sup: WorkerSupervisor, client: WebSocket,
              worker: WebSocket) -> None:
        done = threading.Event()

        def relay(src: WebSocket, dst: WebSocket, name: str,
                  close_dst: bool):
            try:
                while not done.is_set():
                    msg = src.receive()
                    sup.last_used = time.time()
                    if msg.kind == "close":
                        break
                    if msg.kind == "text":
                        dst.send_text(msg.data)
                    else:
                        dst.send_bytes(msg.data)
                if close_dst:
                    dst.close()
            except OSError as e:
                log.warning("[GW-WS] %s error: %s", name, e)
            finally:
                done.set()

        up = threading.Thread(target=relay, name="gw-ws-client-to-worker",
                              args=(client, worker, "client_to_worker", True),
                              daemon=True)
        up.start()
        relay(worker, client, "worker_to_client", False)
        # the worker ended (or the client did, and the worker answered its
        # close): unblock the client's reader
        _shut(client, socket.SHUT_RD)
        up.join(timeout=30)

    def _health(self):
        sups = self.server.fleet.supervisors
        headers = {"X-Request-ID": self.request_id}
        polls: list = [None] * len(sups)

        def poll(i, s):
            body = s.health(headers)
            if body is not None:
                s._last_health = body
            if not s.managed:
                s._ready = body is not None
            polls[i] = body
        threads = [threading.Thread(target=poll, args=(i, s), daemon=True)
                   for i, s in enumerate(sups) if s.alive() or not s.managed]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # one worker keeps the reference's shape; the merged state comes
        # from the first responsive worker either way
        info = {"status": "ok", "mode": "gateway",
                "worker_alive": any(s.alive() for s in sups),
                "model_loaded": False, "model_id": None}
        body = next((b for b in polls if isinstance(b, dict)), None)
        if body is not None:
            info.update(body)
            info["mode"] = "gateway"
        if len(sups) > 1:
            info["workers"] = [
                {"index": s.index, "host": s.host, "port": s.port,
                 "managed": s.managed, "alive": s.alive(),
                 "inflight": s.inflight, "served": s.served,
                 "model_loaded": bool(isinstance(b, dict)
                                      and b.get("model_loaded"))}
                for s, b in zip(sups, polls)]
            info["worker_alive"] = any(s.alive() for s in sups)
            info["model_loaded"] = any(w["model_loaded"]
                                       for w in info["workers"])
        self._json(200, info)


def _shut(ws: WebSocket, how: int = socket.SHUT_RDWR) -> None:
    """Shut a WS connection's socket, which ends a read blocked on it."""
    try:
        ws.sock.shutdown(how)
    except OSError:
        pass


class GatewayServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, fleet: WorkerFleet, host: str, port: int):
        super().__init__((host, port), _GatewayHandler)
        self.fleet = fleet
        self.openapi = build_openapi(API_TITLE, API_VERSION, API_DESCRIPTION,
                                     API_TAGS, route_metadata())


def build_gateway(fleet: WorkerFleet, host: str = "127.0.0.1",
                  port: int = 0) -> GatewayServer:
    """A gateway over ``fleet`` (port 0 picks a free port). Call
    ``fleet.start_watchdog()`` and ``serve_forever()`` to run it; to stop,
    ``shutdown()``, ``server_close()``, ``fleet.stop_watchdog()`` and
    ``fleet.kill_all()``."""
    return GatewayServer(fleet, host, port)


def main():
    parser = argparse.ArgumentParser(description="Qwen3-ASR gateway (PyTorch)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int,
                        default=_env_int("PORT", "8000"))
    parser.add_argument("--device", default="cuda",
                        help="the managed workers' device")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        help="the managed workers' weights (default: the "
                             "device's)")
    args = parser.parse_args()
    setup_logging()
    config.validate_env()
    fleet = WorkerFleet.from_env(device=args.device, dtype=args.dtype)
    if len(fleet.supervisors) > 1:
        log.info("Worker fleet: %s", [
            f"{s.host}:{s.port}" + ("" if s.managed else " (external)")
            for s in fleet.supervisors])
    server = build_gateway(fleet, args.host, args.port)
    fleet.start_watchdog()
    if _env_int("IDLE_TIMEOUT", "120") == 0:
        log.info("Always-on mode: pre-spawning worker(s) at startup")
        try:
            fleet.ensure_all_managed()
        except Exception as e:
            log.warning("Worker pre-spawn failed (will retry on first "
                        "request): %s", e)
    log.info("gateway on %s:%d (workers on %s)", args.host,
             server.server_address[1], args.device)
    # a terminated gateway kills its workers first (the finally below)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        server.serve_forever()
    finally:
        server.server_close()
        fleet.stop_watchdog()
        fleet.kill_all()


if __name__ == "__main__":
    main()
