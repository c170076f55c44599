"""The port's serving contract against the JAX package's: ``Metrics``'
Prometheus text, the JSON log line, ``LOG_LEVEL``, ``validate_env``, and
through the port's server on the CPU (trained checkpoint): ``/openapi.json``
and ``/docs``, ``/metrics`` after a known set of requests, ``/debug/trace``
(400, 409, 500, 200 with a trace written), uploads of every lossless
container answering the JAX server's body, and the request id in the log
lines of the request's thread and of the device thread."""
import contextlib
import importlib.util
import io
import json
import logging
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

import jax  # noqa: F401  (the port's tests import both frameworks)
import jax.numpy as jnp
import torch

from qwen3_asr_tpu import config as jax_config
from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint as jax_load
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.serving.http import _DOCS_HTML as JAX_DOCS_HTML
from qwen3_asr_tpu.serving.http import build_openapi as jax_build_openapi
from qwen3_asr_tpu.serving.meta import API_TITLE as JAX_TITLE
from qwen3_asr_tpu.serving.meta import API_VERSION as JAX_VERSION
from qwen3_asr_tpu.serving.meta import route_metadata as jax_routes
from qwen3_asr_tpu.serving.schemas import API_DESCRIPTION as JAX_DESCRIPTION
from qwen3_asr_tpu.serving.schemas import API_TAGS as JAX_TAGS
from qwen3_asr_tpu.serving.server import merge_results as jax_merge
from qwen3_asr_tpu.text.repetition import detect_and_fix_repetitions
from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
from qwen3_asr_tpu.utils import logging as jax_logging
from qwen3_asr_tpu.utils.errors import error_body as jax_error_body
from qwen3_asr_tpu.utils.telemetry import Metrics as JaxMetrics
from qwen3_asr_tpu_torch import config
from qwen3_asr_tpu_torch.runtime.batcher import TickBatcher
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
from qwen3_asr_tpu_torch.serving import server as server_mod
from qwen3_asr_tpu_torch.serving.server import build_server
from qwen3_asr_tpu_torch.utils import logging as port_logging
from qwen3_asr_tpu_torch.utils.telemetry import Metrics

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "e2e", "data")
CKPT = os.path.join(DATA, "trained_ckpt")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- Metrics -------------------------------------------------------------------


def _metric_ops(seed: int) -> list:
    rng = np.random.default_rng(seed)
    paths = ["/health", "/v1/audio/transcriptions", "unmatched"]
    ops = []
    for _ in range(60):
        kind = str(rng.choice(["inc", "observe", "gauge"]))
        name = {"inc": ["asr_requests_total", "asr_tick_batch_ticks_total"],
                "observe": ["asr_request_duration_seconds"],
                "gauge": ["asr_queue_depth", "asr_model_loaded"]}[kind]
        labels = ({} if rng.random() < 0.3 else
                  {"path": str(rng.choice(paths)),
                   "status": str(rng.choice(["200", "404", "422"]))})
        value = float(rng.choice([0.01, 0.05, 0.07, 0.3, 1.0, 2.0, 4.5, 7.0,
                                  20.0, 45.0, 100.0, 400.0]))
        ops.append((kind, str(rng.choice(name)), value, labels))
    return ops


def _render_without_uptime(registry) -> str:
    lines = registry.render().splitlines()
    assert lines[-2:][0] == "# TYPE asr_uptime_seconds gauge"
    assert re.fullmatch(r"asr_uptime_seconds \d+\.\d", lines[-1])
    return "\n".join(lines[:-1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_metrics_render_equals_jax(seed):
    ours, ref = Metrics(), JaxMetrics()
    for kind, name, value, labels in _metric_ops(seed):
        for registry in (ours, ref):
            getattr(registry, kind)(name, value, **labels)
    assert _render_without_uptime(ours) == _render_without_uptime(ref)


# -- JSON log lines ------------------------------------------------------------


def _record(level: int, exc: bool) -> logging.LogRecord:
    exc_info = None
    if exc:
        try:
            raise ValueError("bad clip")
        except ValueError:
            exc_info = sys.exc_info()
    return logging.LogRecord("qwen3_asr_tpu_torch.serving.server", level,
                             __file__, 1, "took %.2fs for %s",
                             (1.2345, "clip"), exc_info)


@pytest.mark.parametrize("level", [5, logging.DEBUG, logging.INFO,
                                   logging.WARNING, logging.ERROR,
                                   logging.CRITICAL],
                         ids=["trace", "debug", "info", "warning", "error",
                              "critical"])
@pytest.mark.parametrize("req_id", [None, "req-123"], ids=["no_id", "id"])
@pytest.mark.parametrize("exc", [False, True], ids=["plain", "err"])
def test_log_line_equals_jax(level, req_id, exc):
    """The port's JSON line for a record equals the one JAX's
    ``InterceptHandler`` writes through its ``StructuredLogger``, but for
    the timestamp."""
    record = _record(level, exc)
    token = port_logging.set_request_id(req_id) if req_id else None
    try:
        ours = json.loads(port_logging.JsonFormatter().format(record))
    finally:
        if token:
            port_logging.reset_request_id(token)
    buf = io.StringIO()
    handler = jax_logging.InterceptHandler(
        jax_logging.StructuredLogger(stream=buf, level="trace"))
    token = jax_logging.set_request_id(req_id) if req_id else None
    try:
        handler.emit(record)
    finally:
        if token:
            jax_logging.reset_request_id(token)
    ref = json.loads(buf.getvalue())
    for line in (ours, ref):
        assert "T" in line.pop("timestamp")
    assert ours == ref


@contextlib.contextmanager
def _saved_logging():
    """Every logger's handlers and propagation and the root's level, as
    they were."""
    loggers = [logging.getLogger(n)
               for n in list(logging.root.manager.loggerDict)]
    saved = [(lg, list(lg.handlers), lg.propagate) for lg in loggers]
    root = (list(logging.root.handlers), logging.root.level)
    try:
        yield
    finally:
        logging.root.handlers, level = root
        logging.root.setLevel(level)
        for lg, handlers, propagate in saved:
            lg.handlers, lg.propagate = handlers, propagate


@pytest.mark.parametrize("value", ["trace", "debug", "info", "warn",
                                   "warning", "error", "fatal", "critical",
                                   "loud"])
def test_log_level_equals_jax(value, monkeypatch):
    """``setup_logging`` sets the root level JAX's
    ``intercept_stdlib_logging`` sets for the same ``LOG_LEVEL``, and its
    one handler writes the JSON line."""
    monkeypatch.setenv("LOG_LEVEL", value)
    with _saved_logging():
        jax_logging.intercept_stdlib_logging()
        want = logging.root.level
        buf = io.StringIO()
        port_logging.setup_logging(buf)
        got = logging.root.level
        logging.getLogger("qwen3_asr_tpu_torch.probe").critical("x %d", 1)
        handlers = list(logging.root.handlers)
    assert got == want
    assert len(handlers) == 1
    line = json.loads(buf.getvalue())
    assert (line["level"], line["message"], line["service"]) == (
        "fatal", "x 1", "qwen3-asr")


# -- validate_env --------------------------------------------------------------

ENV_KEYS = ("MODEL_ID", "REQUEST_TIMEOUT", "IDLE_TIMEOUT", "LOG_LEVEL",
            "QUANTIZE", "GATEWAY_MODE", "WORKER_PORT", "WORKER_PORTS",
            "WORKER_HOSTS", "WS_WINDOW_MAX_S", "ASR_MAX_SESSIONS",
            "ASR_WS_STREAM_MODE", "USE_CUDA_GRAPHS", "ONNX_ENCODER_PATH",
            "TRT_ENCODER_PATH", "USE_GRANIAN")
ENVS = {
    "minimal": {"MODEL_ID": "x"},
    "everything_good": {
        "MODEL_ID": "x", "REQUEST_TIMEOUT": "60", "IDLE_TIMEOUT": "0",
        "LOG_LEVEL": "warn", "QUANTIZE": "int4", "GATEWAY_MODE": "true",
        "WORKER_PORT": "8001", "WORKER_PORTS": "8001, 8002",
        "WORKER_HOSTS": "a:1,b", "WS_WINDOW_MAX_S": "30",
        "ASR_MAX_SESSIONS": "4", "ASR_WS_STREAM_MODE": "grouped",
        "USE_CUDA_GRAPHS": "true", "ONNX_ENCODER_PATH": "/e.onnx",
        "TRT_ENCODER_PATH": "/e.trt", "USE_GRANIAN": "true"},
    "no_model_id": {},
    "every_problem": {
        "MODEL_ID": "", "REQUEST_TIMEOUT": "abc", "IDLE_TIMEOUT": "-1",
        "LOG_LEVEL": "loud", "QUANTIZE": "int3", "GATEWAY_MODE": "true",
        "WORKER_PORT": "70000", "WORKER_PORTS": "80,x",
        "WS_WINDOW_MAX_S": "0", "ASR_MAX_SESSIONS": "-2",
        "ASR_WS_STREAM_MODE": "turbo"},
    "request_timeout_zero": {"MODEL_ID": "x", "REQUEST_TIMEOUT": "0"},
    "idle_timeout_text": {"MODEL_ID": "x", "IDLE_TIMEOUT": "soon"},
    "log_level_fatal": {"MODEL_ID": "x", "LOG_LEVEL": "FATAL"},
    "quantize_upper": {"MODEL_ID": "x", "QUANTIZE": "INT8"},
    "worker_port_without_gateway": {"MODEL_ID": "x", "WORKER_PORT": "0"},
    "worker_port_text": {"MODEL_ID": "x", "GATEWAY_MODE": "TRUE",
                         "WORKER_PORT": "eight"},
    "worker_hosts_no_host": {"MODEL_ID": "x", "WORKER_HOSTS": "a:1, :80"},
    "worker_hosts_bad_port": {"MODEL_ID": "x", "WORKER_HOSTS": "h:0"},
    "ws_window_text": {"MODEL_ID": "x", "WS_WINDOW_MAX_S": "long"},
    "max_sessions_text": {"MODEL_ID": "x", "ASR_MAX_SESSIONS": "many"},
    "max_sessions_empty": {"MODEL_ID": "x", "ASR_MAX_SESSIONS": ""},
    "stream_mode_auto_upper": {"MODEL_ID": "x", "ASR_WS_STREAM_MODE": "AUTO"},
}


def _set_env(monkeypatch, env: dict) -> None:
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("case", list(ENVS))
def test_validate_env_equals_jax(case, monkeypatch, caplog):
    """The same problems (every one logged), then exit 1; or a pass."""
    _set_env(monkeypatch, ENVS[case])
    buf = io.StringIO()
    monkeypatch.setattr(jax_config, "log",
                        jax_logging.StructuredLogger(stream=buf,
                                                     level="info"))
    jax_code = ours_code = None
    try:
        jax_config.validate_env()
    except SystemExit as e:
        jax_code = e.code
    want = [json.loads(x)["message"] for x in buf.getvalue().splitlines()
            if json.loads(x)["level"] == "error"]
    with caplog.at_level(logging.INFO, logger="qwen3_asr_tpu_torch.config"):
        try:
            config.validate_env()
        except SystemExit as e:
            ours_code = e.code
    got = [r.getMessage() for r in caplog.records
           if r.levelno == logging.ERROR]
    assert ours_code == jax_code
    assert got == want
    if jax_code is None:
        assert caplog.records[-1].getMessage() == "Config validation passed"
    else:
        assert jax_code == 1 and got


def test_validate_env_says_what_the_port_does_with_cuda_flags(monkeypatch,
                                                              caplog):
    _set_env(monkeypatch, ENVS["everything_good"])
    with caplog.at_level(logging.INFO, logger="qwen3_asr_tpu_torch.config"):
        config.validate_env()
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "CUDA graphs" in text and "TPU" not in text
    assert "ONNX_ENCODER_PATH set" in text and "TRT_ENCODER_PATH set" in text
    assert "USE_GRANIAN=true" in text


# -- through the server on the CPU ---------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _skip_warmup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKIP_WARMUP", "true")
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
        yield f"http://127.0.0.1:{server.server_address[1]}"
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
def jax_engine():
    cfg, params = jax_load(CKPT, dtype=jnp.float32, cache=False)
    model = JaxModel(cfg, params,
                     JaxTokenizer.from_file(os.path.join(CKPT,
                                                         "tokenizer.json")),
                     JaxTemplate.from_checkpoint(CKPT))
    return JaxEngine(model, dtype=jnp.float32)


@pytest.fixture(scope="module")
def url(engine):
    with serving(ModelManager(engine)) as u:
        yield u


def _request(url, method="GET", body=None, headers=None, timeout=120):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _upload(url, data: bytes, headers=None):
    bnd = uuid.uuid4().hex
    body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.bin\"\r\n\r\n").encode() + data + \
        f"\r\n--{bnd}--\r\n".encode()
    status, hdrs, raw = _request(
        url + "/v1/audio/transcriptions", "POST", body,
        {"Content-Type": f"multipart/form-data; boundary={bnd}",
         **(headers or {})})
    return status, hdrs, json.loads(raw)


def port_description(jax_description: str) -> str:
    """JAX's API description with the port's "Audio formats" paragraph in
    place of its own; every other word is JAX's."""
    from qwen3_asr_tpu_torch.serving.schemas import API_DESCRIPTION

    def split(text):
        head, rest = text.split("## Audio formats\n", 1)
        body, tail = rest.split("\n\n## ", 1)
        return head, body, tail
    head, _, tail = split(jax_description)
    port_head, port_body, port_tail = split(API_DESCRIPTION)
    assert (port_head, port_tail) == (head, tail)
    return f"{head}## Audio formats\n{port_body}\n\n## {tail}"


def test_openapi_json_equals_jax(url):
    status, hdrs, raw = _request(url + "/openapi.json")
    assert status == 200
    assert hdrs["Content-Type"].startswith("application/json")
    want = jax_build_openapi(JAX_TITLE, JAX_VERSION,
                             port_description(JAX_DESCRIPTION), JAX_TAGS,
                             jax_routes())
    assert json.loads(raw) == json.loads(json.dumps(want))


def test_docs_equals_jax(url):
    status, hdrs, raw = _request(url + "/docs")
    assert status == 200 and hdrs["Content-Type"].startswith("text/html")
    assert raw.decode("utf-8") == JAX_DOCS_HTML.format(title=JAX_TITLE)


def _scrape(url) -> tuple:
    status, hdrs, raw = _request(url + "/metrics")
    assert status == 200
    assert hdrs["Content-Type"] == "text/plain; charset=utf-8"
    text = raw.decode()
    counts, hist, types = {}, {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            types.append(line.split()[2])
            continue
        name, _, value = line.rpartition(" ")
        labels = dict(re.findall(r'(\w+)="([^"]*)"', name))
        if name.startswith("asr_requests_total{"):
            counts[(labels["path"], labels["method"],
                    labels["status"])] = float(value)
        elif name.startswith("asr_request_duration_seconds_count{"):
            hist[labels["path"]] = float(value)
    return text, counts, hist, types


def test_metrics_count_a_known_set_of_requests(engine):
    """Each request under its route (a 404 as ``unmatched``, ``/metrics``
    not at all), a matched route's wall in the histogram, the gauges read
    at the scrape, one TYPE line a name."""
    with open(os.path.join(DATA, "real", "english_01.wav"), "rb") as f:
        wav = f.read()
    with serving(ModelManager(engine)) as url:
        for _ in range(2):
            assert _request(url + "/health")[0] == 200
        assert _upload(url, wav)[0] == 200
        assert _upload(url, b"not audio at all")[0] == 422
        assert _request(url + "/nope")[0] == 404
        assert _request(url + "/nope", "POST", b"")[0] == 404
        assert _request(url + "/openapi.json")[0] == 200
        assert _request(url + "/docs")[0] == 200
        assert _request(url + "/metrics")[0] == 200
        assert _request(url + "/debug/trace?seconds=x", "POST", b"")[0] == 400
        text, counts, hist, types = _scrape(url)
    assert counts == {
        ("/health", "GET", "200"): 2.0,
        ("/v1/audio/transcriptions", "POST", "200"): 1.0,
        ("/v1/audio/transcriptions", "POST", "422"): 1.0,
        ("unmatched", "GET", "404"): 1.0,
        ("unmatched", "POST", "404"): 1.0,
        ("/openapi.json", "GET", "200"): 1.0,
        ("/docs", "GET", "200"): 1.0,
        ("/debug/trace", "POST", "400"): 1.0}
    assert hist == {"/health": 2.0, "/v1/audio/transcriptions": 2.0,
                    "/openapi.json": 1.0, "/docs": 1.0, "/debug/trace": 1.0}
    lines = text.splitlines()
    for gauge in ("asr_model_loaded 1.0", "asr_queue_depth 0.0",
                  "asr_ws_sessions 0.0"):
        assert gauge in lines
    assert len(types) == len(set(types))
    assert lines[-2] == "# TYPE asr_uptime_seconds gauge"


class _NoSleep:
    """``time`` for the server module, but ``sleep`` returns at once."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def sleep(seconds):
        return None


def test_debug_trace_invalid_and_capped(url, tmp_path, monkeypatch):
    """A non-number answers JAX's 400; N is capped at 60."""
    monkeypatch.setenv("ASR_TRACE_DIR", str(tmp_path))
    status, _, raw = _request(url + "/debug/trace?seconds=abc", "POST", b"")
    assert status == 400
    body = json.loads(raw)
    assert body == jax_error_body("INVALID_JSON", "seconds must be a number",
                                  400)
    monkeypatch.setattr(server_mod, "time", _NoSleep())
    # an idle server: the wait for the record budget times out at once
    monkeypatch.setattr(server_mod, "wait_for_nodes",
                        lambda count, timeout: False)
    status, _, raw = _request(url + "/debug/trace?seconds=600", "POST", b"")
    assert status == 200
    assert json.loads(raw) == {"trace_dir": str(tmp_path), "seconds": 60.0,
                               "captured_seconds": 60.0, "kernel_records": 0,
                               "budget_reached": False}


def test_debug_trace_writes_a_trace_and_refuses_a_second(url, tmp_path,
                                                         monkeypatch):
    """The default capture writes a Chrome trace into ``ASR_TRACE_DIR``
    and answers JAX's ``{"trace_dir", "seconds"}`` with the seconds
    recorded (all of them on an idle server), the records and the budget
    unreached; a second request meanwhile answers 409 WORKER_ERROR."""
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("ASR_TRACE_DIR", str(trace_dir))
    first = {}
    thread = threading.Thread(target=lambda: first.update(
        answer=_request(url + "/debug/trace?seconds=1.5", "POST", b"")))
    thread.start()
    time.sleep(0.4)
    status, _, raw = _request(url + "/debug/trace", "POST", b"")
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert status == 409
    assert json.loads(raw) == jax_error_body(
        "WORKER_ERROR", "a profiler trace is already in progress", 409)
    status, _, raw = first["answer"]
    assert status == 200
    assert json.loads(raw) == {"trace_dir": str(trace_dir), "seconds": 1.5,
                               "captured_seconds": 1.5, "kernel_records": 0,
                               "budget_reached": False}
    files = list(trace_dir.glob("*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_trace_activities_by_device():
    """A capture records the CPU's ops, and on the card CUPTI's kernels
    too (graph nodes one by one): the kernels' names are the trace's
    point there, and the card's activity alone stops far slower."""
    acts = torch.profiler.ProfilerActivity
    assert server_mod.trace_activities("cuda") == [acts.CPU, acts.CUDA]
    assert server_mod.trace_activities(torch.device("cuda", 0)) == \
        [acts.CPU, acts.CUDA]
    assert server_mod.trace_activities("cpu") == [acts.CPU]


class _Sleeps(_NoSleep):
    """``time`` for the server module whose ``sleep`` returns at once and
    adds up what it was asked to sleep."""

    def __init__(self):
        self.total = 0.0

    def sleep(self, seconds):
        self.total += seconds


class _Replays:
    """``replayed_nodes`` and ``wait_for_nodes`` for the server module: a
    load that replays ``per_second`` graph nodes a second, on a clock
    that only the wait moves (the wait returns at once)."""

    def __init__(self, per_second):
        self.per_second, self.now, self.waits = per_second, 0.0, []

    def replayed_nodes(self):
        return int(self.now * self.per_second)

    def wait_for_nodes(self, count, timeout):
        self.waits.append((count, timeout))
        need = count / self.per_second if self.per_second else timeout + 1
        self.now += min(need, timeout)
        return need <= timeout

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("per_second, seconds, captured, reached", [
    (0, 10.0, 10.0, False),          # an idle server: every second
    (8_000, 10.0, 10.0, False),      # 80000 nodes in 10 s, under budget
    (100_000, 10.0, 1.0, True),      # the budget reached after 1 s
    (500_000, 3.0, 0.2, True),
])
def test_debug_trace_stops_recording_at_the_budget(url, tmp_path,
                                                   monkeypatch, per_second,
                                                   seconds, captured,
                                                   reached):
    """The recording stops once the graph nodes replayed meanwhile reach
    the budget (one wait for that many nodes or the seconds asked): the
    answer says the seconds recorded, the nodes and whether the budget
    was reached, a trace is written, and the request still lasts the
    seconds asked (the wait and the sleep add up to them)."""
    monkeypatch.setenv("ASR_TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(server_mod, "TRACE_RECORD_BUDGET", 100_000)
    load, clock = _Replays(per_second), _Sleeps()
    clock.perf_counter = load.perf_counter
    monkeypatch.setattr(server_mod, "time", clock)
    monkeypatch.setattr(server_mod, "replayed_nodes", load.replayed_nodes)
    monkeypatch.setattr(server_mod, "wait_for_nodes", load.wait_for_nodes)
    status, _, raw = _request(url + f"/debug/trace?seconds={seconds:g}",
                              "POST", b"")
    assert status == 200
    body = json.loads(raw)
    assert body["trace_dir"] == str(tmp_path) and body["seconds"] == seconds
    assert body["captured_seconds"] == pytest.approx(captured)
    assert body["budget_reached"] is reached
    assert body["kernel_records"] == (100_000 if reached
                                      else int(per_second * seconds))
    assert load.waits == [(100_000, seconds)]
    assert load.now + clock.total == pytest.approx(seconds)
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_wait_for_nodes_wakes_at_the_replay_that_crosses_the_count():
    """``wait_for_nodes`` returns True once replays have added the count
    (the replay path sets the waiter's event under ``device_lock``) and
    False at its timeout; the waiter is removed either way."""
    from qwen3_asr_tpu_torch.runtime import graphs

    def replay(nodes):
        with graphs.device_lock:
            graphs._replayed_nodes[0] += nodes
            for count, event in graphs._node_alarms:
                if graphs._replayed_nodes[0] >= count:
                    event.set()
    got = {}
    waiter = threading.Thread(target=lambda: got.update(
        hit=graphs.wait_for_nodes(1000, 30)))
    waiter.start()
    while not graphs._node_alarms:
        time.sleep(0.01)
    replay(600)
    assert waiter.is_alive()
    replay(600)
    waiter.join(30)
    assert got == {"hit": True} and graphs._node_alarms == []
    assert graphs.wait_for_nodes(10 ** 12, 0.05) is False
    assert graphs._node_alarms == []


def test_debug_trace_failure_answers_500(url, tmp_path, monkeypatch):
    monkeypatch.setenv("ASR_TRACE_DIR", str(tmp_path))

    def broken(device):
        raise RuntimeError("profiler busy")
    monkeypatch.setattr(server_mod, "start_trace", broken)
    status, _, raw = _request(url + "/debug/trace?seconds=0.1", "POST", b"")
    assert status == 500
    assert json.loads(raw) == jax_error_body(
        "WORKER_ERROR", "trace failed: profiler busy", 500)
    # the lock is free again
    monkeypatch.undo()
    monkeypatch.setenv("ASR_TRACE_DIR", str(tmp_path))
    assert _request(url + "/debug/trace?seconds=0.1", "POST",
                    b"")[0] == 200


def test_trace_start_waits_for_replays_and_stop_does_not(tmp_path):
    """The profiler starts and stops under ``capture_lock`` and
    ``device_lock`` (a graph build holds both, a replay the second), so
    the start and the stop wait for a build and for a replay being
    enqueued, and no replay is enqueued while the stop processes CUPTI's
    records: a stop beside running replays hung a loaded server on the
    card (the test's name is from when the stop left replays free)."""
    from qwen3_asr_tpu_torch.runtime.graphs import capture_lock, device_lock

    def holding(lock):
        taken, release = threading.Event(), threading.Event()

        def hold():
            with lock:
                taken.set()
                release.wait(60)
        thread = threading.Thread(target=hold)
        thread.start()
        assert taken.wait(30)
        return thread, release

    for lock in (device_lock, capture_lock):
        started, go, stopped = (threading.Event(), threading.Event(),
                                threading.Event())

        def trace():
            # start and stop on one thread, as the server's route does
            prof = server_mod.start_trace("cpu")
            started.set()
            go.wait(60)
            server_mod.stop_trace(prof, str(tmp_path))
            stopped.set()
        holder, release = holding(lock)
        try:
            tracer = threading.Thread(target=trace)
            tracer.start()
            assert not started.wait(0.5)
        finally:
            release.set()
            holder.join(30)
        assert started.wait(60)
        holder, release = holding(lock)
        try:
            go.set()
            assert not stopped.wait(0.5)
        finally:
            release.set()
            holder.join(30)
        assert stopped.wait(60)
        tracer.join(60)
    assert len(list(tmp_path.glob("*.json"))) == 2


CONTAINERS =["flac16", "flac24_lpc", "flac16_stereo", "aiff",
              "aifc_float32", "au", "caf", "w64"]


@pytest.fixture(scope="module")
def variants():
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    with open(os.path.join(DATA, "real", "chinese_02.wav"), "rb") as f:
        audio, _ = decode_audio(f.read())
    ints = np.round(audio * 32768).astype(np.int64).clip(-32767, 32767)
    return _chip_smoke().codec_variants(ints)


@pytest.mark.parametrize("kind", CONTAINERS)
def test_container_upload_answers_the_jax_servers_body(url, jax_engine,
                                                       variants, kind):
    data = variants[kind]
    status, _, body = _upload(url, data)
    text, lang, _ = jax_merge(jax_engine.transcribe(*jax_decode_audio(data),
                                                    None))
    assert status == 200
    assert body == {"text": detect_and_fix_repetitions(text),
                    "language": lang}


class _Lines(logging.Handler):
    """JSON lines with the thread that logged each."""

    def __init__(self):
        super().__init__()
        self.setFormatter(port_logging.JsonFormatter())
        self.lines = []

    def emit(self, record):
        self.lines.append((record.threadName,
                           json.loads(self.format(record))))


def test_request_id_in_the_lines_of_its_thread_and_the_device_thread(
        monkeypatch):
    """A lazy manager's first upload loads the model on the device thread:
    those lines, and the request thread's, carry the upload's
    X-Request-ID; the response carries it too."""
    for k, v in {"MODEL_ID": CKPT, "IDLE_TIMEOUT": "0"}.items():
        monkeypatch.setenv(k, v)
    with open(os.path.join(DATA, "real", "thai_01.wav"), "rb") as f:
        wav = f.read()
    lines = _Lines()
    level = logging.root.level
    logging.root.addHandler(lines)
    logging.root.setLevel(logging.INFO)
    try:
        with serving(ModelManager(device="cpu")) as url:
            status, hdrs, _ = _upload(url, wav, {"X-Request-ID": "req-42"})
            assert _request(url + "/health")[0] == 200
    finally:
        logging.root.removeHandler(lines)
        logging.root.setLevel(level)
    assert status == 200 and hdrs["X-Request-ID"] == "req-42"
    mine = [(t, line) for t, line in lines.lines
            if line.get("requestId") == "req-42"]
    device = [line["message"] for t, line in mine if t == "device-dispatch"]
    assert any(m.startswith("Loading ") for m in device), mine
    assert any(t != "device-dispatch" for t, _ in mine)


def test_tick_batches_are_counted_in_metrics(engine):
    """The tick batcher counts JAX's ``asr_tick_batch_*`` in the manager's
    registry."""
    mgr = ModelManager(engine)
    batcher = TickBatcher(mgr, window_ms=1)
    mgr.queue.start()
    try:
        audio = np.zeros(16000, np.float32)
        batcher.transcribe_tick(audio, "en", None, False).result(120)
    finally:
        mgr.queue.stop()
    text = mgr.metrics.render().splitlines()
    assert 'asr_tick_batch_groups_total{size="1"} 1.0' in text
    assert "asr_tick_batch_ticks_total 1.0" in text


def test_ws_and_sse_are_counted_when_they_end(engine):
    """A WS session counts under ``/ws/transcribe`` with status 101 once
    it closes, and its lines carry its ``request_id``; an SSE stream
    counts 200 under its route when it ends."""
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    with open(os.path.join(DATA, "real", "english_02.wav"), "rb") as f:
        wav = f.read()
    lines = _Lines()
    level = logging.root.level
    logging.root.addHandler(lines)
    logging.root.setLevel(logging.INFO)
    try:
        with serving(ModelManager(engine)) as url:
            sock = ws_mod.connect(url.replace("http://", "ws://")
                                  + "/ws/transcribe?request_id=ws-7",
                                  timeout=120)
            assert sock.receive_json()["status"] == "connected"
            sock.close()
            bnd = uuid.uuid4().hex
            body = (f"--{bnd}\r\nContent-Disposition: form-data; "
                    f"name=\"file\"; filename=\"a.wav\"\r\n\r\n").encode() \
                + wav + f"\r\n--{bnd}--\r\n".encode()
            status, _, raw = _request(
                url + "/v1/audio/transcriptions/stream", "POST", body,
                {"Content-Type": f"multipart/form-data; boundary={bnd}"})
            assert status == 200 and b'"done": true' in raw
            counts = {}
            # each is counted as its handler ends, which may be after
            # the client has read the last byte
            for _ in range(100):
                _, counts, hist, _ = _scrape(url)
                if {("/ws/transcribe", "GET", "101"),
                        ("/v1/audio/transcriptions/stream", "POST",
                         "200")} <= set(counts):
                    break
                time.sleep(0.1)
    finally:
        logging.root.removeHandler(lines)
        logging.root.setLevel(level)
    assert counts == {("/ws/transcribe", "GET", "101"): 1.0,
                      ("/v1/audio/transcriptions/stream", "POST",
                       "200"): 1.0}
    assert hist == {"/ws/transcribe": 1.0,
                    "/v1/audio/transcriptions/stream": 1.0}
    ws_lines = [line["message"] for _, line in lines.lines
                if line.get("requestId") == "ws-7"]
    assert any("client connected" in m for m in ws_lines), ws_lines
