"""The port's translator (``sidecars/translator.py``, on ``urllib``)
against the JAX package's (on aiohttp), both talking to one fake
OpenAI-compatible server on the standard library: each case of
``tests/test_translator.py``, where the same inputs must send the same
request (path, ``Authorization``, and a JSON body equal to JAX's key for
key) and give the same answer or the same kind of failure."""
import asyncio
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from qwen3_asr_tpu.sidecars import translator as jtr
from qwen3_asr_tpu_torch.sidecars import translator as tr


class FakeLLM:
    """``POST /v1/chat/completions``: records each request and answers
    ``content`` as the first choice (no choices with ``no_choices``, the
    HTTP ``status`` otherwise)."""

    def __init__(self):
        self.requests = []
        self.content = "translated text"
        self.no_choices = False
        self.status = 200
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                fake.requests.append({
                    "path": self.path,
                    "auth": self.headers.get("Authorization"),
                    "body": json.loads(body)})
                if fake.status != 200:
                    data = b'{"error": "overloaded"}'
                    self.send_response(fake.status)
                else:
                    data = json.dumps({"choices": [] if fake.no_choices else [
                        {"message": {"role": "assistant",
                                     "content": fake.content}}]}).encode()
                    self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}/v1"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def llm(monkeypatch):
    fake = FakeLLM()
    monkeypatch.setenv("OPENAI_BASE_URL", fake.url)
    monkeypatch.setenv("TRANSLATE_MODEL", "test-model")
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.setenv("TRANSLATE_TIMEOUT", "30")
    yield fake
    fake.close()


def both(llm, name, *args):
    """``name`` of the port, then of JAX, on the same inputs: (ours, JAX's,
    the request each sent or None)."""
    n = len(llm.requests)
    ours = getattr(tr, name)(*args)
    sent = llm.requests[n:]
    loop = asyncio.new_event_loop()
    try:
        ref = loop.run_until_complete(getattr(jtr, name)(*args))
    finally:
        loop.close()
    jsent = llm.requests[n + len(sent):]
    assert sent == jsent
    return ours, ref, (sent[0] if sent else None)


def test_translate_text_prompt_and_temperature(llm):
    ours, ref, req = both(llm, "translate_text", "hola mundo", "en")
    assert ours == ref == "translated text"
    assert req["path"] == "/v1/chat/completions"
    assert req["auth"] == "Bearer sk-test"
    body = req["body"]
    assert body["model"] == "test-model" and body["temperature"] == 0.3
    assert body["messages"][0]["role"] == "system"
    assert "English" in body["messages"][1]["content"]
    assert "hola mundo" in body["messages"][1]["content"]


@pytest.mark.parametrize("target,name", [("zh", "Chinese"), ("EN", "English"),
                                         ("chinese", "Chinese"),
                                         ("fr", "fr")])
def test_translate_text_target_language(llm, target, name):
    _, _, req = both(llm, "translate_text", "hello", target)
    assert f"into {name}." in req["body"]["messages"][1]["content"]


def test_translate_text_empty_short_circuit(llm):
    ours, ref, req = both(llm, "translate_text", "   ", "en")
    assert ours == ref == "   " and req is None
    assert llm.requests == []


def test_translate_srt_temperature_and_prompt(llm):
    srt = "1\n00:00:00,000 --> 00:00:01,000\nhello\n"
    llm.content = srt
    ours, ref, req = both(llm, "translate_srt", srt, "zh")
    assert ours == ref == srt.strip()
    assert req["body"]["temperature"] == 0.1
    user = req["body"]["messages"][1]["content"]
    assert "SRT" in user and "timestamp" in user.lower()
    assert user.endswith(srt)


def test_translate_srt_empty_short_circuit(llm):
    ours, ref, req = both(llm, "translate_srt", "\n", "zh")
    assert ours == ref == "\n" and req is None


@pytest.mark.parametrize("content", [
    "```srt\n1\n00:00:00,000 --> 00:00:01,000\nhi\n```",
    "```\n1\n00:00:00,000 --> 00:00:01,000\nhi",
    "  ```srt\n1\nhi\n```  "])
def test_translate_srt_strips_markdown_fence(llm, content):
    llm.content = content
    ours, ref, _ = both(llm, "translate_srt", "1\nx\n", "en")
    assert ours == ref and not ours.startswith("```")


def test_unicode_round_trip(llm):
    llm.content = "你好，世界"
    ours, ref, req = both(llm, "translate_text", "héllo wörld ✓", "zh")
    assert ours == ref == "你好，世界"
    assert "héllo wörld ✓" in req["body"]["messages"][1]["content"]


def test_no_choices_raises(llm):
    llm.no_choices = True
    with pytest.raises(ValueError, match="no choices"):
        tr.translate_text("hello", "en")
    loop = asyncio.new_event_loop()
    try:
        with pytest.raises(ValueError, match="no choices"):
            loop.run_until_complete(jtr.translate_text("hello", "en"))
    finally:
        loop.close()


def test_http_error_raises(llm):
    llm.status = 503
    with pytest.raises(RuntimeError, match="returned 503: .*overloaded"):
        tr.translate_text("hello", "en")
    loop = asyncio.new_event_loop()
    try:
        with pytest.raises(RuntimeError, match="returned 503: .*overloaded"):
            loop.run_until_complete(jtr.translate_text("hello", "en"))
    finally:
        loop.close()


def test_api_error_raises(monkeypatch):
    monkeypatch.setenv("OPENAI_BASE_URL", "http://127.0.0.1:1/v1")
    monkeypatch.setenv("TRANSLATE_TIMEOUT", "2")
    with pytest.raises(Exception):
        tr.translate_text("hello", "en")
