"""The port's HTTP server on the CPU with the trained checkpoint, on an
ephemeral port, driven with urllib: the same JSON as the JAX engine after
the repetition fix, the JAX server's error bodies, concurrent uploads
answered from one batched dispatch, and 504 past REQUEST_TIMEOUT."""
import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.audio.codec import AudioDecodeError as JaxDecodeError
from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint as jax_load
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.serving.server import merge_results as jax_merge
from qwen3_asr_tpu.text.repetition import detect_and_fix_repetitions
from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
from qwen3_asr_tpu.utils.errors import error_body as jax_error_body
from qwen3_asr_tpu_torch.audio.codec import decode_audio, encode_wav
from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
from qwen3_asr_tpu_torch.serving.server import build_server, merge_results

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")


@pytest.fixture(scope="module", autouse=True)
def _skip_warmup():
    """Managers here start without warming the engine's executables (the
    warmup has tests of its own in test_torch_generate.py)."""
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
    """The server for ``manager`` on an ephemeral port; yields its URL."""
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
def url(engine):
    with serving(ModelManager(engine)) as u:
        yield u


@pytest.fixture(scope="module")
def jax_engine():
    cfg, params = jax_load(CKPT, dtype=jnp.float32, cache=False)
    model = JaxModel(cfg, params,
                     JaxTokenizer.from_file(os.path.join(CKPT,
                                                         "tokenizer.json")),
                     JaxTemplate.from_checkpoint(CKPT))
    return JaxEngine(model, dtype=jnp.float32)


def _post(url, data: bytes, fields=()):
    bnd = uuid.uuid4().hex
    body = b""
    for k, v in fields:
        body += (f"--{bnd}\r\nContent-Disposition: form-data; name=\"{k}\""
                 f"\r\n\r\n{v}\r\n").encode()
    body += (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
             f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n"
             ).encode() + data + f"\r\n--{bnd}--\r\n".encode()
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={bnd}"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(url):
    with urllib.request.urlopen(url + "/health", timeout=10) as r:
        assert r.status == 200
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["device"] == "cpu"
    assert body["kv_cache_dtype"] == "float32"


@pytest.mark.parametrize("clip,language", [("english_01", "auto"),
                                           ("japanese_02", "auto"),
                                           ("hindi_01", "hi")])
def test_transcription_json_matches_jax(url, jax_engine, clip, language):
    with open(os.path.join(ROOT, "real", clip + ".wav"), "rb") as f:
        data = f.read()
    status, body = _post(url, data, [("language", language)])
    audio, sr = jax_decode_audio(data)
    results = jax_engine.transcribe(audio, sr,
                                    None if language == "auto" else language)
    text, lang, _ = jax_merge(results)
    assert status == 200
    assert body == {"text": detect_and_fix_repetitions(text),
                    "language": lang}


def _jax_decode_error(data: bytes) -> dict:
    """The JAX server's 422 body for these bytes, minus its request id."""
    if not data:
        return jax_error_body("AUDIO_DECODE_FAILED",
                              "Could not decode audio: empty file", 422,
                              fileSize=0)
    with pytest.raises(JaxDecodeError) as e:
        jax_decode_audio(data)
    return jax_error_body("AUDIO_DECODE_FAILED",
                          f"Could not decode audio: {e.value}", 422,
                          fileSize=len(data))


@pytest.mark.parametrize("data", [b"", b"not audio"], ids=["empty", "short"])
def test_decode_errors_match_jax_body(url, data):
    status, body = _post(url, data)
    assert status == 422
    assert body == _jax_decode_error(data)


def test_non_wav_gets_422(url):
    """FLAC, MP3 and Ogg decode now: a corrupt FLAC stream answers the JAX
    server's 422 body; corrupt OGG and MP3 bytes answer 422
    AUDIO_DECODE_FAILED with their size, as JAX's server does for them."""
    data = b"fLaC" + bytes(100)
    status, body = _post(url, data)
    assert status == 422
    assert body == _jax_decode_error(data)
    for data in (b"OggS" + bytes(100), b"ID3" + bytes(100),
                 b"\xff\xfb" + bytes(100)):
        status, body = _post(url, data)
        assert status == 422
        assert body["code"] == "AUDIO_DECODE_FAILED"
        assert body["statusCode"] == 422
        assert body["context"] == {"fileSize": len(data)}
        assert body["message"].startswith("Could not decode audio: ")
        assert _jax_decode_error(data)["statusCode"] == 422


def test_timestamps_answer_501(url, jax_engine, monkeypatch):
    """The upload that answered 501 before word timestamps were served
    now answers 200 with the JAX server's body: no aligner loads
    (``FORCED_ALIGNER_ID`` names no directory here), so both time the
    words by char-proportional estimates; times within 1e-3 s."""
    from qwen3_asr_tpu.sidecars import subtitle as jax_subtitle
    from qwen3_asr_tpu_torch.sidecars import subtitle
    monkeypatch.setattr(jax_subtitle, "_aligner", None)
    monkeypatch.setattr(subtitle, "FORCED_ALIGNER_ID",
                        os.path.join(ROOT, "no_such_aligner"))
    with open(os.path.join(ROOT, "real", "english_02.wav"), "rb") as f:
        data = f.read()
    status, body = _post(url, data, [("return_timestamps", "true")])
    assert status == 200
    text, lang, stamps = jax_merge(jax_engine.transcribe(
        *jax_decode_audio(data), None, True))
    want = {"text": detect_and_fix_repetitions(text), "language": lang,
            "timestamps": stamps}
    assert body.keys() == want.keys() and stamps
    assert (body["text"], body["language"]) == (want["text"], lang)
    assert [w["word"] for w in body["timestamps"]] == \
        [w["word"] for w in stamps]
    for ours, ref in zip(body["timestamps"], stamps):
        assert abs(ours["start"] - ref["start"]) <= 1e-3
        assert abs(ours["end"] - ref["end"]) <= 1e-3


def _float_wav(audio: np.ndarray, sr: int) -> bytes:
    """Mono IEEE-float WAV of float32 ``audio``."""
    pcm = np.asarray(audio, "<f4").tobytes()
    return (b"RIFF" + (36 + len(pcm)).to_bytes(4, "little") + b"WAVE"
            + b"fmt " + (16).to_bytes(4, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(2, "little") + sr.to_bytes(4, "little")
            + (4 * sr).to_bytes(4, "little") + (4).to_bytes(2, "little")
            + (32).to_bytes(2, "little") + b"data"
            + len(pcm).to_bytes(4, "little") + pcm)


@pytest.mark.parametrize("name", ["hindi_01.mp3", "hindi_01.ogg"])
def test_mp3_and_ogg_uploads_answer_as_a_wav_of_their_decode(url, name):
    """An MP3 or Ogg Vorbis upload answers the body of a float32 WAV
    upload of the port's own decode of the same file."""
    with open(os.path.join(ROOT, "compressed", name), "rb") as f:
        data = f.read()
    audio, sr = decode_audio(data)
    status, body = _post(url, data)
    assert status == 200 and body["text"]
    assert (status, body) == _post(url, _float_wav(audio, sr))


@pytest.mark.parametrize("upload", ["empty", "garbage"])
def test_undecodable_upload_with_timestamps_answers_422(url, upload):
    """The upload is decoded before ``return_timestamps`` is looked at, as
    the JAX server does: audio that cannot be decoded answers 422
    AUDIO_DECODE_FAILED with its size, not 501."""
    data = b"" if upload == "empty" else b"not audio at all" * 8
    status, body = _post(url, data, [("return_timestamps", "true")])
    assert status == 422 and body["code"] == "AUDIO_DECODE_FAILED"
    assert body["statusCode"] == 422
    assert body["context"]["fileSize"] == len(data)
    if data:
        with pytest.raises(JaxDecodeError):
            jax_decode_audio(data)


def test_concurrent_uploads_share_one_dispatch(engine):
    """Four uploads of the 10 s bucket at once: all 200, with the solo
    path's texts, from fewer dispatches than uploads."""
    names = ["cantonese_01", "chinese_02", "english_02", "thai_02"]
    data = {}
    for n in names:
        with open(os.path.join(ROOT, "real", n + ".wav"), "rb") as f:
            data[n] = f.read()
    manager = ModelManager(engine)
    manager.batcher = MicroBatcher(manager, window_ms=2000, max_batch=8)
    replies = {}
    with serving(manager) as u:
        threads = [threading.Thread(
            target=lambda n=n: replies.__setitem__(n, _post(u, data[n])))
            for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    assert manager.batcher.dispatches < len(names)
    for n in names:
        text, lang = merge_results(engine.transcribe(*decode_audio(data[n])))
        assert replies[n] == (200, {"text": detect_and_fix_repetitions(text),
                                    "language": lang})


def test_request_timeout_answers_504(engine):
    manager = ModelManager(engine)
    manager.request_timeout = 0.3
    gate = threading.Event()
    data = encode_wav(np.zeros(8000, np.float32), 16000)
    with serving(manager) as u:
        held = manager.queue.submit(lambda: gate.wait(30))  # device busy
        t0 = time.monotonic()
        status, body = _post(u, data)
        gate.set()
        held.result(timeout=30)
    assert status == 504 and time.monotonic() - t0 < 30
    assert body["code"] == "TRANSCRIPTION_TIMEOUT"
    assert body["statusCode"] == 504
    assert body["context"]["elapsed"] >= 0.3


def _get(url, path, headers=None):
    req = urllib.request.Request(url + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def test_every_response_carries_a_request_id(url):
    """The request's own X-Request-ID comes back; without one, a fresh id
    (as the JAX middleware does, ``qwen3_asr_tpu/serving/http.py:36-44``),
    on routing errors too."""
    status, headers, _ = _get(url, "/health", {"X-Request-ID": "req-42"})
    assert status == 200 and headers["X-Request-ID"] == "req-42"
    status, headers, _ = _get(url, "/health")
    assert status == 200 and uuid.UUID(headers["X-Request-ID"])
    status, headers, _ = _get(url, "/nowhere", {"X-Request-ID": "r-404"})
    assert status == 404 and headers["X-Request-ID"] == "r-404"
    req = urllib.request.Request(url + "/v1/audio/transcriptions", data=b"",
                                 method="POST",
                                 headers={"X-Request-ID": "r-422"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 422 and e.value.headers["X-Request-ID"] == "r-422"


def test_health_reports_memory_and_keys(engine):
    """/health carries the JAX package's memory-gate fields; serving one
    shape again and again mints no new key."""
    with open(os.path.join(ROOT, "real", "english_02.wav"), "rb") as f:
        data = f.read()
    with serving(ModelManager(engine)) as u:
        counts = []
        for _ in range(3):
            assert _post(u, data)[0] == 200
            _, _, body = _get(u, "/health")
            counts.append(body["executable_count"])
    assert body["model_id"] == CKPT
    # off the card neither HBM key is sent (JAX sends them only where the
    # device has memory stats), so the memory gate reads device_arrays_mb
    assert "hbm_used_mb" not in body and "hbm_limit_mb" not in body
    params_mb = sum(x.numel() * x.element_size() for x in jax.tree.leaves(
        engine.model.params)) / 1024 ** 2
    assert body["device_arrays_mb"] >= round(params_mb)
    assert counts[0] >= 1 and counts == [counts[0]] * 3
    assert counts[0] == len(engine.executables) + len(engine._stream_fns)
    # JAX's keys: the parameter count of the same checkpoint, the device
    # kind and the device count
    _, jparams = jax_load(CKPT, dtype=jnp.float32, cache=False)
    assert body["model_params_m"] == round(sum(
        x.size for x in jax.tree.leaves(jparams)) / 1e6, 1)
    assert body["device"] == "cpu" and body["num_devices"] == 1


def test_health_counts_stream_state_groups_and_the_aligner(engine,
                                                           monkeypatch):
    """``device_arrays_mb`` adds a prefix session's stashed state (two
    sessions of one workspace in turns), a group's workspace and stashed
    state (two one-slot groups of one key in turns) and a loaded aligner's
    weights (none for an aligner on the engine's own weights);
    ``executable_count`` grows by the stream keys built and the live
    groups, and the groups leave it when their members do."""
    from qwen3_asr_tpu_torch.serving import server as server_mod
    from qwen3_asr_tpu_torch.sidecars import subtitle
    from qwen3_asr_tpu_torch.sidecars.aligner import AlignerEngine
    mgr = ModelManager(engine)
    with open(os.path.join(ROOT, "real", "english_01.wav"), "rb") as f:
        window = decode_audio(f.read())[0][:16000].astype(np.float32)

    def added(fn):
        """(bytes, executable count) that ``fn`` adds, and the keys it
        built."""
        keys, b0 = set(engine._stream_fns), server_mod.device_bytes(mgr)
        c0 = engine.executable_count
        out = fn()
        new = [k for k in engine._stream_fns if k not in keys]
        return (server_mod.device_bytes(mgr) - b0,
                engine.executable_count - c0, new, out)

    def two_sessions():
        a, b = (engine.stream_session(30.0, "en") for _ in range(2))
        for s in (a, b):
            mgr.register_stream_session(s)
            s.update(window)        # b's tick stashes a's state
        return a, b
    grown, count, new, (a, b) = added(two_sessions)
    fns = engine._stream_fns
    assert a.held_bytes() == a.work.state_bytes() > 0 == b.held_bytes()
    assert grown == sum(fns[k].nbytes() for k in new
                        if hasattr(fns[k], "nbytes")) + a.held_bytes()
    assert count == len(new) and any(k[0] == "state" for k in new)

    def two_groups():
        members = [engine.stream_group_member(30.0, "en", slots=1)
                   for _ in range(2)]
        for m in members:
            mgr.register_stream_session(m)
            m.update(window)        # the second group stashes the first's
        return members
    grown, count, new, (m1, m2) = added(two_groups)
    g1, g2 = m1.group, m2.group
    assert g1 is not g2 and g1.work is g2.work
    assert g1.held_bytes() == g1.work.state_bytes() > 0 == g2.held_bytes()
    assert m1.held_bytes() == 0 and any(k[0] == "gstate" for k in new)
    assert grown == sum(fns[k].nbytes() for k in new
                        if hasattr(fns[k], "nbytes")) + g1.held_bytes()
    assert count == len(new) + 2          # the keys and the two groups

    other = load_engine(CKPT, device="cpu").model
    monkeypatch.setattr(subtitle, "_aligner", AlignerEngine(other))
    grown, _, _, _ = added(lambda: None)
    assert subtitle.aligner_bytes(engine.model.params) == sum(
        x.numel() * x.element_size() for x in jax.tree.leaves(other.params))
    monkeypatch.setattr(subtitle, "_aligner", AlignerEngine(engine.model))
    assert subtitle.aligner_bytes(engine.model.params) == 0

    with serving(mgr) as u:
        _, _, body = _get(u, "/health")
        assert body["device_arrays_mb"] == round(
            server_mod.device_bytes(mgr) / 1024 ** 2)
        assert body["executable_count"] == engine.executable_count
    count = engine.executable_count
    before, stashes = server_mod.device_bytes(mgr), (a.held_bytes()
                                                     + g1.held_bytes())
    for s in (a, b, m1, m2):
        s.release()
    # the keys stay; the groups and every stashed state go
    assert engine.executable_count == count - 2
    assert before - server_mod.device_bytes(mgr) == stashes


def test_chunked_upload_reads_whole(url):
    """An upload sent with Transfer-Encoding: chunked gives the answer the
    same bytes give with a Content-Length."""
    import http.client
    with open(os.path.join(ROOT, "real", "english_01.wav"), "rb") as f:
        data = f.read()
    bnd = uuid.uuid4().hex
    body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\n\r\n").encode() + data + \
        f"\r\n--{bnd}--\r\n".encode()
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    conn.request("POST", "/v1/audio/transcriptions",
                 body=(body[i:i + 4096] for i in range(0, len(body), 4096)),
                 headers={"Content-Type":
                          f"multipart/form-data; boundary={bnd}"},
                 encode_chunked=True)
    resp = conn.getresponse()
    chunked = (resp.status, json.loads(resp.read()))
    conn.close()
    assert chunked == _post(url, data)
    assert chunked[0] == 200 and chunked[1]["text"]
