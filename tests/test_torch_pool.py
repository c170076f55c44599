"""The port's decode pool (``qwen3_asr_tpu_torch/runtime/pool.py``) against
the JAX package's, in f32 on the CPU.

Every clip of this file goes through the JAX fused engine and through one
JAX ``DecodePool`` (slots 4 growing to 8, segments of 6, so its window
grows, shrinks and compacts), on the tiny checkpoint of
``tests/fixtures.py`` carried over by ``params_from_jax``; the real clips
also on ``e2e/data/trained_ckpt``. The port's pool must give the same
token ids and texts, exactly, in each test's own schedule. Then one
counterpart of each test of ``tests/test_pool.py`` but the mesh one (the
port has no mesh), the server with ``ASR_CONTINUOUS_BATCHING=true`` over
HTTP and WS, and the window's re-layout of the flat cache.

Every wait is bounded (at most 60 s) and every pool is stopped in
``finally``, so a hung pool fails its test instead of hanging the run."""
import glob
import json
import os
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint as jax_load
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.runtime.pool import DecodePool as JaxPool
from qwen3_asr_tpu.text.repetition import detect_and_fix_repetitions
from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
from qwen3_asr_tpu_torch.audio.codec import decode_audio, encode_wav
from qwen3_asr_tpu_torch.models.asr import AsrModel, PromptTemplate
from qwen3_asr_tpu_torch.models.config import AsrConfig
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
from qwen3_asr_tpu_torch.runtime.pool import (DecodePool, PoolStoppedError,
                                              _Request)
from qwen3_asr_tpu_torch.serving import ws as ws_mod
from qwen3_asr_tpu_torch.serving.server import build_server
from qwen3_asr_tpu_torch.text.tokenizer import BpeTokenizer
from tests.fixtures import load_tiny_model, write_tiny_checkpoint
from tests.util_audio import speech_like, tone

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
REAL = sorted(glob.glob(os.path.join(ROOT, "real", "*.wav")))
WAIT = 60


def _s16(audio):
    return np.clip(audio * 32767, -32768, 32767).astype(np.int16)


def _clip_sets():
    """Each test's clips: name -> [(audio, language)]."""
    rng = np.random.default_rng(0)
    return {
        "parity": [(speech_like(0.8, seed=1), "en"),
                   (speech_like(2.5, seed=2), "en"),
                   (speech_like(1.2, seed=3), "zh"),
                   (_s16(speech_like(0.9, seed=4)), "en"),   # wire s16
                   (tone(1.5, 440.0), None)],                # language auto
        "join": [(speech_like(3.0, seed=7), "en"),
                 (speech_like(0.7, seed=8), "en")],
        "over": [(speech_like(0.6 + 0.2 * i, seed=10 + i), "en")
                 for i in range(5)],
        "single": [(speech_like(0.5 + 0.3 * i, seed=30 + i), "en")
                   for i in range(4)],
        "staggered": [(speech_like(1.1 + 0.4 * i, seed=40 + i), "en")
                      for i in range(3)],
        "churn": [(speech_like(float(rng.uniform(0.4, 2.5)), seed=20 + i),
                   "en" if i % 2 else "zh") for i in range(12)],
        "grow": [(speech_like(0.5 + 0.15 * i, seed=60 + i), "en")
                 for i in range(6)],
        "shrink": ([(speech_like(0.5, seed=70 + i), "en") for i in range(5)]
                   + [(speech_like(22.0, seed=80), "en")]),
        "server": [(speech_like(1.0, seed=s), "en") for s in range(3)],
    }


def _jax_pool_run(jax_engine, clips, **shape):
    """Every clip at once through a JAX DecodePool: [(text, ids)]."""
    results, done = {}, threading.Event()
    pool = JaxPool(jax_engine, **shape)
    try:
        for i, (audio, lang) in enumerate(clips):
            def ok(text, ids, i=i):
                results[i] = (text, ids)
                if len(results) == len(clips):
                    done.set()

            def err(e, i=i):
                results[i] = e
                done.set()
            pool.submit(audio, lang, ok, err)
        assert done.wait(timeout=WAIT), "the JAX pool timed out"
    finally:
        pool.stop()
    return [results[i] for i in range(len(clips))]


class Refs:
    """The JAX fused engine's and the JAX pool's (text, ids) per clip."""

    def __init__(self, jax_engine, sets, **shape):
        self.sets = sets
        flat = [c for clips in sets.values() for c in clips]
        fused = [jax_engine.transcribe(a, 16000, language=l)[0]
                 for a, l in flat]
        pooled = _jax_pool_run(jax_engine, flat, **shape)
        self.fused, self.pooled, i = {}, {}, 0
        for name, clips in sets.items():
            n = len(clips)
            self.fused[name] = [(r.text, r.token_ids)
                                for r in fused[i:i + n]]
            self.pooled[name] = pooled[i:i + n]
            i += n
        # the JAX pool is the JAX fused engine's, as tests/test_pool.py holds
        assert self.pooled == self.fused

    def check(self, name, got, idx=None):
        """``got``: the port pool's (text, ids) per clip of set ``name``
        (or of its clips ``idx``)."""
        want = self.fused[name]
        if idx is not None:
            want = [want[i] for i in idx]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"{name} clip {i}: port pool {g} vs JAX {w}"


def _port_model(path, jax_params):
    return AsrModel(AsrConfig.from_json(os.path.join(path, "config.json")),
                    params_from_jax(jax.device_get(jax_params), "cpu"),
                    BpeTokenizer.from_file(os.path.join(path,
                                                        "tokenizer.json")),
                    PromptTemplate.from_checkpoint(path))


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(the tiny checkpoint's path, the port's engine, the JAX engine)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    write_tiny_checkpoint(path)
    jax_model = load_tiny_model(path)
    jax_engine = JaxEngine(jax_model, dtype=jnp.float32)
    engine = TranscriptionEngine(_port_model(path, jax_model.params),
                                 device="cpu")
    return path, engine, jax_engine


@pytest.fixture(scope="module")
def engine(tiny):
    return tiny[1]


@pytest.fixture(scope="module")
def refs(tiny):
    return Refs(tiny[2], _clip_sets(), slots=4, segment=6, max_slots=8)


def _collect(pool, clips, gap_s=0.0):
    """Submit every clip (``gap_s`` apart); {index: (text, ids)}."""
    done = threading.Event()
    results = {}

    def make_cb(i):
        def ok(text, ids):
            results[i] = ("ok", text, ids)
            if len(results) == len(clips):
                done.set()

        def err(e):
            results[i] = ("err", e, None)
            done.set()
        return ok, err

    for i, (audio, lang) in enumerate(clips):
        pool.submit(audio, lang, *make_cb(i))
        time.sleep(gap_s)
    assert done.wait(timeout=WAIT), f"pool timed out: {sorted(results)}"
    for i, r in results.items():
        assert r[0] == "ok", f"request {i}: {r[1]}"
    return [results[i][1:] for i in range(len(clips))]


def _run(engine, name, refs, **shape):
    clips = refs.sets[name]
    pool = DecodePool(engine, **shape)
    try:
        got = _collect(pool, clips)
    finally:
        pool.stop()
    refs.check(name, got)
    return pool


# -- parity with the JAX package ----------------------------------------------

def test_pool_matches_jax_pool_and_fused_engine(engine, refs):
    _run(engine, "parity", refs, slots=4, segment=6)


def test_pool_matches_jax_on_trained_ckpt():
    """The 12 real clips at once on trained_ckpt (f32): the port's pool, the
    JAX pool and the JAX fused engine give the same token ids and texts,
    and the port's are the reference transcripts."""
    cfg, params = jax_load(CKPT, dtype=jnp.float32, cache=False)
    jax_engine = JaxEngine(JaxModel(
        cfg, params, JaxTokenizer.from_file(os.path.join(CKPT,
                                                         "tokenizer.json")),
        JaxTemplate.from_checkpoint(CKPT)), dtype=jnp.float32)
    clips = []
    for path in REAL:
        with open(path, "rb") as f:
            clips.append((decode_audio(f.read())[0], None))
    refs = Refs(jax_engine, {"real": clips}, slots=4, segment=16)
    engine = TranscriptionEngine(_port_model(CKPT, params), device="cpu")
    _run(engine, "real", refs, slots=4, segment=16, max_slots=8)
    for path, (text, _) in zip(REAL, refs.fused["real"]):
        with open(path[:-4] + ".txt", encoding="utf-8") as f:
            assert text == f.read().strip()


# -- the counterparts of tests/test_pool.py -----------------------------------

def test_pool_mid_flight_join(engine, refs):
    """A request arriving while another decodes joins at the next segment
    boundary, and both finish right."""
    clips = refs.sets["join"]
    pool = DecodePool(engine, slots=2, segment=4)
    try:
        got = _collect(pool, clips, gap_s=0.3)
    finally:
        pool.stop()
    refs.check("join", got)


def test_pool_more_requests_than_slots(engine, refs):
    _run(engine, "over", refs, slots=2, segment=5)


def test_pool_single_slot_reuse(engine, refs):
    """slots=1 (window 1, kernel #2's plain path): every request through
    the retire -> re-admit cycle while the previous occupant's pipelined
    segment is still in flight; the admission generation keeps them
    apart."""
    _run(engine, "single", refs, slots=1, segment=4)


def test_pool_staggered_submissions(engine, refs):
    """Requests trickling in while segments are in flight: overlapped
    admission (the state joined on the device, the first token read at
    the slot's first drain) on every one."""
    clips = refs.sets["staggered"]
    pool = DecodePool(engine, slots=4, segment=3)
    try:
        got = _collect(pool, clips, gap_s=0.4)
    finally:
        pool.stop()
    refs.check("staggered", got)


def test_pool_int4_engine_takes_an_fp8_cache(monkeypatch):
    """An int4 engine's pool cache is fp8, with no scale planes, as JAX's
    is (ROADMAP §3), and decodes as JAX's pool does: on a head_dim-128
    decoder (``hd128_models``), every step through the batched kernel (its
    plain version here, the TPU kernel in interpret mode in JAX), the
    tokens equal the JAX pool's."""
    from tests.test_torch_engine import hd128_models
    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    jax_model, model = hd128_models()
    jax_engine = JaxEngine(jax_model, dtype=jnp.float32,
                           cache_dtype=jnp.int4)
    engine = TranscriptionEngine(model, device="cpu", cache_dtype=torch.int4)
    clips = []
    for i in (5, 11, 2):
        with open(REAL[i], "rb") as f:
            clips.append((decode_audio(f.read())[0][:24000], None))
    want = _jax_pool_run(jax_engine, clips, slots=2, segment=4)
    pool = DecodePool(engine, slots=2, segment=4)
    try:
        assert pool.cache_dtype == torch.float8_e4m3fn
        for view in pool._views.values():
            assert view.k.dtype == torch.float8_e4m3fn
            assert view.k_scale is None and view.v_scale is None
        got = _collect(pool, clips)
    finally:
        pool.stop()
    assert got == want
    assert all(len(set(ids)) >= 3 for _, ids in got)


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
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def test_pool_serving_integration(engine, refs, monkeypatch):
    """The port's server with ``ASR_CONTINUOUS_BATCHING=true``,
    ``ASR_POOL_SLOTS=4`` and ``ASR_POOL_WS=true``: 3 concurrent uploads
    answer JAX's text through the pool; ``/health`` gives slots 16 (the
    env slots are the autoscale base, 4x headroom) and window 4; a WS
    partial and flush go through the pool too. No fused key is built."""
    monkeypatch.setenv("SKIP_WARMUP", "true")
    monkeypatch.setenv("ASR_CONTINUOUS_BATCHING", "true")
    monkeypatch.setenv("ASR_POOL_SLOTS", "4")
    monkeypatch.setenv("ASR_POOL_WS", "true")
    manager = ModelManager(engine)
    manager.start()
    server = build_server(manager, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    keys = len(engine.executables)
    try:
        pool = manager.pool
        assert pool is not None and pool.max_slots == 16
        replies = {}
        clips = refs.sets["server"]
        posts = [threading.Thread(target=lambda i=i, a=a: replies.__setitem__(
            i, _post(url, encode_wav(a, 16000), [("language", "en")])))
            for i, (a, _) in enumerate(clips)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        for i, (text, _) in enumerate(refs.fused["server"]):
            assert replies[i] == (200, {
                "text": detect_and_fix_repetitions(text), "language": "en"})
        assert pool.admitted == 3

        with urllib.request.urlopen(url + "/health", timeout=WAIT) as r:
            health = json.loads(r.read())
        assert health["continuous_batching"] == {"slots": 16, "window": 4,
                                                 "depth": 0}
        assert health["executable_count"] == pool.executable_count + keys
        assert health["device_arrays_mb"] >= round(
            pool.held_bytes() / 1024 ** 2)

        ws = ws_mod.connect(url.replace("http", "ws")
                            + "/ws/transcribe?use_server_vad=false",
                            timeout=WAIT)
        try:
            ws.receive_json(timeout=WAIT)
            ws.send_bytes(_s16(speech_like(0.9, seed=5)).astype(
                "<i2").tobytes())
            partial = ws.receive_json(timeout=WAIT)
            assert partial.get("is_partial") is True
            ws.send_json({"action": "flush"})
            final = ws.receive_json(timeout=WAIT)
            while not final.get("is_final"):
                final = ws.receive_json(timeout=WAIT)
            assert "text" in final
        finally:
            ws.close()
        assert pool.admitted == 5             # the partial and the flush
        assert len(engine.executables) == keys
    finally:
        server.shutdown()
        server.server_close()
        manager.stop()
        thread.join(timeout=WAIT)
    assert manager.pool is None and not thread.is_alive()


def test_request_that_meets_a_stopped_pool_takes_the_fused_path(
        engine, refs, monkeypatch):
    """``transcribe_pooled`` on a pool that has stopped (PoolStoppedError)
    serves the request on the fused path, with JAX's answer, as JAX's
    ``_pooled_fallback`` does; a request that cannot pool never meets the
    pool."""
    monkeypatch.setenv("SKIP_WARMUP", "true")
    monkeypatch.setenv("ASR_CONTINUOUS_BATCHING", "true")
    manager = ModelManager(engine)
    manager.start()
    try:
        pool = manager.pool
        pool.stop()
        audio, lang = refs.sets["server"][0]
        got = manager.batcher.transcribe(audio, 16000, lang).result(
            timeout=WAIT)
        assert [(r.text, r.token_ids) for r in got] == \
            [refs.fused["server"][0]]
        assert not manager.pool_eligible(audio, 16000, True)
        assert not manager.pool_eligible(np.stack([audio, audio], 1),
                                         16000, False)
        assert not manager.pool_eligible(audio, 8000, False)
        assert not manager.pool_eligible(np.zeros(31 * 16000, np.float32),
                                         16000, False)
        assert pool.admitted == 0
    finally:
        manager.stop()


def test_pool_churn_stress(engine, refs):
    """12 requests of mixed sizes and languages through 3 slots at
    segments of 3: constant admission and retirement churn."""
    _run(engine, "churn", refs, slots=3, segment=3)


def test_pool_autoscale_grows_window(engine, refs):
    """A burst beyond the base window grows it instead of queueing."""
    clips = refs.sets["grow"]
    pool = DecodePool(engine, slots=2, segment=4, max_slots=8)
    assert pool._sizes == [2, 4, 8]
    used, real = set(), pool._decode_segment_fn
    pool._decode_segment_fn = lambda w: (used.add(w), real(w))[1]
    try:
        got = _collect(pool, clips)
    finally:
        pool.stop()
    assert any(w > 2 for w in used), f"window never grew: {used}"
    refs.check("grow", got)


def test_pool_autoscale_shrinks_and_compacts(engine, refs):
    """Short requests retire while a long straggler admitted at a high row
    decodes on: it is compacted into a low row and the window shrinks
    back; its text survives the row move (and the re-layouts) exactly,
    and a follow-up request still works."""
    clips = refs.sets["shrink"]
    pool = DecodePool(engine, slots=2, segment=4, max_slots=8)
    try:
        got = _collect(pool, clips)
        assert pool.moved, "compaction never ran"
        assert pool.window < 8, f"window stuck at {pool.window}"
        again = _collect(pool, clips[:1])
    finally:
        pool.stop()
    refs.check("shrink", got)
    refs.check("shrink", again, idx=[0])


def test_pool_explicit_slots_stays_fixed(engine):
    """slots= without max_slots= pins the pool; the env default gets 4x
    headroom."""
    pool = DecodePool(engine, slots=3, segment=4)
    try:
        assert pool.max_slots == 3 and pool._sizes == [3]
    finally:
        pool.stop()


def test_pool_depth_covers_admission(engine, refs):
    """depth counts a request from submit() until it is slotted, while its
    admission is held open (a slowed prefill)."""
    pool = DecodePool(engine, slots=2, segment=4)
    orig = pool._prefill_fn

    def slow_prefill(bucket_frames):
        time.sleep(1.5)
        return orig(bucket_frames)

    pool._prefill_fn = slow_prefill
    done = threading.Event()
    out = {}
    audio, lang = refs.sets["shrink"][0]
    try:
        pool.submit(audio, lang,
                    lambda t, ids: (out.setdefault("t", (t, ids)),
                                    done.set()),
                    lambda e: (out.setdefault("e", e), done.set()))
        t0 = time.time()
        while time.time() - t0 < 1.2:
            assert pool.depth >= 1, "in-flight request invisible to depth"
            time.sleep(0.05)
        assert done.wait(timeout=WAIT)
        assert "t" in out, out.get("e")
    finally:
        pool.stop()
    refs.check("shrink", [out["t"]], idx=[0])


def test_pool_recovers_after_segment_failure(engine, refs):
    """A failed segment errors each in-flight request once, resets the
    cache and the state, and the pool goes on serving."""
    pool = DecodePool(engine, slots=2)
    audio, lang = refs.sets["shrink"][0]
    try:
        real = pool._decode_segment_fn
        blew = threading.Event()

        def exploding(window):
            fn = real(window)

            def run(*args, **kw):
                if not blew.is_set():
                    blew.set()
                    raise RuntimeError("injected segment failure")
                return fn(*args, **kw)
            return run

        pool._decode_segment_fn = exploding
        errors = []
        done = threading.Event()
        pool.submit(audio, lang,
                    lambda t, ids: (errors.append(("ok", t)), done.set()),
                    lambda e: (errors.append(("err", str(e))), done.set()))
        assert done.wait(timeout=WAIT)
        time.sleep(0.5)   # would catch a straggling double callback
        assert errors == [("err", "injected segment failure")]
        assert not pool.active.any() and pool.depth == 0

        pool._decode_segment_fn = real
        got = _collect(pool, [(audio, lang)])
    finally:
        pool.stop()
    refs.check("shrink", got, idx=[0])


@pytest.mark.parametrize("audio", [speech_like(0.5, seed=71),
                                   np.zeros(160, np.float32)],
                         ids=["speech", "short"])
def test_pool_submit_after_stop_fails_fast(engine, audio):
    """A submit after stop() resolves at once with PoolStoppedError, never
    hangs."""
    pool = DecodePool(engine, slots=1, segment=2)
    pool.stop()
    got = []
    pool.submit(audio, None, lambda t, ids: got.append(("ok", t)),
                lambda e: got.append(("err", e)))
    assert len(got) == 1 and got[0][0] == "err"
    assert isinstance(got[0][1], PoolStoppedError)
    assert str(got[0][1]) == "decode pool stopped"


def test_pool_retire_stops_at_pad_and_eos(engine):
    """pad_id is an alternate end-of-text: retire cuts the ids at whichever
    of pad and EOS comes first."""
    pool = DecodePool(engine, slots=1, segment=2)
    try:
        got = {}

        def claim(tag):
            pool._owner[0] = _Request(
                np.zeros(1, np.float32), None,
                lambda text, ids: got.__setitem__(tag, (text, ids)),
                lambda e: got.__setitem__(tag, ("err", e)))

        pad, eos = pool.model.pad_id, pool.model.eos_id
        some = [t for t in range(32) if t not in (pad, eos)][:3]
        claim("mid_pad")
        pool._tokens[0] = [some[0], pad, some[1]]
        pool._retire(0)
        claim("first_pad")
        pool._tokens[0] = [pad, some[2]]
        pool._retire(0)
        claim("eos")
        pool._tokens[0] = [some[0], eos, some[1]]
        pool._retire(0)
        assert got["mid_pad"][1] == [some[0]]
        assert got["first_pad"][1] == []
        assert got["eos"][1] == [some[0]]
    finally:
        pool.stop()


# -- the port's own: the flat cache's window layout ---------------------------

@pytest.mark.parametrize("moves", [(3, 6, 8, 3), (2, 4, 8, 4, 2)],
                         ids=["ladder_3_6_8", "ladder_2_4_8"])
def test_relayout_keeps_every_occupied_row(engine, moves):
    """Growing and shrinking the window re-lays rows [0, keep) of every
    layer into the new window's view, bytes intact, whatever the ladder
    (3 -> 6 -> 8 overlaps a layer's old and new blocks)."""
    pool = DecodePool(engine, slots=moves[0], segment=2,
                      max_slots=max(moves))
    try:
        keep = min(moves)
        with torch.inference_mode():
            rows = pool._views[moves[0]].k[:, :keep]
            want = torch.randn(rows.shape).to(rows.dtype)
            rows.copy_(want)
            pool._views[moves[0]].v[:, :keep].copy_(-want)
            for w in moves[1:]:
                pool._relayout(w, keep)
                assert pool.window == w
                assert torch.equal(pool._views[w].k[:, :keep], want)
                assert torch.equal(pool._views[w].v[:, :keep], -want)
    finally:
        pool.stop()
