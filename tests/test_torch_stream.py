"""WS prefix caching in the port (``qwen3_asr_tpu_torch/runtime/stream.py``)
against the JAX package's ``runtime/stream.py``, on the CPU in f32.

The tiny checkpoint of ``tests/fixtures.py`` loads into the JAX engine and,
through ``params_from_jax``, into the port's; the same numpy-seeded audio
goes through the JAX ``StreamSession``, the port's, and the port's fused
resume path at the pinned bucket (``_run_bucket`` with the previous
tick's ids), tick for tick: the token ids and texts are identical, and so
are the sessions' stats (ticks, tail, full, redo). The patterns are those
of ``tests/test_stream.py``: chunk-quantized trims, sample-exact trims,
the clamp-max jump and its redo, the shrink across a block edge at 8.5 s,
windows whose frontier lands near a block edge, reset and an empty window.
Then what the port adds: ``BucketPlan`` and the block encoder against
JAX's, an int4 engine's fp8 session cache against JAX's session on a
head_dim-128 decoder, a tick after a longer one with every key past the
prompt poisoned, two interleaved sessions (the working buffers' hand-over)
against their solo runs, and a failed tick."""
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.runtime.stream import BucketPlan as JaxPlan
from qwen3_asr_tpu_torch.models.asr import AsrModel, PromptTemplate
from qwen3_asr_tpu_torch.models.config import AsrConfig, preset
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
from qwen3_asr_tpu_torch.runtime.stream import BucketPlan, encode_block
from qwen3_asr_tpu_torch.text.tokenizer import BpeTokenizer
from tests.fixtures import load_tiny_model, write_tiny_checkpoint
from tests.util_audio import speech_like

CAP_S = 6.0
TICK_S = 0.45
SR = 16000


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_model(path, jax_params):
    return AsrModel(AsrConfig.from_json(os.path.join(path, "config.json")),
                    params_from_jax(jax.device_get(jax_params), "cpu"),
                    BpeTokenizer.from_file(os.path.join(path,
                                                        "tokenizer.json")),
                    PromptTemplate.from_checkpoint(path))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(the JAX engine, the port's engine) on one tiny checkpoint, f32."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    write_tiny_checkpoint(path)
    jax_model = load_tiny_model(path)
    return (JaxEngine(jax_model, dtype=jnp.float32),
            TranscriptionEngine(_port_model(path, jax_model.params),
                                device="cpu"))


def fused(engine, window, language, prev, cap_s=CAP_S):
    """The port's fused resume path at the PINNED cap bucket."""
    frames, bucket_s = engine.bucket_frames(int(cap_s * SR))
    texts, ids = engine._run_bucket([window.astype(np.float32)], frames,
                                    bucket_s, language,
                                    resume_tokens=list(prev))
    return texts[0], ids[0]


class Trio:
    """One stream through the JAX session, the port's session and the
    port's fused path: ``tick`` asserts all three agree."""

    def __init__(self, engines, cap_s=CAP_S, language="en"):
        jax_eng, eng = engines
        self.jax = jax_eng.stream_session(cap_s, language)
        self.port = eng.stream_session(cap_s, language)
        self.eng, self.cap_s, self.language = eng, cap_s, language
        self.prev = []

    def tick(self, window, where=""):
        jtext, jids = self.jax.update(window)
        text, ids = self.port.update(window)
        ftext, fids = fused(self.eng, window, self.language, self.prev,
                            self.cap_s)
        assert ids == jids == fids, (
            f"{where}: port {ids} JAX {jids} fused {fids} "
            f"(port {self.port.stats}, JAX {self.jax.stats})")
        assert text == jtext == ftext
        assert self.port.stats == self.jax.stats, where
        self.prev = ids
        return ids


def run_paced(trio, audio, trim_quantum):
    """450 ms ticks over sliding windows trimmed in ``trim_quantum``
    samples at the cap, every tick checked."""
    cap = int(trio.cap_s * SR)
    tick = int(TICK_S * SR)
    window = np.zeros(0, np.float32)
    for off in range(0, len(audio), tick):
        window = np.concatenate([window, audio[off:off + tick]])
        if len(window) > cap:
            trim = len(window) - cap
            if trim_quantum > 1:
                trim = -(-trim // trim_quantum) * trim_quantum
            window = window[trim:]
        trio.tick(window, f"tick@{off}")
    return trio.port.stats


# -- the geometry and the block encoder --------------------------------------------

@pytest.mark.parametrize("cap_s", [1.0, 6.0, 8.5, 30.0])
def test_bucket_plan_matches_jax(engines, cap_s):
    jax_eng, eng = engines
    ours, ref = BucketPlan(eng, cap_s), JaxPlan(jax_eng, cap_s)
    for name in ("pinned_frames", "bucket_s", "pinned_samples",
                 "chunk_frames", "spans", "block_tokens", "max_new",
                 "prefix_budget", "prompt_len", "seg_starts", "s_pad"):
        assert getattr(ours, name) == getattr(ref, name), name
    for s in (0, 1599, 16000, ours.pinned_samples - 1):
        assert ours.block_of_sample(s) == ref.block_of_sample(s)


def _plan_stub(jax_side: bool):
    """An engine as far as ``BucketPlan`` reads it, at preset:1.7b's
    encoder and the builtin prompt's 14 suffix tokens."""
    from qwen3_asr_tpu.models.config import preset as jax_preset
    cfg = (jax_preset if jax_side else preset)("1.7b")
    eng = types.SimpleNamespace(model=types.SimpleNamespace(cfg=cfg))
    eng.bucket_frames = TranscriptionEngine.bucket_frames.__get__(eng)
    eng._chunk_frames = cfg.encoder.n_window * 2
    eng._suffix = eng._suffix_ids = list(range(14))
    return eng


def test_bucket_plan_at_preset_1_7b_30s():
    """The full-width geometry at a 30 s cap: 3000 frames in 7 blocks of
    400 frames (50 tokens) and one of 200 (25), P = 64 + 375 + 14 = 453,
    256 new tokens, a cache of 768, and the rungs of JAX's ladder."""
    ours, ref = BucketPlan(_plan_stub(False), 30.0), JaxPlan(
        _plan_stub(True), 30.0)
    assert ours.pinned_frames == ref.pinned_frames == 3000
    assert ours.spans == ref.spans
    assert ours.block_tokens == ref.block_tokens == [50] * 7 + [25]
    assert ours.prompt_len == ref.prompt_len == 453
    assert ours.max_new == ref.max_new == 256
    assert ours.s_pad == ref.s_pad == 768
    assert ours.seg_starts == ref.seg_starts == [0, 64, 69, 133, 197, 261,
                                                 325, 389]


@pytest.mark.parametrize("cap_s,block,clamp", [
    (6.0, 0, -3.25), (6.0, 2, 0.5), (8.5, 4, -1.0), (1.0, 0, -2.0)])
def test_encode_block_matches_jax(engines, cap_s, block, clamp):
    """The same haloed samples and clamp through JAX's ``("encode",
    frames)`` executable and the port's ``encode_block``: tokens within
    1e-5, the raw max within 1e-6. (The 1 s bucket's one block is a single
    chunk, half a block.)"""
    jax_eng, eng = engines
    plan = BucketPlan(eng, cap_s)
    lo, hi = plan.spans[block]
    audio = speech_like(cap_s, seed=block + 3).astype(np.float32)
    padded = np.zeros(plan.pinned_samples, np.float32)
    padded[:len(audio)] = audio[:plan.pinned_samples]
    halo = np.pad(padded, 200, mode="reflect")
    seg = halo[lo * 160:(hi - 1) * 160 + 400]
    want, want_max = jax_eng._stream_fn(("encode", hi - lo))(
        jax_eng.model.params, jnp.asarray(seg), jnp.float32(clamp))
    got, got_max = encode_block(eng, torch.from_numpy(seg),
                                torch.tensor(clamp, dtype=torch.float32),
                                hi - lo)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_max), float(want_max), rtol=0,
                               atol=1e-6)


# -- paced sessions: the port = JAX = the fused path -----------------------------

@pytest.mark.parametrize("pattern", ["chunk_trim", "sample_exact_trim",
                                     "clamp_max_jump"])
def test_paced_session_matches_jax_and_fused(engines, pattern):
    """Chunk-quantized trims (tail ticks at the cap), sample-exact trims
    (a rebuild every tick at the cap) and quiet speech then a loud burst
    (the optimistic clamp fails: a redo)."""
    trio = Trio(engines)
    chunk = trio.port.chunk_frames * 160
    if pattern == "chunk_trim":
        stats = run_paced(trio, speech_like(10.0, seed=7), chunk)
        assert stats["tail"] > 0 and stats["full"] > 0, stats
    elif pattern == "sample_exact_trim":
        run_paced(trio, speech_like(8.0, seed=8), 1)
    else:
        audio = np.concatenate([0.05 * speech_like(3.0, seed=9),
                                5.0 * speech_like(2.0, seed=10)])
        stats = run_paced(trio, audio.astype(np.float32), chunk)
        assert stats["redo"] > 0, stats


def test_shrink_across_a_block_edge(engines):
    """Cap 8.5 s pins the 10 s bucket (5 blocks of 2 s): a 2 s trim
    against a short append moves the frontier back from block 4 to block
    3, and block 4 must encode zero-padded silence again, not the
    trimmed-out burst."""
    trio = Trio(engines, cap_s=8.5)
    stream = 0.1 * speech_like(9.0, seed=13).astype(np.float32)
    stream[int(7.9 * SR):int(8.3 * SR)] = \
        3.0 * speech_like(0.4, seed=14).astype(np.float32)
    trio.tick(stream[:int(8.4 * SR)], "w1")
    w2 = stream[int(1.45 * SR):int(8.85 * SR)]
    trio.tick(w2, "w2")
    assert trio.port.stats["redo"] <= 1
    sess, eng = trio.port, trio.eng
    lo, hi = sess.spans[4]
    padded = np.zeros(sess.pinned_samples, np.float32)
    padded[:len(w2)] = w2
    halo = np.pad(padded, 200, mode="reflect")
    want, _ = encode_block(eng, torch.from_numpy(
        halo[lo * 160:(hi - 1) * 160 + 400]), torch.tensor(
        sess.clamp_max, dtype=torch.float32), hi - lo)
    assert torch.equal(sess.block_tokens_of(4), want)
    np.testing.assert_allclose(
        sess.block_tokens_of(4).numpy(),
        np.asarray(trio.jax.blocks[4]), rtol=0, atol=1e-5)


def test_frontier_near_block_edges(engines):
    """Frontiers just below, at and just above a block edge (STFT frames
    of both neighbours read the new samples), and across the second."""
    trio = Trio(engines)
    block = (trio.port.spans[0][1] - trio.port.spans[0][0]) * 160
    audio = speech_like(6.0, seed=61).astype(np.float32)
    for n in (block - 150, block - 20, block, block + 90, block + 7000,
              2 * block - 60, 2 * block + 30):
        trio.tick(audio[:n], f"frontier at {n} (edge {block})")


def test_reset_and_empty(engines):
    trio = Trio(engines)
    assert trio.port.update(np.zeros(0, np.float32)) == ("", [])
    audio = speech_like(1.5, seed=11).astype(np.float32)
    ids1 = trio.tick(audio, "first")
    trio.port.reset()
    trio.jax.reset()
    trio.prev = []
    assert not trio.port.has_state()
    assert trio.tick(audio, "after reset") == ids1


# -- what the port adds -------------------------------------------------------------

def test_int4_engine_session_cache_is_fp8(monkeypatch):
    """An int4 engine's session cache is fp8 with no scale planes, as JAX's
    is, and decodes as JAX's session does on a head_dim-128 decoder
    (``hd128_models``): every decode step through the batched kernel (its
    plain version here, the TPU kernel in interpret mode in JAX)."""
    from tests.test_torch_engine import hd128_models
    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    jax_model, model = hd128_models()
    jax_eng = JaxEngine(jax_model, dtype=jnp.float32, cache_dtype=jnp.int4)
    eng = TranscriptionEngine(model, device="cpu", cache_dtype=torch.int4)
    jsess = jax_eng.stream_session(2.0, "en")
    sess = eng.stream_session(2.0, "en")
    assert sess.cache_dtype == torch.float8_e4m3fn
    cache = sess.work.loop.cache
    assert cache.k.dtype == torch.float8_e4m3fn
    assert cache.k_scale is None and cache.v_scale is None
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    root = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
    with open(os.path.join(root, "real", "english_01.wav"), "rb") as f:
        audio = decode_audio(f.read())[0][:int(2.6 * SR)]
    window = np.zeros(0, np.float32)
    for off in range(0, len(audio), int(0.9 * SR)):
        window = np.concatenate([window, audio[off:off + int(0.9 * SR)]])
        window = window[-int(2.0 * SR):]
        assert sess.update(window) == jsess.update(window)
    assert sess.stats == jsess.stats


def test_tick_after_a_longer_one_reads_no_stale_key(engines):
    """Keys past the prompt left by an earlier tick (its verify window and
    continuation) are never read: with every cache position at or past P
    poisoned with 1e4 after a long tick, the next ticks (a tail tick and
    a shorter window's rebuild) still give the fused path's tokens."""
    _, eng = engines
    sess = eng.stream_session(CAP_S, "en")
    audio = speech_like(6.0, seed=71).astype(np.float32)
    ids = sess.update(audio[:int(5.4 * SR)])[1]
    assert ids == fused(eng, audio[:int(5.4 * SR)], "en", [])[1]
    plen = sess.prompt_len
    for window in (audio[:int(5.85 * SR)], audio[:int(2.0 * SR)]):
        for x in (sess.work.loop.cache.k, sess.work.loop.cache.v):
            x[:, :, :, plen:] = 1e4
        got = sess.update(window)[1]
        assert got == fused(eng, window, "en", ids)[1]
        ids = got


def _schedule(seed, seconds=4.0):
    audio = speech_like(seconds, seed=seed).astype(np.float32)
    cap, tick, chunk = int(3.0 * SR), int(TICK_S * SR), 100 * 160
    window, out = np.zeros(0, np.float32), []
    for off in range(0, len(audio), tick):
        window = np.concatenate([window, audio[off:off + tick]])
        if len(window) > cap:
            window = window[-(-(len(window) - cap) // chunk) * chunk:]
        out.append(window)
    return out


def test_interleaved_sessions_give_their_solo_tokens(engines):
    """Two sessions ticking in turns share one workspace: before each
    tick the other's cache and audio tokens are copied out and this one's
    in. Each gives the tokens it gives alone, where a lone session copies
    nothing."""
    _, eng = engines
    a_wins, b_wins = _schedule(81), _schedule(82)
    solo = []
    for wins in (a_wins, b_wins):
        sess = eng.stream_session(3.0, "en")
        work = sess.work
        before = work.handovers
        solo.append([sess.update(w)[1] for w in wins])
        assert work.handovers == before, "a lone session copied"
        assert sess.held_bytes() == 0
        sess.release()
    a, b = eng.stream_session(3.0, "en"), eng.stream_session(3.0, "zh")
    before = a.work.handovers
    got_a, got_b = [], []
    for wa, wb in zip(a_wins, b_wins):
        got_a.append(a.update(wa)[1])
        got_b.append(b.update(wb)[1])
    assert a.work.handovers - before >= 2 * len(a_wins) - 1
    assert got_a == solo[0]
    # b's prompt is Chinese: its own solo run in that language
    sess = eng.stream_session(3.0, "zh")
    a.release()
    b_solo = [sess.update(w)[1] for w in b_wins]
    assert got_b == b_solo
    assert b.held_bytes() == sess.work.state_bytes()
    b.release()
    sess.release()


def test_failed_tick_resets_and_reraises(engines, monkeypatch):
    """A tick that fails on the device resets the session (nothing of its
    state is trusted), lets go of the working buffers and re-raises; the
    next tick rebuilds from scratch and gives the fused path's tokens."""
    _, eng = engines
    sess = eng.stream_session(CAP_S, "en")
    audio = speech_like(3.0, seed=91).astype(np.float32)
    sess.update(audio[:int(1.8 * SR)])
    assert sess.has_state() and sess.work.owner is sess

    def boom(seg_start):
        raise RuntimeError("device fault")
    monkeypatch.setattr(sess.work, "run_front", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        sess.update(audio[:int(2.25 * SR)])
    assert not sess.has_state() and sess.prev_tokens == []
    assert sess.work.owner is None and sess.stored is None
    monkeypatch.undo()
    full = sess.stats["full"]
    got = sess.update(audio[:int(2.7 * SR)])[1]
    assert got == fused(eng, audio[:int(2.7 * SR)], "en", [])[1]
    assert sess.stats["full"] == full + 1       # a rebuild from position 0


def test_warmup_builds_every_stream_key(engines, monkeypatch):
    """Under ``prefix`` the engine's warmup builds every executable a
    session at the cap can reach (each block shape's encoder, the
    workspace, each rung's front)."""
    _, eng = engines
    for k, v in {"ASR_WS_STREAM_MODE": "prefix", "WS_WINDOW_MAX_S": "6",
                 "ASR_WS_TICK_MAX_BATCH": "1",
                 "ASR_WARMUP_BATCH_SHAPES": ""}.items():
        monkeypatch.setenv(k, v)
    eng.warmup([1])
    plan = BucketPlan(eng, 6.0)
    state = ("state", plan.prompt_len, plan.max_new, torch.float32)
    want = ([("encode", 200), state]
            + [("tick", s) + state[1:] for s in plan.seg_starts])
    assert eng.stream_warmup["keys"] == want
    assert all(k in eng._stream_fns for k in want)
