"""The grouped WS mode in the port (``qwen3_asr_tpu_torch/runtime/
stream_group.py``, ``GroupTickBatcher``) against the JAX package's
``runtime/stream_group.py``, on the CPU in f32.

The tiny checkpoint of ``tests/fixtures.py`` loads into the JAX engine and,
through ``params_from_jax``, into the port's. The same numpy-seeded audio
goes through a JAX ``StreamGroup``, the port's and the port's fused resume
path at the pinned bucket (``_run_bucket`` with the previous tick's ids),
tick for tick: token ids and texts are identical, and so are every
member's stats (ticks, tail, full, redo). Tolerance: none, ids are
compared for equality.

A counterpart of every test of ``tests/test_stream_group.py`` (paced
parity, a staggered join and leave with slot reuse, a lone member's
``update``, the clamp-max jump and its redo, mixed languages, reset, the
grouped WS server path and the engine's group registry), then what the
port adds: an int4 engine's fp8 group against JAX's on a head_dim-128
decoder, two groups of one key taking turns on one workspace, dead rows
ending at once, a failed dispatch, the ``GroupTickBatcher``'s rounds,
released members and coalescing, and the warmup's keys."""
import concurrent.futures
import contextlib
import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.runtime.stream_group import StreamGroup as JaxGroup
from qwen3_asr_tpu_torch.models.asr import AsrModel, PromptTemplate
from qwen3_asr_tpu_torch.models.config import AsrConfig
from qwen3_asr_tpu_torch.runtime.batcher import GroupTickBatcher
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
from qwen3_asr_tpu_torch.runtime.stream import BucketPlan
from qwen3_asr_tpu_torch.runtime.stream_group import StreamGroup
from qwen3_asr_tpu_torch.text.tokenizer import BpeTokenizer
from tests.fixtures import load_tiny_model, write_tiny_checkpoint
from tests.util_audio import speech_like

CAP_S = 6.0
TICK_S = 0.45
SR = 16000
SLOTS = 4


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
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    write_tiny_checkpoint(path)
    return path


@pytest.fixture(scope="module")
def engines(ckpt):
    """(the JAX engine, the port's engine) on one tiny checkpoint, f32."""
    jax_model = load_tiny_model(ckpt)
    return (JaxEngine(jax_model, dtype=jnp.float32),
            TranscriptionEngine(_port_model(ckpt, jax_model.params),
                                device="cpu"))


def fused(engine, window, language, prev, cap_s=CAP_S):
    """The port's fused resume path at the PINNED cap bucket."""
    frames, bucket_s = engine.bucket_frames(int(cap_s * SR))
    texts, ids = engine._run_bucket([window.astype(np.float32)], frames,
                                    bucket_s, language,
                                    resume_tokens=list(prev))
    return texts[0], ids[0]


class PacedStream:
    """One member's client-side window under chunk-quantized trims."""

    def __init__(self, audio, language="en"):
        self.audio = np.asarray(audio, np.float32)
        self.language = language
        self.window = np.zeros(0, np.float32)
        self.off = 0

    def advance(self, tick_samples, cap_samples, trim_quantum):
        if self.off >= len(self.audio):
            return None
        self.window = np.concatenate(
            [self.window, self.audio[self.off:self.off + tick_samples]])
        self.off += tick_samples
        if len(self.window) > cap_samples:
            trim = len(self.window) - cap_samples
            if trim_quantum > 1:
                trim = -(-trim // trim_quantum) * trim_quantum
            self.window = self.window[trim:]
        return self.window


class Member:
    """A member of both groups, with its language and last ids."""

    def __init__(self, jax_member, member, language):
        self.jax, self.port, self.language = jax_member, member, language
        self.prev = []

    def release(self):
        self.jax.release()
        self.port.release()


class Duo:
    """One group through JAX's ``StreamGroup`` and the port's: ``tick``
    asserts that both and the port's fused path agree."""

    def __init__(self, engines, cap_s=CAP_S, slots=SLOTS, fused_check=True):
        jax_eng, eng = engines
        self.jax = JaxGroup(jax_eng, cap_s, slots)
        self.port = StreamGroup(eng, cap_s, slots)
        self.eng, self.cap_s, self.fused_check = eng, cap_s, fused_check

    def attach(self, language="en"):
        jm = self.jax.attach_or_raise(language)
        m = self.port.attach_or_raise(language)
        assert jm.row == m.row
        return Member(jm, m, language)

    def tick(self, pairs, where=""):
        """pairs: [(Member, window)] ticking together."""
        jres = self.jax.tick([(p.jax, w) for p, w in pairs])
        res = self.port.tick([(p.port, w) for p, w in pairs])
        for (p, w), (jt, jids), (t, ids) in zip(pairs, jres, res):
            if self.fused_check:
                ft, fids = fused(self.eng, w, p.language, p.prev, self.cap_s)
            else:
                ft, fids = t, ids
            assert ids == jids == fids, (
                f"{where} row {p.port.row}: port {ids} JAX {jids} fused "
                f"{fids} (port {p.port.stats}, JAX {p.jax.stats})")
            assert t == jt == ft
            assert p.port.stats == p.jax.stats, where
            p.prev = ids
        return res


def pace(duo, pairs, cap_s=CAP_S):
    """Every cadence, all (Member, PacedStream) pairs with audio left tick
    TOGETHER in one group tick, each checked."""
    cap, tick = int(cap_s * SR), int(TICK_S * SR)
    quantum = duo.port.plan.chunk_frames * 160
    n = 0
    while True:
        reqs = []
        for m, stream in pairs:
            w = stream.advance(tick, cap, quantum)
            if w is not None:
                reqs.append((m, w))
        if not reqs:
            return n
        duo.tick(reqs, f"cadence {n}")
        n += 1


# -- counterparts of tests/test_stream_group.py ---------------------------------

def test_group_two_members_paced_parity(engines):
    duo = Duo(engines)
    m1, m2 = duo.attach("en"), duo.attach("en")
    cadences = pace(duo, [(m1, PacedStream(speech_like(9.0, seed=31))),
                          (m2, PacedStream(0.7 * speech_like(8.0,
                                                             seed=32)))])
    assert m1.port.stats["tail"] > 0, m1.port.stats
    assert m2.port.stats["ticks"] > 0
    # one dispatch a cadence (two where a clamp guess was refuted), not
    # one a member
    redo = m1.port.stats["redo"] + m2.port.stats["redo"]
    assert cadences <= duo.port.dispatches <= cadences + redo


def test_group_staggered_join_and_leave(engines):
    duo = Duo(engines)
    m1 = duo.attach("en")
    s1 = PacedStream(speech_like(8.0, seed=33))
    cap, tick = int(CAP_S * SR), int(TICK_S * SR)
    quantum = duo.port.plan.chunk_frames * 160
    for i in range(5):                       # m1 alone for 5 cadences
        duo.tick([(m1, s1.advance(tick, cap, quantum))], f"alone {i}")
    m2 = duo.attach("en")                    # a join: a full rebuild
    row2 = m2.port.row
    pace(duo, [(m1, s1), (m2, PacedStream(speech_like(4.0, seed=34)))])
    m2.release()                             # the slot is free again
    assert duo.port.members[row2] is None
    m3 = duo.attach("en")
    assert m3.port.row == row2
    s1b = PacedStream(speech_like(2.0, seed=35))
    s1b.window = s1.window
    pace(duo, [(m1, s1b), (m3, PacedStream(speech_like(2.0, seed=36)))])


def test_group_lone_member_update(engines):
    jax_eng, eng = engines
    duo = Duo(engines)
    m = duo.attach("en")
    s = PacedStream(speech_like(7.0, seed=37))
    cap, tick = int(CAP_S * SR), int(TICK_S * SR)
    quantum = duo.port.plan.chunk_frames * 160
    while True:
        w = s.advance(tick, cap, quantum)
        if w is None:
            break
        text, ids = m.port.update(w)
        jtext, jids = m.jax.update(w)
        assert ids == jids == fused(eng, w, "en", m.prev)[1]
        assert text == jtext
        m.prev = ids
    assert m.port.stats == m.jax.stats and m.port.stats["tail"] > 0


def test_group_clamp_jump_redo(engines):
    duo = Duo(engines)
    m1, m2 = duo.attach("en"), duo.attach("en")
    quiet = 0.05 * speech_like(3.0, seed=38)
    loud = 5.0 * speech_like(2.0, seed=39)
    pace(duo, [(m1, PacedStream(np.concatenate([quiet, loud]))),
               (m2, PacedStream(0.5 * speech_like(5.0, seed=40)))])
    assert m1.port.stats["redo"] > 0, m1.port.stats


def test_group_mixed_languages(engines):
    duo = Duo(engines)
    pairs = [(duo.attach(lang), PacedStream(speech_like(3.0, seed=seed),
                                            lang))
             for lang, seed in (("en", 41), ("zh", 42), (None, 43))]
    pace(duo, pairs)


def test_group_reset_matches_fresh(engines):
    duo = Duo(engines)
    m = duo.attach("en")
    audio = speech_like(1.5, seed=44).astype(np.float32)
    ids1 = duo.tick([(m, audio)], "first")[0][1]
    m.port.reset()
    m.jax.reset()
    m.prev = []
    assert not m.port.has_state()
    assert duo.tick([(m, audio)], "after reset")[0][1] == ids1


@contextlib.contextmanager
def _server(manager):
    from qwen3_asr_tpu_torch.serving.server import build_server
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


def _pcm(audio):
    return (np.clip(audio * 32767, -32768, 32767).astype("<i2").tobytes())


def test_grouped_ws_server_path(engines, monkeypatch):
    """Both legacy flags: two concurrent WS connections join ONE group,
    their partials coalesce through the group tick batcher (fewer
    dispatches than ticks), each connection's partials are a JAX group
    member's on the same bandpassed windows, and the closed connections
    leave the group, which leaves the registry."""
    from qwen3_asr_tpu_torch.audio.frontend import fir_same, pcm16_to_f32
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    from qwen3_asr_tpu_torch.text.repetition import \
        detect_and_fix_repetitions
    jax_eng, eng = engines
    for k, v in {"SKIP_WARMUP": "true", "ASR_WS_PREFIX_CACHE": "true",
                 "ASR_WS_TICK_BATCH": "true", "ASR_WS_GROUP_SLOTS": "4",
                 "REQUEST_TIMEOUT": "120"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("ASR_WS_STREAM_MODE", raising=False)
    tick = ws_mod.WS_BUFFER_SIZE
    pcms = [_pcm(speech_like(4.0, seed=51)),
            _pcm(0.7 * speech_like(4.0, seed=52))]
    pcms = [p[:len(p) - len(p) % tick] for p in pcms]
    # the reference: a JAX group member per stream on the windows the
    # server bandpasses (the cap holds all 4 s: no trim)
    band = ws_mod._bandpass_kernel()
    jgroup = JaxGroup(jax_eng, ws_mod.WS_WINDOW_MAX_S, 4)
    want = []
    for p in pcms:
        jm = jgroup.attach_or_raise("English")
        texts = []
        for i in range(tick, len(p) + 1, tick):
            text, _ = jm.update(fir_same(pcm16_to_f32(p[:i]), band))
            if text:
                texts.append(detect_and_fix_repetitions(text))
        want.append((texts, dict(jm.stats)))

    manager = ModelManager(eng)
    manager.group_tick_batcher = GroupTickBatcher(manager, window_ms=1000,
                                                  max_batch=2)
    failures = ws_mod.prefix_bind_failures
    with _server(manager) as base:
        conns = [ws_mod.connect(base + "/ws/transcribe?use_server_vad=false",
                                timeout=120) for _ in pcms]
        for ws in conns:
            assert ws.receive_json()["status"] == "connected"

        def feed(ws, p):
            """Every tick, then a flush; the partials before the final."""
            for i in range(0, len(p), tick):
                ws.send_bytes(p[i:i + tick])
            ws.send_json({"action": "flush"})
            msgs = [ws.receive_json(timeout=120)]
            while not msgs[-1].get("is_final"):
                msgs.append(ws.receive_json(timeout=120))
            return msgs[:-1]

        groups = []
        orig = eng.stream_group_member

        def keep(*a, **k):
            member = orig(*a, **k)
            groups.append(member.group)
            return member
        monkeypatch.setattr(eng, "stream_group_member", keep)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            got = list(pool.map(feed, conns, pcms))
        assert len(groups) == 2 and groups[0] is groups[1]
        assert groups[0].live_members == 2
        members = [m for m in groups[0].members if m is not None]
        stats = sorted(tuple(sorted(m.stats.items())) for m in members)
        for ws in conns:
            ws.close()
        # the handlers release their members on close
        for _ in range(200):
            if not any(eng._stream_groups.values()):
                break
            threading.Event().wait(0.05)
    assert [[m["text"] for m in msgs] for msgs in got] == \
        [texts for texts, _ in want]
    assert stats == sorted(tuple(sorted(s.items())) for _, s in want)
    batcher = manager.group_tick_batcher
    assert batcher.ticks == sum(len(p) // tick for p in pcms)
    assert batcher.dispatches < batcher.ticks and 2 in batcher.groups
    assert not any(eng._stream_groups.values())
    assert ws_mod.prefix_bind_failures == failures


def test_engine_group_registry(engines):
    """``stream_group_member`` fills a group's slots, opens a second when
    it is full, and drops emptied groups, as JAX's engine does."""
    key = engines[1].bucket_frames(int(CAP_S * SR))
    for eng in engines:
        members = [eng.stream_group_member(CAP_S, "en", slots=2)
                   for _ in range(3)]
        jkey = eng.bucket_frames(int(CAP_S * SR))
        assert tuple(jkey) == tuple(key)
        groups = eng._stream_groups[jkey]
        assert len(groups) == 2
        assert members[0].group is members[1].group
        assert members[2].group is not members[0].group
        members[2].release()
        assert len(eng._stream_groups[jkey]) == 1
        members[0].release()
        members[1].release()
        assert eng._stream_groups[jkey] == []
        assert members[0].engine is None


# -- what the port adds -------------------------------------------------------------

def test_int4_engine_group_cache_is_fp8(monkeypatch):
    """An int4 engine's group cache is fp8 with no scale planes, as JAX's
    is, and three members decode as JAX's group does on a head_dim-128
    decoder (every decode step through the batched kernel: its plain
    version here, the TPU kernel in interpret mode in JAX)."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from tests.test_torch_engine import hd128_models
    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    jax_model, model = hd128_models()
    jax_eng = JaxEngine(jax_model, dtype=jnp.float32, cache_dtype=jnp.int4)
    eng = TranscriptionEngine(model, device="cpu", cache_dtype=torch.int4)
    duo = Duo((jax_eng, eng), cap_s=2.0, slots=4, fused_check=False)
    assert duo.port.cache_dtype == torch.float8_e4m3fn
    cache = duo.port.work.loop.cache
    assert cache.k.dtype == torch.float8_e4m3fn and cache.k_scale is None
    root = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
    pairs = []
    for name in ("english_01.wav", "english_02.wav", "chinese_01.wav"):
        with open(os.path.join(root, "real", name), "rb") as f:
            audio = decode_audio(f.read())[0][:int(2.6 * SR)]
        pairs.append((duo.attach("en"), audio))
    windows = [np.zeros(0, np.float32)] * 3
    for off in range(0, int(2.6 * SR), int(0.9 * SR)):
        windows = [np.concatenate([w, a[off:off + int(0.9 * SR)]])[
            -int(2.0 * SR):] for w, (_, a) in zip(windows, pairs)]
        duo.tick([(m, w) for (m, _), w in zip(pairs, windows)], f"@{off}")


def _windows(seed, seconds=4.0, cap_s=3.0):
    audio = speech_like(seconds, seed=seed).astype(np.float32)
    cap, tick, chunk = int(cap_s * SR), int(TICK_S * SR), 100 * 160
    window, out = np.zeros(0, np.float32), []
    for off in range(0, len(audio), tick):
        window = np.concatenate([window, audio[off:off + tick]])
        if len(window) > cap:
            window = window[-(-(len(window) - cap) // chunk) * chunk:]
        out.append(window)
    return out


def test_two_groups_of_one_key_take_turns(engines):
    """Four members in groups of 2 slots: two groups of one key share one
    workspace and take turns (their state copied out and in). Each member
    gives the ids it gives in a group of its own, where a lone group
    copies nothing."""
    _, eng = engines
    wins = [_windows(s) for s in (101, 102, 103, 104)]
    solo = []
    for w in wins:
        m = eng.stream_group_member(3.0, "en", slots=2)
        before = m.group.work.handovers
        solo.append([m.update(x)[1] for x in w])
        assert m.group.work.handovers == before, "a lone group copied"
        assert m.group.held_bytes() == 0
        m.release()
    members = [eng.stream_group_member(3.0, "en", slots=2) for _ in wins]
    g1, g2 = members[0].group, members[2].group
    assert g1 is members[1].group and g2 is members[3].group and g1 is not g2
    assert g1.work is g2.work
    before = g1.work.handovers
    got = [[] for _ in wins]
    for i in range(len(wins[0])):
        for g, pair in ((g1, (0, 1)), (g2, (2, 3))):
            res = g.tick([(members[j], wins[j][i]) for j in pair])
            for j, (_, ids) in zip(pair, res):
                got[j].append(ids)
    assert g1.work.handovers - before >= 2 * len(wins[0]) - 1
    assert got == solo
    assert g1.held_bytes() == g1.work.state_bytes()
    for m in members:
        m.release()
    assert g1.stored is None and g2.stored is None


def test_one_slot_group_runs_on_its_own_workspace(engines):
    """A group of one slot has a workspace of one row, as a session has;
    its fronts are its own keys (``gtick``), not the session's, whose
    workspace exists beside it: its ids are a session's."""
    _, eng = engines
    wins = _windows(141)
    sess = eng.stream_session(3.0, "en")
    want = [sess.update(w)[1] for w in wins]
    member = eng.stream_group_member(3.0, "en", slots=1)
    assert member.group.work is not sess.work
    assert [member.update(w)[1] for w in wins] == want
    assert any(k[0] == "gtick" and k[4] == 1 for k in eng._stream_fns)
    assert not set(map(id, member.group.work.fronts.values())) & set(
        map(id, sess.work.fronts.values()))
    sess.release()
    member.release()


def test_dead_rows_end_at_once(engines):
    """Empty slots and a member that never ticked are dead rows: their
    first token is EOS, so a dispatch runs the steps its live rows need,
    as many chunks as a solo session's tick on the same window."""
    _, eng = engines
    audio = speech_like(2.0, seed=111).astype(np.float32)
    sess = eng.stream_session(CAP_S, "en")
    ids = sess.update(audio)[1]
    group = StreamGroup(eng, CAP_S, SLOTS)
    live = group.attach_or_raise("en")
    idle = group.attach_or_raise("en")
    assert live.update(audio)[1] == ids
    assert group.last_run["live"] == 1
    assert group.last_run["chunks"] == sess.last_run["chunks"]
    loop = group.work.loop
    eos = eng.model.eos_id
    for row in (idle.row, 2, 3):
        assert int(loop.tokens[row, 0]) == eos
        assert int((loop.tokens[row] != eng.model.pad_id).sum()) == 1
    # the empty slots' audio tokens are zeros
    assert not group.work.audio[2:].any()
    sess.release()
    live.release()
    idle.release()


def test_failed_dispatch_resets_every_member(engines, monkeypatch):
    """A dispatch that fails on the device resets every member and the
    group's claim on the workspace, and re-raises; the next tick rebuilds
    from scratch and equals a fresh group's."""
    _, eng = engines
    a = speech_like(3.0, seed=121).astype(np.float32)
    b = 0.6 * speech_like(3.0, seed=122).astype(np.float32)
    group = StreamGroup(eng, CAP_S, SLOTS)
    m1, m2 = group.attach_or_raise("en"), group.attach_or_raise("en")
    group.tick([(m1, a[:int(1.8 * SR)]), (m2, b[:int(1.8 * SR)])])
    assert m1.has_state() and group.work.owner is group

    def boom(seg_start, eager=False):
        raise RuntimeError("device fault")
    monkeypatch.setattr(group.work, "run", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        group.tick([(m1, a[:int(2.25 * SR)])])
    assert not m1.has_state() and not m2.has_state()
    assert m1.prev_tokens == [] and m2.prev_tokens == []
    assert group.work.owner is None and group.stored is None
    monkeypatch.undo()
    full = m1.stats["full"]
    got = group.tick([(m1, a[:int(2.7 * SR)]), (m2, b[:int(2.7 * SR)])])
    assert m1.stats["full"] == full + 1          # a rebuild from position 0
    fresh = StreamGroup(eng, CAP_S, SLOTS)
    f1, f2 = fresh.attach_or_raise("en"), fresh.attach_or_raise("en")
    assert got == fresh.tick([(f1, a[:int(2.7 * SR)]),
                              (f2, b[:int(2.7 * SR)])])
    for m in (m1, m2, f1, f2):
        m.release()


class _Manager:
    """What the batchers read of a manager: the queue and the sessions."""

    def __init__(self, sessions=2):
        from qwen3_asr_tpu_torch.runtime.queue import PriorityInferQueue
        self.queue = PriorityInferQueue()
        self.ws_sessions = sessions


def test_group_tick_batcher_rounds_release_and_coalescing(engines):
    """Ticks of two members landing in one window run as ONE dispatch; a
    member's second tick in the same window goes to a second round, after
    the first (its ids those of its two ticks in turn); a member released
    before its round runs gets ("", [])."""
    _, eng = engines
    wins = {s: _windows(s, cap_s=CAP_S) for s in (131, 132, 133)}
    mgr = _Manager()
    batcher = GroupTickBatcher(mgr, window_ms=500, max_batch=8)
    ref = StreamGroup(eng, CAP_S, SLOTS)
    r1, r2 = ref.attach_or_raise("en"), ref.attach_or_raise("en")
    want1 = ref.tick([(r1, wins[131][0]), (r2, wins[132][0])])
    want2 = ref.tick([(r1, wins[131][1])])
    group = StreamGroup(eng, CAP_S, SLOTS)
    m1, m2 = group.attach_or_raise("en"), group.attach_or_raise("en")
    m3 = group.attach_or_raise("en")
    mgr.queue.start()
    try:
        futures = [batcher.tick(m1, wins[131][0]),
                   batcher.tick(m2, wins[132][0]),
                   batcher.tick(m1, wins[131][1]),
                   batcher.tick(m3, wins[133][0])]
        m3.release()
        got = [f.result(timeout=120) for f in futures]
    finally:
        mgr.queue.stop()
    assert got[:3] == [want1[0], want1[1], want2[0]]
    assert got[3] == ("", [])
    assert batcher.dispatches == 2 and batcher.groups == {2: 1, 1: 1}
    # the same dispatches as the reference's two calls (redos included)
    assert batcher.ticks == 3 and group.dispatches == ref.dispatches
    for m in (m1, m2, r1, r2):
        m.release()


def test_warmup_builds_every_group_key(engines, monkeypatch):
    """Under ``grouped`` the warmup builds every executable a group at the
    cap can reach at ``ASR_WS_GROUP_SLOTS`` (each block shape's encoder,
    the pooled workspace, each rung's front); under ``auto`` at 30 s both
    the ``prefix`` and the ``grouped`` keys."""
    _, eng = engines
    for k, v in {"ASR_WS_STREAM_MODE": "grouped", "WS_WINDOW_MAX_S": "6",
                 "ASR_WS_GROUP_SLOTS": "4", "ASR_WS_TICK_MAX_BATCH": "1",
                 "ASR_WARMUP_BATCH_SHAPES": ""}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("ASR_WS_PREFIX_CACHE", raising=False)
    monkeypatch.delenv("ASR_WS_TICK_BATCH", raising=False)
    count = eng.executable_count
    eng.warmup([1])
    plan = BucketPlan(eng, 6.0)
    state = ("gstate", plan.prompt_len, plan.max_new, 4, torch.float32)
    want = ([("encode", 200), state]
            + [("gtick", s) + state[1:] for s in plan.seg_starts])
    assert eng.stream_warmup["keys"] == want
    assert all(k in eng._stream_fns for k in want)
    assert eng.executable_count > count

    monkeypatch.setenv("ASR_WS_STREAM_MODE", "auto")
    monkeypatch.setenv("WS_WINDOW_MAX_S", "30")
    eng.warmup([1])
    plan = BucketPlan(eng, 30.0)
    keys = eng.stream_warmup["keys"]
    for kind, extra in (("state", ()), ("gstate", (4,))):
        state = (kind, plan.prompt_len, plan.max_new) + extra + (
            torch.float32,)
        tick = "gtick" if kind == "gstate" else "tick"
        assert state in keys
        assert all((tick, s) + state[1:] in keys for s in plan.seg_starts)
    assert all(k in eng._stream_fns for k in keys)
