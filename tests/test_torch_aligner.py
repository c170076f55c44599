"""The port's forced aligner (``sidecars/aligner.py``) against the JAX
package's ``AlignerEngine`` on the same checkpoints, on the CPU in f32:
the tiny one of ``tests/fixtures.py`` (``write_tiny_checkpoint``) and the
in-repo trained one with the real clips.

Tolerances: the acoustic embeddings (the encoder on the padded clip)
within 1e-5 absolute (both f32; sums in another order); the text
embeddings (a gather) exactly; the aligned words equal and every start
and end within 1e-6 s on ``speech_like`` clips up to 30 s, CJK text, a
60 ms clip, an 8 kHz clip, s16 PCM, every real clip and 60 s of them.

Above that the alignment is ill-conditioned and exact agreement is not a
property of either package: the similarity's f32 rounding (measured
≤ 2.1e-7 between the two) moves the Viterbi partition among near-equal
optima (on the random tiny weights at 60 s, 165 of 303 token entries
move, for a score 3e-5 of 18.1 apart) and the edge fit among near-equal
grid points (on 300 s of real speech, 2 of 978 words by up to 32 ms). So
at 60 and 300 s of ``speech_like`` audio and 300 s of real speech the
tests hold: the host path (partition, edge fit, words) given JAX's
acoustic embeddings equals JAX's to 1e-6 s; the words equal JAX's; and
the port's partition, scored under JAX's similarity, is within the
perturbation bound of JAX's (2 · frames · max |Δsim|, plus 1e-5 of the
score for the f32 cumsums of either DP). Then each case of
``tests/test_aligner.py`` on the port, the engine's word timestamps, the
encoder against JAX's at 60 and 300 s, and the encoder's token count at
every aligner length."""
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_asr_tpu.models.encoder import encoder_output_length as jax_out_len
from qwen3_asr_tpu.sidecars import aligner as jaligner
from qwen3_asr_tpu.sidecars import subtitle as jsub
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.models.config import preset
from qwen3_asr_tpu_torch.models.encoder import encoder_output_length
from qwen3_asr_tpu_torch.runtime import engine as engine_mod
from qwen3_asr_tpu_torch.sidecars import aligner
from qwen3_asr_tpu_torch.sidecars import subtitle as sub
from tests.fixtures import write_tiny_checkpoint
from tests.util_audio import speech_like

ACOUSTIC_ATOL = 1e-5
TIME_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    write_tiny_checkpoint(path)
    return path


@pytest.fixture(scope="module")
def ours(ckpt):
    return aligner.AlignerEngine.load(ckpt, device="cpu")


@pytest.fixture(scope="module")
def ref(ckpt):
    return jaligner.AlignerEngine.load(ckpt)


def _jax_acoustic(eng, audio):
    """JAX's acoustic embeddings of a 16 kHz f32 clip, as its ``align``
    computes them (the padding to its ladder, then the encoder)."""
    chunk = eng.model.cfg.encoder.n_window * 2
    need = max(chunk, -(-len(audio) // 160))
    mel_frames = None
    for sec in engine_mod.AUDIO_BUCKETS_S:
        frames = ((int(sec * 100) + chunk - 1) // chunk) * chunk
        if need <= frames:
            mel_frames = frames
            break
    if mel_frames is None:
        mel_frames = ((need + 2999) // 3000) * 3000
        mel_frames = ((mel_frames + chunk - 1) // chunk) * chunk
    padded = np.zeros(mel_frames * 160, dtype=np.float32)
    padded[:len(audio)] = audio[:len(padded)]
    mel, _ = eng.frontend(padded)
    acoustic, lens = eng._encode(mel[None], jnp.asarray([mel_frames]))
    return np.asarray(acoustic[0, :int(lens[0])], np.float32), mel_frames


WORDS = ("the quick brown fox jumps over the lazy dog and then some more "
         "words follow here").split()


def _text(n_words):
    return " ".join(WORDS[i % len(WORDS)] for i in range(n_words))


CASES = {
    # name: (audio, sr, text, language)
    "speech_2s": (speech_like(2.0, seed=0), 16000,
                  "hello world this is a test", "en"),
    "speech_4s_long_text": (speech_like(4.0, seed=3), 16000, _text(20), "en"),
    "speech_30s": (speech_like(30.0, seed=10), 16000, _text(75), "en"),
    "cjk": (speech_like(1.0, seed=2), 16000, "你好世界", "zh"),
    "cjk_mixed": (speech_like(2.5, seed=5), 16000, "我用 python 写代码", "zh"),
    "tiny_clip": (speech_like(0.06, seed=4), 16000, "hi", "en"),
    "8khz": (speech_like(1.0, sr=8000, seed=1), 8000, "one two three", "en"),
    "s16_pcm": ((speech_like(1.5, seed=6) * 32767).astype(np.int16), 16000,
                "one two three four", "en"),
}
LONG = {
    "60s": (speech_like(60.0, seed=7), _text(150)),
    "300s": (speech_like(300.0, seed=8), _text(700)),
}
REAL = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CLIPS = sorted(glob.glob(os.path.join(REAL, "real", "*.wav")))


def _real(path):
    with open(path, "rb") as f:
        audio, _ = decode_audio(f.read())
    with open(path[:-4] + ".txt", encoding="utf-8") as f:
        return audio.astype(np.float32), f.read().strip()


def _real_seconds(seconds):
    """The real clips end to end, repeated to ``seconds``, with their
    transcripts in the same order."""
    parts = [_real(p) for p in CLIPS]
    audio = np.concatenate([a for a, _ in parts])
    text = " ".join(t for _, t in parts)
    reps = -(-seconds * 16000 // len(audio))
    return (np.tile(audio, reps)[:seconds * 16000],
            " ".join([text] * reps))


@pytest.fixture(scope="module")
def trained():
    ckpt = os.path.join(REAL, "trained_ckpt")
    return (aligner.AlignerEngine.load(ckpt, device="cpu"),
            jaligner.AlignerEngine.load(ckpt))


def _same_words(got, want):
    assert got and [w.text for w in got] == [w.text for w in want]
    for a, b in zip(got, want):
        assert abs(a.start - b.start) <= TIME_ATOL, (a, b)
        assert abs(a.end - b.end) <= TIME_ATOL, (a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_align_matches_jax(ours, ref, name):
    audio, sr, text, lang = CASES[name]
    _same_words(ours.align(audio, sr, text, lang),
                ref.align(audio, sr, text, lang))


@pytest.mark.parametrize("clip", [os.path.basename(p)[:-4] for p in CLIPS]
                         + ["real_60s"])
def test_align_real_speech_matches_jax(trained, clip):
    ours, ref = trained
    audio, text = (_real_seconds(60) if clip == "real_60s" else
                   _real(os.path.join(REAL, "real", clip + ".wav")))
    _same_words(ours.align(audio, 16000, text, "en"),
                ref.align(audio, 16000, text, "en"))


def _long_case(name, tiny, trained):
    if name == "real_300s":
        return trained + _real_seconds(300)
    return (tiny[0], tiny[1]) + LONG[name]


def _score(sim, entries):
    """The partition's summed similarity (f64)."""
    edges = list(entries) + [sim.shape[1]]
    return sum(float(sim[i, edges[i]:edges[i + 1]].sum(dtype=np.float64))
               for i in range(sim.shape[0]))


@pytest.mark.parametrize("name", ["60s", "300s", "real_300s"])
def test_long_alignment_matches_jax(ours, ref, trained, monkeypatch, name):
    eng, jeng, audio, text = _long_case(name, (ours, ref), trained)
    want = jeng.align(audio, 16000, text, "en")
    got = eng.align(audio, 16000, text, "en")
    assert [w.text for w in got] == [w.text for w in want]
    words, ids, sim, _ = eng.similarity(audio, 16000, text)
    # the host path on JAX's acoustic embeddings: JAX's words exactly
    monkeypatch.setattr(eng, "encode",
                        lambda a: _jax_acoustic(jeng, a)[0])
    _same_words(eng.align(audio, 16000, text, "en"), want)
    _, _, jsim, _ = eng.similarity(audio, 16000, text)
    assert sim.shape == jsim.shape
    # the port's partition is optimal under JAX's similarity to within
    # the perturbation (and the f32 rounding of either DP)
    ours_p = aligner._viterbi_partition(sim)
    jax_p = jaligner._viterbi_partition(jsim)
    best = _score(jsim, jax_p)
    slack = (2 * sim.shape[1] * float(np.abs(sim - jsim).max())
             + 1e-5 * abs(best))
    assert _score(jsim, ours_p) >= best - slack


@pytest.mark.parametrize("name", ["speech_2s", "tiny_clip", "60s", "300s"])
def test_acoustic_embeddings_match_jax(ours, ref, name):
    audio = LONG[name][0] if name in LONG else CASES[name][0]
    got = ours.encode(audio)
    want, mel_frames = _jax_acoustic(ref, audio)
    assert ours.mel_frames(len(audio)) == mel_frames
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ACOUSTIC_ATOL, rtol=0)


@pytest.mark.parametrize("text", ["hello world this is a test", "你好世界",
                                  _text(40)])
def test_text_embeddings_equal_jax(ours, ref, text):
    from qwen3_asr_tpu.models.decoder import embed_tokens as jax_embed
    ids = ours.model.tokenizer.encode(text, allow_special=False)
    assert ids == ref.model.tokenizer.encode(text, allow_special=False)
    want = np.asarray(jax_embed(ref.model.params["decoder"],
                                ref.model.cfg.decoder,
                                jnp.asarray(ids)[None]), np.float32)[0]
    np.testing.assert_array_equal(ours.embed_text(ids), want)


@pytest.mark.parametrize("seconds", [60, 300])
def test_encoder_matches_jax_at_aligner_lengths(ours, ref, seconds):
    """``encoder_forward`` on the same mel at the 30 s steps above the
    engine's ladder (the tiny checkpoint's widths: 3900 tokens at 300 s,
    windows of 26)."""
    from qwen3_asr_tpu.models.encoder import encoder_forward as jax_enc
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    cfg = ours.model.cfg.encoder
    rng = np.random.default_rng(seconds)
    frames = seconds * 100
    mel = rng.standard_normal((1, cfg.num_mel_bins, frames)).astype(
        np.float32)
    lens = np.asarray([frames - 37], np.int32)
    want, want_lens = jax_enc(ref.model.params["encoder"],
                              ref.model.cfg.encoder, jnp.asarray(mel),
                              jnp.asarray(lens))
    with torch.inference_mode():
        got, got_lens = encoder_forward(ours.model.params["encoder"], cfg,
                                        torch.from_numpy(mel),
                                        torch.from_numpy(lens))
    n = int(got_lens[0])
    assert n == int(want_lens[0])
    np.testing.assert_allclose(got[0, :n].numpy(), np.asarray(want)[0, :n],
                               atol=ACOUSTIC_ATOL, rtol=0)


@pytest.mark.parametrize("model", ["1.7b", "tiny"])
def test_encoder_token_count_at_every_aligner_length(ours, model):
    """The encoder's token count equals JAX's at every length the aligner
    pads to (the ladder, then 30 s steps up to 300 s) and at lengths in
    between (the valid tail of a chunk)."""
    cfg = preset("1.7b").encoder if model == "1.7b" else \
        ours.model.cfg.encoder
    chunk = cfg.n_window * 2
    lengths = [int(s * 100) for s in engine_mod.AUDIO_BUCKETS_S]
    lengths += [sec * 100 for sec in range(60, 301, 30)]
    lengths += [n - 37 for n in lengths] + [1, 7, chunk - 1, chunk + 1]
    for n in lengths:
        assert encoder_output_length(n, chunk) == int(jax_out_len(n, chunk))
    if model == "1.7b":
        assert encoder_output_length(30000, chunk) == 3750


# -- the cases of tests/test_aligner.py ---------------------------------------------

def test_align_monotonic_nonoverlapping(ours):
    words = ours.align(speech_like(2.0, seed=0), 16000,
                       "hello world this is a test", "en")
    assert len(words) == 6
    for w in words:
        assert 0.0 <= w.start <= w.end <= 2.0 + 1e-6
    for a, b in zip(words, words[1:]):
        assert b.start >= a.end - 1e-6


def test_align_empty_inputs(ours):
    assert ours.align(np.zeros(0, np.float32), 16000, "text", "en") == []
    assert ours.align(speech_like(1.0), 16000, "", "en") == []


def test_align_resamples(ours):
    words = ours.align(speech_like(1.0, sr=8000, seed=1), 8000,
                       "one two three", "en")
    assert len(words) == 3
    assert words[-1].end <= 1.0 + 0.1


def test_align_cjk_tokens(ours):
    words = ours.align(speech_like(1.0, seed=2), 16000, "你好世界", "zh")
    assert len(words) == 4


def test_viterbi_partition_dp():
    sim = np.eye(4, 8, dtype=np.float32)
    assert list(aligner._viterbi_partition(sim)) == [0, 1, 2, 3]
    rng = np.random.default_rng(0)
    sim = rng.standard_normal((6, 20)).astype(np.float32)
    entries = aligner._viterbi_partition(sim)
    assert entries[0] == 0
    assert all(b > a for a, b in zip(entries, entries[1:]))
    assert entries[-1] < 20
    np.testing.assert_array_equal(entries, jaligner._viterbi_partition(sim))


def test_viterbi_partition_is_optimal():
    """The vectorized DP matches brute force, and JAX's DP, on small
    cases."""
    from itertools import combinations
    rng = np.random.default_rng(3)
    for _ in range(10):
        n_tok, n_frames = 3, 7
        sim = rng.standard_normal((n_tok, n_frames)).astype(np.float32)

        def score(ent):
            return sum(sim[i, ent[i]:(ent[i + 1] if i + 1 < n_tok
                                      else n_frames)].sum()
                       for i in range(n_tok))

        best = max(score((0,) + cuts)
                   for cuts in combinations(range(1, n_frames), n_tok - 1))
        got = aligner._viterbi_partition(sim)
        assert score(got) >= best - 1e-4
        np.testing.assert_array_equal(got, jaligner._viterbi_partition(sim))


def _ground_truth_case(boundaries, frame_s=0.08, peak=8.0, noise=0.0,
                       seed=0):
    """A similarity matrix from known word timings (as
    tests/test_aligner.py builds it): each token's frames carry a peak
    scaled by the token's occupancy of the frame, plus seeded noise."""
    duration = boundaries[-1][2]
    n_frames = int(np.ceil(duration / frame_s))
    words, word_ids, tok_spans = [], [], []
    for word, start, end, n_tok in boundaries:
        words.append(word)
        word_ids.append(list(range(n_tok)))
        for k in range(n_tok):
            tok_spans.append((start + (end - start) * k / n_tok,
                              start + (end - start) * (k + 1) / n_tok))
    rng = np.random.default_rng(seed)
    sim = noise * rng.standard_normal(
        (len(tok_spans), n_frames)).astype(np.float32)
    for i, (t0, t1) in enumerate(tok_spans):
        f0 = int(t0 / frame_s)
        f1 = max(f0 + 1, int(np.ceil(t1 / frame_s)))
        for j in range(f0, min(f1, n_frames)):
            overlap = min(t1, (j + 1) * frame_s) - max(t0, j * frame_s)
            sim[i, j] += peak * overlap / frame_s
    return words, word_ids, sim, frame_s, duration


BOUNDARIES = [("the", 0.10, 0.31, 1), ("quick", 0.31, 0.74, 2),
              ("brown", 0.83, 1.27, 2), ("fox", 1.27, 1.62, 1),
              ("jumps", 1.90, 2.45, 3), ("over", 2.45, 2.81, 2),
              ("everything", 2.95, 3.84, 4)]


def _both_spans_to_words(words, word_ids, sim, frame_s, duration,
                         with_sim=True):
    kw = {"sim": sim} if with_sim else {}
    got = aligner._spans_to_words(words, word_ids, aligner._token_spans(sim),
                                  frame_s, duration, **kw)
    want = jaligner._spans_to_words(words, word_ids,
                                    jaligner._token_spans(sim), frame_s,
                                    duration, **kw)
    assert [(w.text, w.start, w.end) for w in got] == \
        [(w.text, w.start, w.end) for w in want]
    return got


def _errors(aligned, boundaries):
    errs = []
    for got, (word, start, end, _) in zip(aligned, boundaries):
        assert got.text == word
        errs += [abs(got.start - start), abs(got.end - end)]
    return np.asarray(errs)


def test_alignment_accuracy_ground_truth():
    aligned = _both_spans_to_words(*_ground_truth_case(BOUNDARIES))
    errs = _errors(aligned, BOUNDARIES)
    assert errs.mean() <= 0.004 and errs.max() <= 0.008


def test_alignment_accuracy_ground_truth_on_grid():
    aligned = _both_spans_to_words(*_ground_truth_case(BOUNDARIES),
                                   with_sim=False)
    errs = _errors(aligned, BOUNDARIES)
    assert errs.mean() <= 0.04 + 1e-6 and errs.max() <= 0.08 + 1e-6


@pytest.mark.parametrize("noise,bound", [(0.6, 0.033), (1.0, 0.038)],
                         ids=["moderate", "adversarial"])
def test_alignment_accuracy_under_noise(noise, bound):
    """30 seeds of per-frame noise (σ = 15% and 25% of the peak): the
    worst mean boundary error stays within JAX's bounds, every seed's
    words equal to JAX's."""
    boundaries = [("alpha", 0.05, 0.52, 2), ("beta", 0.52, 1.11, 2),
                  ("gamma", 1.30, 1.88, 3), ("delta", 1.88, 2.50, 2)]
    worst = 0.0
    for seed in range(30):
        aligned = _both_spans_to_words(*_ground_truth_case(
            boundaries, peak=4.0, noise=noise, seed=seed))
        worst = max(worst, float(_errors(aligned, boundaries).mean()))
    assert worst <= bound + 1e-6


def test_fractional_edges_single_frame_clip():
    sim = np.array([[0.9]], np.float32)
    spans = aligner._token_spans(sim)
    edges = aligner._fractional_edges(sim, spans)
    assert edges.shape == (1, 2) and edges[0, 1] > edges[0, 0]
    words = aligner._spans_to_words(["hi"], [[0]], spans, 0.08, 0.05,
                                    sim=sim)
    assert len(words) == 1 and words[0].end <= 0.05 + 1e-6


def test_align_tiny_clip_no_crash(ours):
    words = ours.align(speech_like(0.06, seed=4), 16000, "hi", "en")
    assert len(words) <= 1
    for w in words:
        assert 0.0 <= w.start <= w.end


def test_align_cjk_tokens_encode_without_space_joiner(ours, monkeypatch):
    seen = []
    orig = ours.model.tokenizer.encode

    def spy(text, **kw):
        seen.append(text)
        return orig(text, **kw)

    monkeypatch.setattr(ours.model.tokenizer, "encode", spy)
    ours.align(speech_like(1.0, seed=2), 16000, "你好吗", "zh")
    assert seen == ["你", "好", "吗"]
    seen.clear()
    ours.align(speech_like(1.0, seed=2), 16000, "one two", "en")
    assert seen == ["one", " two"]


def test_engine_timestamps_use_aligner_when_loaded(monkeypatch):
    """The engine's word timestamps: the aligner's, offset by the
    segment's start and rounded, when one is loaded; estimates otherwise;
    both equal to JAX's."""
    from qwen3_asr_tpu.runtime.engine import _word_timestamps as jax_ts
    from qwen3_asr_tpu_torch.runtime.engine import _word_timestamps

    def stub(mod):
        class StubAligner:
            def align(self, audio, sr, text, language):
                return [mod.AlignedWord("hello", 0.2, 0.5),
                        mod.AlignedWord("world", 0.6, 0.9)]
        return StubAligner()

    audio = speech_like(1.0, seed=7)
    monkeypatch.setattr(sub, "_aligner", stub(aligner))
    monkeypatch.setattr(jsub, "_aligner", stub(jaligner))
    ts = _word_timestamps(audio, "hello world", 10.0, 11.0, "en")
    assert ts == [{"word": "hello", "start": 10.2, "end": 10.5},
                  {"word": "world", "start": 10.6, "end": 10.9}]
    assert ts == jax_ts(audio, "hello world", 10.0, 11.0, "en")

    monkeypatch.setattr(sub, "_aligner", None)
    monkeypatch.setattr(jsub, "_aligner", None)
    ts = _word_timestamps(audio, "hello world", 0.0, 1.0, "en")
    assert [t["word"] for t in ts] == ["hello", "world"]
    assert ts[0]["start"] == 0.0 and ts[-1]["end"] <= 1.0 + 1e-6
    assert ts == jax_ts(audio, "hello world", 0.0, 1.0, "en")


def test_engine_timestamps_aligner_failure_falls_back(monkeypatch, caplog):
    """A failing aligner: estimates (JAX's), and the failure logged and
    counted."""
    from qwen3_asr_tpu.runtime.engine import _word_timestamps as jax_ts
    from qwen3_asr_tpu_torch.runtime.engine import _word_timestamps

    class Broken:
        def align(self, *a):
            raise RuntimeError("boom")

    monkeypatch.setattr(sub, "_aligner", Broken())
    monkeypatch.setattr(jsub, "_aligner", Broken())
    before = sub.failures
    with caplog.at_level("ERROR", logger=sub.__name__):
        ts = _word_timestamps(speech_like(1.0), "one two", 0.0, 1.0, "en")
    assert [t["word"] for t in ts] == ["one", "two"]
    assert ts == jax_ts(speech_like(1.0), "one two", 0.0, 1.0, "en")
    assert sub.failures == before + 1 and "boom" in caplog.text


def test_subtitle_accurate_mode_with_aligner(ckpt, monkeypatch):
    """An accurate-mode SRT through ``load_aligner`` of
    ``FORCED_ALIGNER_ID`` on the CPU: the same bytes as JAX's."""
    monkeypatch.setattr(sub, "FORCED_ALIGNER_ID", ckpt)
    monkeypatch.setattr(jsub, "FORCED_ALIGNER_ID", ckpt)
    sub.unload_aligner()
    jsub.unload_aligner()
    sub.load_aligner("cpu")
    jsub.load_aligner()
    try:
        assert sub.aligner_loaded()
        audio = speech_like(3.0, seed=3)

        class R:
            text = "hello world. this is a longer test sentence."
            language = "en"

        srt = sub.generate_srt_from_results([R()], audio, 16000,
                                            mode="accurate")
        assert srt == jsub.generate_srt_from_results([R()], audio, 16000,
                                                     mode="accurate")
        assert "-->" in srt and "hello" in srt
    finally:
        sub.unload_aligner()
        jsub.unload_aligner()
    assert not sub.aligner_loaded()


def test_load_refuses_a_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a local checkpoint"):
        aligner.AlignerEngine.load(str(tmp_path / "none"), device="cpu")


def test_aligner_on_an_engines_model(ours):
    """``AlignerEngine(model)`` runs on the model it is given, on its
    device and dtype, with the loaded aligner's results."""
    again = aligner.AlignerEngine(ours.model)
    assert (again.device, again.dtype) == (torch.device("cpu"),
                                           torch.float32)
    audio = speech_like(2.0, seed=9)
    a = again.align(audio, 16000, "one two three", "en")
    b = ours.align(audio, 16000, "one two three", "en")
    assert [(w.text, w.start, w.end) for w in a] == \
        [(w.text, w.start, w.end) for w in b]
