"""The port's copy of the subtitle engine (``sidecars/subtitle.py``): each
case of ``tests/test_subtitle.py``, run on the port's functions with the
same inputs, whose outputs must equal the JAX package's exactly (SRT text
byte for byte, events and words field for field)."""
import dataclasses

import numpy as np
import pytest

from qwen3_asr_tpu.sidecars import subtitle as jsub
from qwen3_asr_tpu_torch.sidecars import subtitle as sub


def _plain(x):
    """Events and words as tuples, so the two packages' dataclasses
    compare."""
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    return x


def both(name, *args, **kwargs):
    """``name`` of the port on the inputs, checked equal to JAX's."""
    def convert(mod, v):
        if isinstance(v, list):
            return [convert(mod, e) for e in v]
        if dataclasses.is_dataclass(v):
            return getattr(mod, type(v).__name__)(*dataclasses.astuple(v))
        return v
    ours = getattr(sub, name)(*[convert(sub, a) for a in args],
                              **{k: convert(sub, v)
                                 for k, v in kwargs.items()})
    ref = getattr(jsub, name)(*[convert(jsub, a) for a in args],
                              **{k: convert(jsub, v)
                                 for k, v in kwargs.items()})
    assert _plain(ours) == _plain(ref)
    return ours


# -- timestamp formatting ---------------------------------------------------------

@pytest.mark.parametrize("seconds,want", [
    (0.0, "00:00:00,000"), (1.5, "00:00:01,500"), (61.25, "00:01:01,250"),
    (3661.001, "01:01:01,001")])
def test_format_timestamp_basic(seconds, want):
    assert both("_format_timestamp", seconds) == want


def test_format_timestamp_ms_rounding_carry():
    assert both("_format_timestamp", 0.9996) == "00:00:01,000"
    assert both("_format_timestamp", 59.9996) == "00:01:00,000"


def test_format_srt_structure():
    events = [sub.SubtitleEvent(1, 0.0, 1.0, "hello"),
              sub.SubtitleEvent(2, 1.5, 3.0, "world\ntwo lines")]
    blocks = both("format_srt", events).strip().split("\n\n")
    assert len(blocks) == 2
    assert blocks[0].splitlines() == ["1", "00:00:00,000 --> 00:00:01,000",
                                      "hello"]
    assert blocks[1].splitlines()[0] == "2"


# -- tokenization -------------------------------------------------------------------

def test_tokenize_english():
    assert both("_tokenize", "hello big world") == ["hello", "big", "world"]


def test_tokenize_cjk_char_level():
    assert both("_tokenize", "你好世界") == ["你", "好", "世", "界"]


def test_tokenize_mixed_cjk_latin():
    toks = both("_tokenize", "我用 python 写代码")
    assert "python" in toks
    assert "我" in toks and "码" in toks


@pytest.mark.parametrize("text", ["", "   ", "\t\n"])
def test_tokenize_empty(text):
    assert both("_tokenize", text) == []


@pytest.mark.parametrize("text,want", [("中文", True), ("mixed 中 text", True),
                                       ("pure english", False),
                                       ("カタカナ", True), ("한국어", False)])
def test_is_cjk(text, want):
    assert both("_is_cjk", text) is want


# -- segmentation -------------------------------------------------------------------

def _words(specs):
    return [sub.WordTimestamp(t, s, e) for t, s, e in specs]


def test_segment_sentence_break():
    events = both("segment_subtitles", _words([
        ("hello", 0.0, 0.4), ("world.", 0.5, 0.9), ("next", 1.0, 1.4),
        ("bit", 1.5, 1.9)]))
    assert [e.text for e in events] == ["hello world.", "next bit"]


def test_segment_pause_break():
    events = both("segment_subtitles",
                  _words([("one", 0.0, 0.4), ("two", 1.2, 1.6)]))
    assert len(events) == 2


def test_segment_char_limit():
    long_words = _words([(f"word{i:02d}xxxx", i * 0.3, i * 0.3 + 0.2)
                         for i in range(12)])
    events = both("segment_subtitles", long_words, max_line_chars=42)
    assert len(events) >= 2
    for e in events:
        assert len(e.text.replace("\n", " ")) <= 42 * 2 + 1


def test_segment_duration_limit():
    words = _words([(f"w{i}", i * 1.0, i * 1.0 + 0.9) for i in range(10)])
    events = both("segment_subtitles", words, max_duration=3.0,
                  pause_threshold=1.5)
    assert len(events) >= 2


def test_segment_empty():
    assert both("segment_subtitles", []) == []


def test_segment_indices_sequential():
    events = both("segment_subtitles", _words([("a.", 0, 0.5), ("b.", 1, 1.4),
                                               ("c.", 2, 2.4)]))
    assert [e.index for e in events] == [1, 2, 3]


def test_cjk_join_without_spaces():
    events = both("segment_subtitles",
                  _words([("你", 0.0, 0.2), ("好", 0.2, 0.4)]))
    assert events[0].text == "你好"


# -- two-line layout -----------------------------------------------------------------

def test_two_line_short_unchanged():
    assert both("_two_line_layout", "short text", 42) == "short text"


def test_two_line_break_at_clause():
    out = both("_two_line_layout",
               "first clause here, second clause follows after", 30)
    lines = out.split("\n")
    assert len(lines) == 2 and lines[0].endswith(",")


def test_two_line_break_before_conjunction():
    out = both("_two_line_layout",
               "the quick brown fox runs and the dog sleeps here", 30)
    lines = out.split("\n")
    assert len(lines) == 2 and lines[1].startswith("and ")


def test_two_line_single_word_unchanged():
    w = "x" * 60
    assert both("_two_line_layout", w, 42) == w


# -- timing enforcement ------------------------------------------------------------------

def test_enforce_min_duration():
    out = both("enforce_timing", [sub.SubtitleEvent(1, 0.0, 0.2, "quick")])
    assert out[0].end - out[0].start >= 0.833


def test_enforce_gap_and_overlap():
    out = both("enforce_timing", [sub.SubtitleEvent(1, 0.0, 2.5, "a"),
                                  sub.SubtitleEvent(2, 2.0, 4.0, "b")])
    assert out[0].end <= out[1].start - 0.083 + 1e-9 or \
        out[0].end - out[0].start == pytest.approx(0.833, abs=1e-6)


def test_enforce_negative_duration_fixed():
    out = both("enforce_timing", [sub.SubtitleEvent(1, 1.0, 0.5, "back")])
    assert out[0].end > out[0].start


def test_enforce_tightly_packed():
    out = both("enforce_timing", [
        sub.SubtitleEvent(i + 1, i * 0.3, i * 0.3 + 0.25, f"w{i}")
        for i in range(4)])
    for e in out:
        assert e.end - e.start >= 0.833 - 1e-9


def test_enforce_preserves_input():
    events = [sub.SubtitleEvent(1, 0.0, 0.1, "x")]
    sub.enforce_timing(events)
    assert events[0].end == 0.1


# -- fast estimates ------------------------------------------------------------------------

def test_estimate_proportional():
    words = both("estimate_word_timestamps", "hi there friend", 0.0, 3.0)
    assert len(words) == 3
    assert words[0].start == 0.0
    assert words[-1].end == pytest.approx(3.0)
    assert (words[1].end - words[1].start) > (words[0].end - words[0].start)


@pytest.mark.parametrize("text", ["", "   ", "你好 world again"])
def test_estimate_empty_and_mixed(text):
    words = both("estimate_word_timestamps", text, 0.25, 1.75)
    assert (words == []) == (not text.strip())


# -- orchestrator ------------------------------------------------------------------------

class _Result:
    def __init__(self, text, language="en"):
        self.text = text
        self.language = language


def _srt_both(results, audio, **kw):
    ours = sub.generate_srt_from_results(results, audio, 16000, **kw)
    ref = jsub.generate_srt_from_results(results, audio, 16000, **kw)
    assert ours == ref
    return ours


def test_generate_srt_fast_mode():
    srt = _srt_both([_Result("hello world. this is a test.")],
                    np.zeros(16000 * 4, np.float32), mode="fast")
    assert "-->" in srt and "hello world." in srt


def test_generate_srt_empty_results():
    audio = np.zeros(16000, np.float32)
    assert _srt_both([], audio, mode="fast") == ""
    assert _srt_both([_Result("")], audio, mode="fast") == ""


def test_generate_srt_accurate_requires_aligner(monkeypatch):
    monkeypatch.setattr(sub, "_aligner", None)
    with pytest.raises(RuntimeError, match="ForcedAligner not loaded"):
        sub.generate_srt_from_results([_Result("text")],
                                      np.zeros(16000, np.float32), 16000,
                                      mode="accurate")


def test_generate_srt_multiple_results_joined():
    srt = _srt_both([_Result("first segment."), _Result("second segment.")],
                    np.zeros(16000 * 6, np.float32), mode="fast")
    assert "first segment." in srt and "second segment." in srt


@pytest.mark.parametrize("max_line_chars", [20, 42])
def test_generate_srt_long_cjk_and_latin(max_line_chars):
    """A long mixed transcript through the whole fast pipeline: pauses,
    the two-line layout and the timing rules give the same SRT bytes."""
    text = ("this is the first sentence of a long talk, and it goes on "
            "for a while before it ends. 然后我们换成中文继续讲。 "
            "finally we come back to english for the last words!")
    srt = _srt_both([_Result(text), _Result("and one more segment.")],
                    np.zeros(16000 * 20, np.float32), mode="fast",
                    max_line_chars=max_line_chars)
    assert srt.count("-->") >= 2


def test_align_audio_splits_text_across_chunks(monkeypatch):
    """Over 300 s: the transcript is split across 5-minute chunks in
    proportion to their length, each chunk's words offset by its start,
    as JAX splits it; a chunk whose alignment fails falls back to
    estimates and is counted."""
    seen = {"port": [], "jax": []}

    def stub(name, mod):
        class Stub:
            def align(self, audio, sr, text, language):
                seen[name].append((len(audio), text))
                if len(seen[name]) == 2:
                    raise RuntimeError("aligner fault")
                return [mod.WordTimestamp(w, 0.1 * i, 0.1 * i + 0.05)
                        for i, w in enumerate(text.split())]
        return Stub()

    monkeypatch.setattr(sub, "_aligner", stub("port", sub))
    monkeypatch.setattr(jsub, "_aligner", stub("jax", jsub))
    text = " ".join(f"w{i}" for i in range(100))
    audio = np.zeros(16000 * 700, np.float32)
    before = sub.failures
    ours = sub.align_audio(audio, 16000, text, "en")
    ref = jsub.align_audio(audio, 16000, text, "en")
    assert _plain(ours) == _plain(ref)
    assert seen["port"] == seen["jax"]
    assert [n for n, _ in seen["port"]] == [4800000, 4800000, 1600000]
    assert sub.failures == before + 1
    assert len(ours) == 100 and ours[-1].start >= 600.0
