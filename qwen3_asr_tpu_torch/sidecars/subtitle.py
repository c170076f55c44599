"""SRT subtitles: word timing, segmentation, two-line layout, SRT text, and
the forced aligner's lifetime.

The port's own copy of ``qwen3_asr_tpu/sidecars/subtitle.py`` (which
imports no JAX; the port imports nothing of the JAX package): ms-rounded
SRT timestamps with carry, CJK-aware tokenization, segmentation on a pause
over ``SUBTITLE_PAUSE_THRESHOLD`` / two lines of ``max_line_chars`` /
``SUBTITLE_MAX_DURATION`` / a break after sentence punctuation, the
two-line split scored by clause punctuation +3, a break before a
conjunction +2 and a bottom-heavy layout +1, timing enforcement
(``SUBTITLE_MIN_DURATION``, ``SUBTITLE_MIN_GAP``, two passes), the
5-minute-chunked forced alignment with its proportional split of the
transcript, and char-proportional estimates (``fast`` mode).

The aligner (``sidecars/aligner.py``) is one per process, as in the JAX
package: ``load_aligner`` loads ``FORCED_ALIGNER_ID`` (any ASR-format
checkpoint directory) on the device it is given. An alignment that fails
falls back to estimates, as JAX's does, and is logged and counted in
``failures`` (``align_audio``'s chunks and the engine's word timestamps).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
import time
from typing import List

from ..config import (
    SUBTITLE_MAX_DURATION,
    SUBTITLE_MIN_DURATION,
    SUBTITLE_MIN_GAP,
    SUBTITLE_PAUSE_THRESHOLD,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SubtitleEvent:
    index: int
    start: float
    end: float
    text: str


@dataclasses.dataclass
class WordTimestamp:
    text: str
    start: float
    end: float


# --- SRT formatting -----------------------------------------------------------

def _format_timestamp(seconds: float) -> str:
    """HH:MM:SS,mmm — rounding to ms FIRST so 0.9996 s never prints ',1000'."""
    ms = round(seconds * 1000)
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{int(h):02d}:{int(m):02d}:{int(s):02d},{int(ms):03d}"


def format_srt(events: List[SubtitleEvent]) -> str:
    return "\n".join(
        f"{e.index}\n{_format_timestamp(e.start)} --> "
        f"{_format_timestamp(e.end)}\n{e.text}\n"
        for e in events
    )


# --- tokenization --------------------------------------------------------------

_CJK_ANY = re.compile(
    r"[一-鿿぀-ゟ゠-ヿ　-〿＀-￯]")

# Character classes that time/segment per-character (Han incl. ext-A,
# kana, hangul). One regex does the whole scan: alternative 1 captures a
# single such character, alternative 2 a maximal run of anything else
# that isn't whitespace — which is exactly "split embedded Latin on
# whitespace" without an accumulator loop.
_PER_CHAR = r"一-鿿㐀-䶿぀-ヿ가-힯"
_TOKEN_SCAN = re.compile(f"[{_PER_CHAR}]|[^\\s{_PER_CHAR}]+")


def _is_cjk(text: str) -> bool:
    return bool(_CJK_ANY.search(text))


def _tokenize(text: str) -> List[str]:
    """CJK chars become single tokens; embedded Latin splits on whitespace."""
    if not text or not text.strip():
        return []
    if not _is_cjk(text):
        return text.split()
    return _TOKEN_SCAN.findall(text)


# --- segmentation ----------------------------------------------------------------

_SENTENCE_ENDERS = frozenset(".?!;")
_CLAUSE_BREAKS = frozenset(",:;")
_BREAK_BEFORE = frozenset({
    "and", "but", "or", "nor", "so", "yet",
    "in", "on", "at", "to", "for", "of", "with", "by", "from",
    "that", "which", "who", "whom", "where", "when", "while",
    "because", "although", "if", "unless", "until", "after", "before",
})


def _gap_score(words: List[str], gap: int, top_w: int, bottom_w: int) -> int:
    """Quality of breaking between words[gap-1] and words[gap]: clause
    punctuation before the break +3, conjunction/preposition after it +2,
    bottom-heavy layout +1."""
    return (3 * (words[gap - 1][-1] in _CLAUSE_BREAKS)
            + 2 * (words[gap].lower().rstrip(".,!?;:") in _BREAK_BEFORE)
            + (top_w <= bottom_w))


def _two_line_layout(text: str, max_line_chars: int) -> str:
    """Break an over-long caption into two lines at the best-scoring word gap."""
    if len(text) <= max_line_chars:
        return text
    words = text.split()
    if len(words) < 2:
        return text

    # Cumulative widths: span[g] = chars in words[:g] joined by spaces, so
    # every candidate line length is O(1) instead of re-joining strings.
    span = [0]
    for w in words:
        span.append(span[-1] + len(w) + 1)
    full = span[-1] - 1

    fitting = []
    for gap in range(1, len(words)):
        top_w, bottom_w = span[gap] - 1, full - span[gap]
        if top_w <= max_line_chars and bottom_w <= max_line_chars:
            fitting.append((_gap_score(words, gap, top_w, bottom_w), gap))

    if not fitting:
        # A single overflowing line beats a broken layout.
        return text
    # max() keeps the earliest gap among score ties, matching first-wins.
    _, cut = max(fitting, key=lambda sg: sg[0])
    return " ".join(words[:cut]) + "\n" + " ".join(words[cut:])


def segment_subtitles(words: List[WordTimestamp], max_line_chars: int = 42,
                      max_duration: float = SUBTITLE_MAX_DURATION,
                      pause_threshold: float = SUBTITLE_PAUSE_THRESHOLD,
                      ) -> List[SubtitleEvent]:
    """Group timed words into caption events (two lines of max_line_chars)."""
    if not words:
        return []

    cjk = _is_cjk("".join(w.text for w in words))
    joiner = "" if cjk else " "
    max_chars = max_line_chars * 2
    events: List[SubtitleEvent] = []
    group: List[WordTimestamp] = []

    def flush():
        if not group:
            return
        caption = _two_line_layout(joiner.join(w.text for w in group),
                                   max_line_chars)
        events.append(SubtitleEvent(len(events) + 1, group[0].start,
                                    group[-1].end, caption))
        group.clear()

    for word in words:
        if group:
            grown = joiner.join(w.text for w in group) + joiner + word.text
            long_pause = (word.start - group[-1].end) > pause_threshold
            too_long = len(grown.strip()) > max_chars
            over_duration = (word.end - group[0].start) > max_duration
            if long_pause or too_long or over_duration:
                flush()
        group.append(word)
        if word.text and word.text[-1] in _SENTENCE_ENDERS:
            flush()

    flush()
    return events


def enforce_timing(events: List[SubtitleEvent],
                   min_duration: float = SUBTITLE_MIN_DURATION,
                   min_gap: float = SUBTITLE_MIN_GAP) -> List[SubtitleEvent]:
    """Extend short captions, separate overlaps; two passes because the gap
    fix can re-shrink a caption below min_duration."""
    if not events:
        return events
    out = [dataclasses.replace(e) for e in events]
    for e in out:
        if e.end - e.start < min_duration:
            e.end = e.start + min_duration
    for cur, nxt in zip(out, out[1:]):
        if nxt.start - cur.end < min_gap:
            cur.end = max(cur.start + min_duration, nxt.start - min_gap)
    for e in out:
        if e.end - e.start < min_duration:
            e.end = e.start + min_duration
    return out


# --- fast mode -----------------------------------------------------------------

def estimate_word_timestamps(text: str, start: float, end: float
                             ) -> List[WordTimestamp]:
    """Char-proportional word timing (fast mode / aligner fallback)."""
    tokens = _tokenize(text or "")
    total_chars = sum(len(t) for t in tokens)
    if not tokens or total_chars == 0:
        return []
    duration = end - start
    out, t = [], start
    for tok in tokens:
        dt = duration * (len(tok) / total_chars)
        out.append(WordTimestamp(tok, t, t + dt))
        t += dt
    return out


# --- forced aligner ---------------------------------------------------------------

_aligner = None

FORCED_ALIGNER_ID = os.getenv("FORCED_ALIGNER_ID",
                              "Qwen/Qwen3-ForcedAligner-0.6B")
_ALIGNER_MAX_SECONDS = 300  # 5-minute per-call limit

# alignments that fell back to char-proportional estimates, this process
failures = 0
_failures_lock = threading.Lock()


def count_failure(where: str) -> None:
    """Log the exception being handled (an alignment that failed and fell
    back to estimates) and count it in ``failures``."""
    global failures
    with _failures_lock:
        failures += 1
    log.exception("%s: alignment failed; char-proportional estimates "
                  "instead", where)


def load_aligner(device=None) -> None:
    """Load the forced aligner from ``FORCED_ALIGNER_ID`` on ``device``
    (the card unless asked for the CPU), unless one is loaded."""
    global _aligner
    if _aligner is not None:
        return
    from .aligner import AlignerEngine
    log.info("Loading ForcedAligner: %s...", FORCED_ALIGNER_ID)
    _aligner = AlignerEngine.load(FORCED_ALIGNER_ID, device)
    log.info("ForcedAligner loaded")


def unload_aligner() -> None:
    global _aligner
    if _aligner is None:
        return
    _aligner = None
    log.info("ForcedAligner unloaded")


def aligner_loaded() -> bool:
    return _aligner is not None


def aligner_bytes(shared=None) -> int:
    """Device bytes of the loaded aligner's weights (0 with none loaded),
    less the tensors it shares with the parameter tree ``shared`` (an
    aligner built on the engine's own weights adds nothing)."""
    from ..ops.quant import param_leaves
    aligner = _aligner
    if aligner is None:
        return 0
    seen = ({t.data_ptr() for t in param_leaves(shared)}
            if shared is not None else set())
    return sum(t.nbytes for t in param_leaves(aligner.model.params)
               if t.data_ptr() not in seen)


def align_audio(audio, sr: int, text: str, language: str
                ) -> List[WordTimestamp]:
    """Word-level alignment with 5-minute chunking + heuristic fallback.

    Long audio: the transcript is partitioned across chunks proportionally
    to chunk duration (the aligner maps EVERY given token into the audio it
    is shown, so each chunk must only see its own share of text).
    """
    if _aligner is None:
        raise RuntimeError("ForcedAligner not loaded. Call load_aligner() first.")

    total = len(audio)
    max_samples = _ALIGNER_MAX_SECONDS * sr
    if total <= max_samples:
        return _align_chunk(audio, sr, text, language, 0.0)

    tokens = _tokenize(text)
    joiner = "" if _is_cjk(text) else " "
    n_chunks = -(-total // max_samples)
    words: List[WordTimestamp] = []
    pos, offset, tok_pos = 0, 0.0, 0
    for ci in range(n_chunks):
        chunk = audio[pos:pos + max_samples]
        chunk_s = len(chunk) / sr
        # this chunk's proportional share of the transcript
        tok_end = (len(tokens) if ci == n_chunks - 1 else
                   round(len(tokens) * (pos + len(chunk)) / total))
        chunk_text = joiner.join(tokens[tok_pos:tok_end])
        try:
            words.extend(_align_chunk(chunk, sr, chunk_text, language, offset))
        except Exception:
            count_failure(f"align_audio chunk {ci}")
            words.extend(estimate_word_timestamps(chunk_text, offset,
                                                  offset + chunk_s))
        tok_pos = tok_end
        offset += chunk_s
        pos += max_samples
    return words


def _align_chunk(audio, sr, text, language, time_offset: float
                 ) -> List[WordTimestamp]:
    results = _aligner.align(audio, sr, text, language)
    return [WordTimestamp(w.text, w.start + time_offset, w.end + time_offset)
            for w in results]


# --- orchestrator ------------------------------------------------------------------

def generate_srt_from_results(results: list, audio, sr: int,
                              mode: str = "accurate",
                              max_line_chars: int = 42) -> str:
    """ASR results → SRT text."""
    if not results:
        return ""
    text = " ".join(r.text for r in results if r.text).strip()
    if not text:
        return ""
    language = getattr(results[0], "language", "en")
    audio_duration = len(audio) / sr

    log.info("SRT generation | mode=%s segments=%d audio_duration=%.1fs "
             "max_chars=%d", mode, len(results), audio_duration,
             max_line_chars)
    t0 = time.time()

    if mode == "accurate":
        if _aligner is None:
            raise RuntimeError("ForcedAligner not loaded. Call load_aligner() "
                               "before using accurate mode.")
        words = align_audio(audio, sr, text, language)
    else:
        words = estimate_word_timestamps(text, 0.0, audio_duration)

    if not words:
        return ""

    events = enforce_timing(segment_subtitles(words,
                                              max_line_chars=max_line_chars))
    srt = format_srt(events)
    log.info("SRT generation complete | events=%d srt_len=%d elapsed=%.2fs",
             len(events), len(srt), time.time() - t0)
    return srt
