"""Pathological-repetition post-processor for ASR output.

Behavioral parity with the reference's endpoint-level cleanup
(src/server.py:170-197): texts under 10 chars pass through, runs of a
single word repeated 3+ times collapse to one, and short phrases (3-8
words) repeated more than ``max_repeats`` consecutive times collapse to a
single copy.

Implementation is a run-length formulation: word runs are found by scanning
``\\w+`` token matches and their separators; phrase runs use the transitive
shift-equality property — ``r`` consecutive copies of a ``p``-word phrase at
position ``i`` exist iff ``words[k] == words[k+p]`` for every
``k in [i, i+(r-1)*p)`` — so one boolean "equal to the word a phrase later"
array gives every run length by integer division.
"""
from __future__ import annotations

import re

_WORD = re.compile(r"\w+")


def _collapse_word_runs(text: str) -> str:
    """Collapse 3+ consecutive identical words (single-space separated)."""
    matches = list(_WORD.finditer(text))
    spans = []  # (start, end) of runs to replace with one word
    i = 0
    while i < len(matches):
        j = i
        while (j + 1 < len(matches)
               and matches[j + 1].group() == matches[i].group()
               and text[matches[j].end():matches[j + 1].start()] == " "):
            j += 1
        if j - i >= 2:  # 3+ copies
            spans.append((matches[i].start(), matches[j].end(),
                          matches[i].group()))
        i = j + 1
    if not spans:
        return text
    out, pos = [], 0
    for start, end, word in spans:
        out.append(text[pos:start])
        out.append(word)
        pos = end
    out.append(text[pos:])
    return "".join(out)


def _collapse_phrase_runs(words: list, plen: int, limit: int) -> list:
    """Keep at most one copy of any phrase repeated more than ``limit``
    consecutive times; shorter runs pass through unchanged."""
    n = len(words)
    eq = [words[k] == words[k + plen] for k in range(n - plen)]
    out, i = [], 0
    while i < n:
        out.extend(words[i:i + plen])
        run = i
        while run < n - plen and eq[run]:
            run += 1
        reps = 1 + (run - i) // plen
        i += reps * plen if reps > limit else plen
    return out


def detect_and_fix_repetitions(text: str, max_repeats: int = 2) -> str:
    """Remove pathological repetitions from ASR output."""
    if not text or len(text) < 10:
        return text
    text = _collapse_word_runs(text)
    words = text.split()
    for plen in range(3, min(9, len(words) // 3 + 1)):
        words = _collapse_phrase_runs(words, plen, max_repeats)
    return " ".join(words)
