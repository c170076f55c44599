"""Script-based language identification for transcribed text.

When a request uses ``language=auto``, the reference returns the SDK's
detected language code. This build detects from the decoded transcript's
Unicode scripts — exact for script-distinct languages (zh/ja/ko/th/hi/ar/ru)
and a serviceable default elsewhere. (With real checkpoints the model's own
language token, when emitted, takes precedence — see models/asr.py seam.)
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

_RANGES = (
    ((0x3040, 0x30FF), "ja"),     # hiragana + katakana (decisive for ja)
    ((0xAC00, 0xD7AF), "ko"),     # hangul
    ((0x0E00, 0x0E7F), "th"),     # thai
    ((0x0900, 0x097F), "hi"),     # devanagari
    ((0x0600, 0x06FF), "ar"),     # arabic
    ((0x0400, 0x04FF), "ru"),     # cyrillic
    ((0x4E00, 0x9FFF), "zh"),     # han (ja wins if kana present)
    ((0x3400, 0x4DBF), "zh"),
)


def detect_language(text: str, fallback: str = "en") -> Optional[str]:
    """Best-effort language code from the transcript's dominant script."""
    if not text or not text.strip():
        return None
    counts: Counter = Counter()
    latin = 0
    for ch in text:
        cp = ord(ch)
        if 0x41 <= cp <= 0x7A and ch.isalpha():
            latin += 1
            continue
        for (lo, hi), code in _RANGES:
            if lo <= cp <= hi:
                counts[code] += 1
                break
    if not counts:
        return fallback if latin else None
    # kana anywhere ⇒ japanese even with many han chars
    if counts.get("ja"):
        return "ja"
    top, top_n = counts.most_common(1)[0]
    return top if top_n >= max(1, latin // 4) else fallback
