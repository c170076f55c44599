"""Accuracy metrics: WER and NFKC-normalized CER (a copy of
``qwen3_asr_tpu/utils/metrics.py``, so the port needs nothing of the JAX
package).

The evaluation harness metrics used by the reference E2E accuracy suite
(E2Etest/test_accuracy.py:19-81): edit-distance word error rate and
character error rate with NFKC normalization (CJK-appropriate).
"""
from __future__ import annotations

import re
import unicodedata
from typing import List


def _edit_distance(a: List[str], b: List[str]) -> int:
    """Levenshtein distance over token lists (O(len(a)·len(b)))."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, tok_a in enumerate(a, 1):
        cur = [i]
        for j, tok_b in enumerate(b, 1):
            cost = 0 if tok_a == tok_b else 1
            cur.append(min(prev[j] + 1,        # deletion
                           cur[j - 1] + 1,     # insertion
                           prev[j - 1] + cost))  # substitution
        prev = cur
    return prev[-1]


def _normalize_text(text: str) -> str:
    text = unicodedata.normalize("NFKC", text).lower()
    text = re.sub(r"[^\w\s一-鿿぀-ヿ가-힯]", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate in [0, ∞) — 0.0 is perfect."""
    ref = _normalize_text(reference).split()
    hyp = _normalize_text(hypothesis).split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate over NFKC-normalized text without spaces."""
    ref = list(_normalize_text(reference).replace(" ", ""))
    hyp = list(_normalize_text(hypothesis).replace(" ", ""))
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)
