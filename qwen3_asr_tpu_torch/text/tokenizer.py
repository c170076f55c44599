"""Byte-level BPE tokenizer — pure Python, loads HF tokenizer.json.

Counterpart of ``qwen3_asr_tpu/text/tokenizer.py``, without the ``regex``
package: the two pre-tokenizer patterns it supports are matched by a
hand-written scanner. The patterns, for reference:

  Qwen:  (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}|
         ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+
  GPT-2: 's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
         \\s+(?!\\S)|\\s+

``\\p{L}``/``\\p{N}`` are the Unicode categories L*/N* from ``unicodedata``
(the interpreter's Unicode tables) and ``\\s`` is ``str.isspace`` less the
four separator controls U+001C..U+001F, which ``\\s`` does not match.
"""
from __future__ import annotations

import functools
import json
import unicodedata
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

QWEN = "qwen"
GPT2 = "gpt2"

# The Qwen2 pre-tokenizer regex as tokenizer.json spells it; any other
# Split pattern is refused rather than approximated.
_QWEN_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
    r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# (?i:...) folds: 's' also matches U+017F LATIN SMALL LETTER LONG S.
_FOLD = {"ſ": "s"}


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte ↔ printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_space(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _is_other(c: str) -> bool:
    """[^\\s\\p{L}\\p{N}]"""
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def _run(text: str, i: int, pred: Callable[[str], bool]) -> int:
    """End of the run of characters from ``i`` that satisfy ``pred``."""
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def _contraction(text: str, i: int, fold_case: bool) -> int:
    """End of a contraction match at ``i``, or -1."""
    if text[i] != "'":
        return -1
    for c in _CONTRACTIONS:
        seg = text[i + 1:i + 1 + len(c)]
        if fold_case:
            seg = "".join(_FOLD.get(ch, ch.lower()) for ch in seg)
            # only ASCII letters and U+017F fold onto the contraction letters
            if any(ord(ch) > 127 and ch not in _FOLD
                   for ch in text[i + 1:i + 1 + len(c)]):
                continue
        if seg == c:
            return i + 1 + len(c)
    return -1


def _whitespace(text: str, i: int) -> int:
    """``\\s+(?!\\S)|\\s+`` at a whitespace position."""
    j = _run(text, i, _is_space)
    if j == len(text) or j - 1 == i:
        return j
    return j - 1


def _match_qwen(text: str, i: int) -> int:
    c = text[i]
    n = len(text)
    end = _contraction(text, i, fold_case=True)
    if end > 0:
        return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if (c not in "\r\n" and not _is_letter(c) and not _is_number(c)
            and i + 1 < n and _is_letter(text[i + 1])):
        return _run(text, i + 1, _is_letter)
    if _is_letter(c):
        return _run(text, i, _is_letter)
    if _is_number(c):                                   # \p{N}
        return i + 1
    # " ?[^\s\p{L}\p{N}]+[\r\n]*"
    start = i + 1 if c == " " and i + 1 < n and _is_other(text[i + 1]) else i
    if _is_other(text[start]):
        j = _run(text, start, _is_other)
        return _run(text, j, lambda ch: ch in "\r\n")
    # \s*[\r\n]+ : up to the last newline of the whitespace run
    j = _run(text, i, _is_space)
    last_nl = max(text.rfind("\r", i, j), text.rfind("\n", i, j))
    if last_nl >= 0:
        return last_nl + 1
    return _whitespace(text, i)


def _match_gpt2(text: str, i: int) -> int:
    end = _contraction(text, i, fold_case=False)
    if end > 0:
        return end
    c = text[i]
    for pred in (_is_letter, _is_number, _is_other):   # " ?X+" in order
        if c == " " and i + 1 < len(text) and pred(text[i + 1]):
            return _run(text, i + 1, pred)
        if pred(c):
            return _run(text, i, pred)
    return _whitespace(text, i)


def pre_tokenize(text: str, kind: str = QWEN) -> List[str]:
    """Split ``text`` into the pieces the pattern's ``findall`` gives."""
    match = _match_qwen if kind == QWEN else _match_gpt2
    pieces = []
    i = 0
    while i < len(text):
        j = match(text, i)
        pieces.append(text[i:j])
        i = j
    return pieces


_UNICODE_NORM_TYPES = ("NFC", "NFD", "NFKC", "NFKD")


def _unicode_norm_forms(norm: Optional[dict]) -> List[str]:
    """Unicode-normalization forms declared by a tokenizer.json
    ``normalizer`` block, in application order (flattens Sequence)."""
    if not norm:
        return []
    kind = norm.get("type")
    if kind in _UNICODE_NORM_TYPES:
        return [kind]
    if kind == "Sequence":
        out: List[str] = []
        for sub in norm.get("normalizers", []):
            out.extend(_unicode_norm_forms(sub))
        return out
    return []


class BpeTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 special_tokens: Optional[Dict[str, int]] = None,
                 pattern: str = QWEN,
                 added_tokens: Optional[Dict[str, int]] = None,
                 norm_forms: Sequence[str] = ()):
        """special_tokens: added tokens with HF ``special: true`` — matched
        atomically on encode and skipped by decode(skip_special=True).
        added_tokens: ``special: false`` entries — matched atomically on
        encode but always emitted by decode. pattern: ``QWEN`` or ``GPT2``.
        norm_forms: Unicode normalization forms applied, in order, to
        ordinary text before pre-tokenization."""
        if pattern not in (QWEN, GPT2):
            raise ValueError(f"unknown pre-tokenizer pattern {pattern!r}")
        self.vocab = dict(vocab)
        self.norm_forms = tuple(norm_forms)
        self.special_tokens = dict(special_tokens or {})
        self.added_tokens = dict(added_tokens or {})
        self.vocab.update(self.special_tokens)
        self.vocab.update(self.added_tokens)
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        self.merge_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.pattern = pattern
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        self._special_ids = set(self.special_tokens.values())
        self._added_ids = set(self.added_tokens.values())
        self._atomic = {**self.special_tokens, **self.added_tokens}
        # longest first, as the alternation of the reference's split regex
        self._atomic_sorted = sorted(self._atomic, key=len, reverse=True)
        self._bpe_cache: Dict[str, List[str]] = {}

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_file(path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        model = blob["model"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        special = {t["content"]: t["id"]
                   for t in blob.get("added_tokens", [])
                   if t.get("special", True)}
        added = {t["content"]: t["id"]
                 for t in blob.get("added_tokens", [])
                 if not t.get("special", True)}
        pattern = QWEN
        pre = blob.get("pre_tokenizer") or {}
        for sub in pre.get("pretokenizers", [pre]):
            if sub.get("type") == "Split":
                regex = sub.get("pattern", {}).get("Regex", _QWEN_PATTERN)
                if regex != _QWEN_PATTERN:
                    raise NotImplementedError(
                        "pre-tokenizer Split pattern is not the Qwen2 "
                        f"pattern: {regex!r}")
                pattern = QWEN
                break
            if sub.get("type") == "ByteLevel":
                pattern = GPT2
                break
        return BpeTokenizer(model["vocab"], merges, special, pattern,
                            added_tokens=added,
                            norm_forms=_unicode_norm_forms(
                                blob.get("normalizer")))

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    # -- BPE core -------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                rank = self.merge_ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_idx = rank, i
            if best_rank is None:
                break
            parts = (parts[:best_idx]
                     + [parts[best_idx] + parts[best_idx + 1]]
                     + parts[best_idx + 2:])
        if len(self._bpe_cache) < 50_000:
            self._bpe_cache[token] = parts
        return parts

    def _encode_ordinary(self, text: str) -> List[int]:
        for form in self.norm_forms:
            text = unicodedata.normalize(form, text)
        ids: List[int] = []
        for piece in pre_tokenize(text, self.pattern):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            for part in self._bpe(mapped):
                idx = self.vocab.get(part)
                if idx is None:
                    # unknown byte sequence: fall back to single-byte tokens
                    for ch in part:
                        ids.append(self.vocab.get(ch, 0))
                else:
                    ids.append(idx)
        return ids

    def _split_atomic(self, text: str) -> List[str]:
        """Split out special/added tokens (leftmost, longest first)."""
        chunks, start, i = [], 0, 0
        while i < len(text):
            for tok in self._atomic_sorted:
                if text.startswith(tok, i):
                    chunks.append(text[start:i])
                    chunks.append(tok)
                    i += len(tok)
                    start = i
                    break
            else:
                i += 1
        chunks.append(text[start:])
        return chunks

    # -- public API ------------------------------------------------------------
    def encode(self, text: str, allow_special: bool = True) -> List[int]:
        if not text:
            return []
        if allow_special and self._atomic:
            ids: List[int] = []
            for chunk in self._split_atomic(text):
                if not chunk:
                    continue
                if chunk in self._atomic:
                    ids.append(self._atomic[chunk])
                else:
                    ids.extend(self._encode_ordinary(chunk))
            return ids
        return self._encode_ordinary(text)

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                joined = "".join(buf)
                data = bytes(self._byte_dec.get(c, ord("?") & 0xFF)
                             for c in joined)
                out.append(data.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if int(i) in self._special_ids:
                flush()
                if not skip_special:
                    out.append(tok)
            elif int(i) in self._added_ids:
                flush()
                out.append(tok)  # non-special added tokens always survive
            else:
                buf.append(tok)
        flush()
        return "".join(out)
