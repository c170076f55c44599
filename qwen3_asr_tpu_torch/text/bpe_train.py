"""Byte-level BPE training in plain Python, written as a ``tokenizer.json``.

Counterpart of the ``tokenizers`` package's ``BpeTrainer`` as the JAX
package's ``tools/overfit.py`` ``build_tokenizer`` drives it
(``models.BPE()``, ``pre_tokenizers.ByteLevel(add_prefix_space=False)``,
``initial_alphabet=ByteLevel.alphabet()``, no frequency floor, no alphabet
limit, no subword prefix or suffix). The same texts give the same
vocabulary and the same merges, in the same order:

- words are the GPT-2 pre-tokenizer's pieces (``text/tokenizer.py``
  ``pre_tokenize(..., GPT2)``), each mapped byte by byte to printable
  characters (``bytes_to_unicode``), counted over the corpus;
- the special tokens take ids 0.. in the order given, then the alphabet
  (every character of the words and of the initial alphabet) in code-point
  order;
- a pair's count is the sum, over the words holding it, of the word's
  count times its occurrences (overlapping ones too, as a window of two
  symbols sees them); the most frequent pair merges first, and a tie goes
  to the pair whose (left id, right id) is smallest;
- the merged token takes the next id unless its string already has one;
- a merge rewrites only the words that held the pair when its queue entry
  was made, left to right without overlap, and changes the counts of the
  neighbouring pairs; the merged pair's own count is left as it was, and
  an entry whose count went stale goes back into the queue with the
  current count (the queue of ``tokenizers``' trainer, entry for entry);
- training stops when the vocabulary is full or no pair is left.
"""
from __future__ import annotations

import heapq
import itertools
import json
from typing import Dict, Iterable, List, Sequence, Tuple

from .tokenizer import GPT2, bytes_to_unicode, pre_tokenize


def byte_alphabet() -> List[str]:
    """``ByteLevel.alphabet()``: the 256 characters bytes map to."""
    return sorted(bytes_to_unicode().values())


def word_counts(texts: Iterable[str]) -> Dict[str, int]:
    """Byte-level words of ``texts`` and how often each occurs."""
    enc = bytes_to_unicode()
    counts: Dict[str, int] = {}
    for text in texts:
        for piece in pre_tokenize(text, GPT2):
            word = "".join(enc[b] for b in piece.encode("utf-8"))
            counts[word] = counts.get(word, 0) + 1
    return counts


def _merge_word(word: List[int], a: int, b: int, new: int
                ) -> List[Tuple[Tuple[int, int], int]]:
    """Replace each (a, b) of ``word`` in place, left to right; return the
    neighbouring pairs' count changes, one per lost or new pair."""
    changes = []
    i = 0
    while i < len(word):
        if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
            if i > 0:
                changes.append(((word[i - 1], a), -1))
                changes.append(((word[i - 1], new), 1))
            word[i:i + 2] = [new]
            if i < len(word) - 1:
                changes.append(((b, word[i + 1]), -1))
                changes.append(((new, word[i + 1]), 1))
        i += 1
    return changes


def train_bpe(texts: Iterable[str], vocab_size: int,
              special_tokens: Sequence[str] = (),
              initial_alphabet: Sequence[str] = ()
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """(vocab, merges) of byte-level BPE trained on ``texts``."""
    counts = word_counts(texts)
    vocab: Dict[str, int] = {}
    tokens: List[str] = []

    def add(tok: str) -> int:
        if tok not in vocab:
            vocab[tok] = len(tokens)
            tokens.append(tok)
        return vocab[tok]

    for tok in special_tokens:
        add(tok)
    alphabet = {c for word in counts for c in word} | set(initial_alphabet)
    for c in sorted(alphabet):
        add(c)

    words = [[vocab[c] for c in word] for word in counts]
    freq = list(counts.values())
    pair_count: Dict[Tuple[int, int], int] = {}
    where: Dict[Tuple[int, int], set] = {}
    for i, word in enumerate(words):
        for pair in zip(word, word[1:]):
            pair_count[pair] = pair_count.get(pair, 0) + freq[i]
            where.setdefault(pair, set()).add(i)

    # max-heap on (count, then the smallest pair); the sequence number only
    # keeps heapq from comparing the position sets
    seq = itertools.count()
    queue: list = []

    def push(pair, pos):
        heapq.heappush(queue, (-pair_count[pair], pair, next(seq), pos))

    for pair, pos in where.items():
        if pair_count[pair] > 0:
            push(pair, pos)

    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size and queue:
        neg, pair, _, pos = heapq.heappop(queue)
        if -neg != pair_count[pair]:
            push(pair, pos)
            continue
        if -neg < 1:
            break
        a, b = pair
        new = add(tokens[a] + tokens[b])
        merges.append((tokens[a], tokens[b]))
        touched: Dict[Tuple[int, int], set] = {}
        for i in sorted(pos):
            for changed, delta in _merge_word(words[i], a, b, new):
                pair_count[changed] = (pair_count.get(changed, 0)
                                       + delta * freq[i])
                if delta > 0:
                    touched.setdefault(changed, set()).add(i)
        for changed, where_now in touched.items():
            if pair_count[changed] > 0:
                push(changed, where_now)
    return vocab, merges


def tokenizer_json(vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                   special_tokens: Sequence[str] = ()) -> dict:
    """A byte-level BPE ``tokenizer.json`` in the layout ``tokenizers``
    saves: the specials as special added tokens, the ByteLevel
    pre-tokenizer and decoder, the vocabulary in id order."""
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [
            {"id": vocab[tok], "content": tok, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False,
             "special": True} for tok in special_tokens],
        "normalizer": None,
        "pre_tokenizer": byte_level,
        "post_processor": None,
        "decoder": dict(byte_level, add_prefix_space=True),
        "model": {
            "type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False,
            "ignore_merges": False,
            "vocab": dict(sorted(vocab.items(), key=lambda kv: kv[1])),
            "merges": [list(m) for m in merges],
        },
    }


def write_tokenizer(path: str, vocab: Dict[str, int],
                    merges: Sequence[Tuple[str, str]],
                    special_tokens: Sequence[str] = ()) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(tokenizer_json(vocab, merges, special_tokens), f,
                  indent=2, ensure_ascii=False)
