"""The port's byte-level BPE trainer (``text/bpe_train.py``) against the
``tokenizers`` package's ``BpeTrainer``, as the JAX package's
``tools/overfit.py`` ``build_tokenizer`` drives it: the same vocabulary and
merges on the JAX tool's corpus (and the committed
``e2e/data/trained_ckpt/tokenizer.json`` byte for byte) and on seeded
corpora built to tie; the written file loaded by both libraries gives the
same ids."""
import glob
import json
import os

import numpy as np
import pytest

from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

from qwen3_asr_tpu.tools.overfit import build_tokenizer as jax_build
from qwen3_asr_tpu_torch.text.bpe_train import byte_alphabet, train_bpe
from qwen3_asr_tpu_torch.text.tokenizer import BpeTokenizer
from qwen3_asr_tpu_torch.tools.overfit import SPECIALS, build_tokenizer

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
COMMITTED = os.path.join(ROOT, "trained_ckpt", "tokenizer.json")
TEXTS = [open(p, encoding="utf-8").read().strip()
         for p in sorted(glob.glob(os.path.join(ROOT, "real", "*.txt")))]


def hf_train(corpus, vocab_size):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=SPECIALS, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus, trainer)
    model = json.loads(tok.to_str())["model"]
    return model["vocab"], model["merges"]


def test_jax_tool_corpus_equals_tokenizers_and_committed_file(tmp_path):
    assert len(TEXTS) == 12
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    build_tokenizer(TEXTS, str(ours))
    jax_build(TEXTS, str(theirs))
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert got["model"]["vocab"] == want["model"]["vocab"]
    assert got["model"]["merges"] == want["model"]["merges"]
    assert len(got["model"]["merges"]) == 850
    assert len(got["model"]["vocab"]) == 6 + 256 + 850
    with open(COMMITTED, encoding="utf-8") as f:
        assert ours.read_text(encoding="utf-8") == f.read()


def test_texts_twice_do_not_give_the_committed_file(tmp_path):
    """The corpus's repeats matter: the same texts listed twice train
    another tokenizer, in both libraries alike."""
    path = tmp_path / "t.json"
    build_tokenizer(TEXTS * 2, str(path))
    got = json.loads(path.read_text())["model"]
    with open(COMMITTED, encoding="utf-8") as f:
        assert got["merges"] != json.load(f)["model"]["merges"]
    jax_build(TEXTS * 2, str(tmp_path / "j.json"))
    assert got == json.loads((tmp_path / "j.json").read_text())["model"]


# Pieces whose random joins make equal pair counts, multi-byte characters,
# whitespace runs, digits and contractions.
POOLS = {
    "ties": ["ab", "ba", "cd", "dc", " ", "x"],
    "letters": list("ab c"),
    "cjk": list("我们的语音识别模型你好世界 "),
    "thai": list("สวัสดีครับภาษาไทย "),
    "emoji": ["😀", "🎉", "👍🏽", "a", " ", "é"],
    "whitespace": [" ", "  ", "\t", "\n", "\r\n", "a", "b", "　",
                   "\xa0", " \n "],
    "digits": list("0123456789 ab"),
    "contractions": ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "it", " ",
                     "'", "S", "'S"],
    "mixed": ["a", "b", "我", "ส", "😀", " ", "1", "'s", "\n", "!", "?!"],
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_tie_corpora_equal_tokenizers(pool, seed):
    rng = np.random.default_rng(1000 * seed + len(pool))
    corpus = ["".join(rng.choice(POOLS[pool], rng.integers(1, 12)))
              for _ in range(rng.integers(5, 30))]
    # a vocabulary that fills mid-way, and one no corpus here fills
    for vocab_size in (262 + 4 * (seed + 1), 2048):
        vocab, merges = train_bpe(corpus, vocab_size, SPECIALS,
                                  byte_alphabet())
        want_vocab, want_merges = hf_train(corpus, vocab_size)
        assert vocab == want_vocab
        assert [list(m) for m in merges] == want_merges


def test_written_file_loads_in_both_libraries(tmp_path):
    path = tmp_path / "tokenizer.json"
    build_tokenizer(TEXTS, str(path))
    hf = Tokenizer.from_file(str(path))
    port = BpeTokenizer.from_file(str(path))
    assert port.vocab_size == hf.get_vocab_size() == 1112
    probes = TEXTS + ["Language: English\n", "system", "You are a speech "
                      "recognition model.", "unseen words 123 ร้าน 🎉"]
    for text in probes:
        ids = port.encode(text)
        assert ids == hf.encode(text).ids
        assert port.decode(ids) == text


def test_specials_and_alphabet_ids():
    vocab, merges = train_bpe(["aa aa"], 300, SPECIALS, byte_alphabet())
    assert [vocab[t] for t in SPECIALS] == list(range(6))
    assert sorted(vocab, key=vocab.get)[6:262] == byte_alphabet()
    assert merges == [("a", "a"), ("Ġ", "aa")]
    assert vocab["aa"] == 262 and vocab["Ġaa"] == 263
