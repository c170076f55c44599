"""The port's host-side front end against the JAX package: log-mel (to
1e-4: the two rfft implementations differ around 1e-6 before the log10),
WAV decode (exact) and the tokenizer without ``regex`` (exact ids)."""
import glob
import os
import struct

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.audio.codec import AudioDecodeError as JaxDecodeError
from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
from qwen3_asr_tpu.audio.frontend import LogMelFrontend as JaxFrontend
from qwen3_asr_tpu.audio.frontend import _log_mel_impl
from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
from qwen3_asr_tpu.text.tokenizer import (_GPT2_PATTERN, _QWEN_PATTERN,
                                          BpeTokenizer as JaxTokenizer)
from qwen3_asr_tpu_torch.audio.codec import (AudioDecodeError,
                                             UnsupportedFormatError,
                                             decode_audio)
from qwen3_asr_tpu_torch.audio.frontend import LogMelFrontend
from qwen3_asr_tpu_torch.models.asr import PromptTemplate
from qwen3_asr_tpu_torch.runtime.engine import AUDIO_BUCKETS_S
from qwen3_asr_tpu_torch.text.tokenizer import (GPT2, QWEN, BpeTokenizer,
                                                pre_tokenize)

ROOT = os.path.join(os.path.dirname(__file__), "..")
REAL = os.path.join(ROOT, "e2e", "data", "real")
CKPT = os.path.join(ROOT, "e2e", "data", "trained_ckpt")
CLIPS = sorted(glob.glob(os.path.join(REAL, "*.wav")))
MEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bucket_lengths():
    """(n_mels, bucket frames) for trained_ckpt (32 mels, 100-frame chunks)
    and preset:1.7b (128 mels, 200-frame chunks)."""
    out = []
    for n_mels, chunk in ((32, 100), (128, 200)):
        frames = sorted({-(-int(s * 100) // chunk) * chunk
                         for s in AUDIO_BUCKETS_S})
        out += [(n_mels, f) for f in frames]
    return out


@pytest.mark.parametrize("n_mels,frames", _bucket_lengths())
def test_log_mel_matches_jax(n_mels, frames):
    n = frames * 160
    rng = np.random.default_rng(frames + n_mels)
    audio = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    n_valid = [n, int(rng.integers(n // 3, n - 1))]   # at the end, inside
    jf = JaxFrontend(n_mels=n_mels)
    ref = [np.asarray(_log_mel_impl(jnp.asarray(audio[i]),
                                    jnp.int32(n_valid[i]), jf.window,
                                    jf.mel_fb, n_mels)[0]) for i in range(2)]
    ours, valid = LogMelFrontend(n_mels, "cpu")(torch.from_numpy(audio),
                                                torch.tensor(n_valid))
    assert ours.shape == (2, n_mels, frames)
    for i in range(2):
        np.testing.assert_allclose(ours[i].numpy(), ref[i], atol=MEL_TOL,
                                   rtol=0)
    assert valid.tolist() == [min(-(-v // 160), frames) for v in n_valid]


def _wav(pcm: bytes, sr: int, channels: int, bits: int, fmt_tag: int = 1):
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, sr, sr * block, block,
                      bits)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(pcm))
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def _synthetic_wavs():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 2000)
    return {
        "u8_mono": _wav(((x + 1) * 127.5).astype(np.uint8).tobytes(),
                        8000, 1, 8),
        "s16_stereo": _wav((x * 32000).astype("<i2").tobytes(), 22050, 2, 16),
        "s24_mono": _wav(b"".join(int(v).to_bytes(3, "little", signed=True)
                                  for v in (x * 8e6).astype(np.int64)),
                         16000, 1, 24),
        "s32_mono": _wav((x * 2e9).astype("<i4").tobytes(), 48000, 1, 32),
        "f32_stereo": _wav(x.astype("<f4").tobytes(), 44100, 2, 32, 3),
    }


@pytest.mark.parametrize("name", [os.path.basename(c) for c in CLIPS]
                         + list(_synthetic_wavs()))
def test_wav_decode_matches_jax(name):
    if name.endswith(".wav"):
        with open(os.path.join(REAL, name), "rb") as f:
            data = f.read()
    else:
        data = _synthetic_wavs()[name]
    ref, ref_sr = jax_decode_audio(data)
    ours, sr = decode_audio(data)
    assert sr == ref_sr and ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_non_wav_containers_are_refused():
    """FLAC decodes now, so a corrupt FLAC stream raises the JAX package's
    error and message; MP3 and Ogg Vorbis decode too, so bytes
    that only start like them raise AudioDecodeError, as JAX's do."""
    corrupt = b"fLaC" + bytes(60)
    with pytest.raises(AudioDecodeError) as ours:
        decode_audio(corrupt)
    with pytest.raises(JaxDecodeError) as ref:
        jax_decode_audio(corrupt)
    assert not isinstance(ours.value, UnsupportedFormatError)
    assert type(ours.value).__name__ == type(ref.value).__name__
    assert str(ours.value) == str(ref.value)
    for data in (b"OggS" + bytes(60), b"ID3" + bytes(60),
                 b"\xff\xfb" + bytes(60)):
        with pytest.raises(AudioDecodeError):
            decode_audio(data)
        with pytest.raises(JaxDecodeError):
            jax_decode_audio(data)
    with pytest.raises(AudioDecodeError):
        decode_audio(b"definitely not any audio container")


@pytest.fixture(scope="module")
def tokenizers():
    path = os.path.join(CKPT, "tokenizer.json")
    return JaxTokenizer.from_file(path), BpeTokenizer.from_file(path)


def _texts():
    out = []
    for txt in sorted(glob.glob(os.path.join(REAL, "*.txt"))):
        with open(txt, encoding="utf-8") as f:
            out.append(f.read().strip())
    jt = JaxTemplate()
    for lang in (None, "English", "Chinese", "Cantonese"):
        out += list(jt.prompt_texts(lang, ""))
        out += list(jt.prompt_texts(lang, "Names: Zoë, O'Neil's 3 cats\n"))
    return out


def test_prompt_texts_match_jax():
    for lang in (None, "English", "Thai"):
        for ctx in ("", "context words"):
            assert (PromptTemplate().prompt_texts(lang, ctx)
                    == JaxTemplate().prompt_texts(lang, ctx))


@pytest.mark.parametrize("idx", range(len(_texts())))
def test_tokenizer_matches_jax_on_reference_texts(tokenizers, idx):
    jax_tok, tok = tokenizers
    text = _texts()[idx]
    ids = tok.encode(text)
    assert ids == jax_tok.encode(text)
    assert tok.decode(ids) == jax_tok.decode(ids)
    assert tok.decode(ids, skip_special=False) == jax_tok.decode(
        ids, skip_special=False)


# Mixed scripts, digits, punctuation, every kind of space and newline,
# contractions and case-folded ones, combining marks, emoji.
MIXED = st.lists(st.sampled_from(list(
    "abcXYZ sS'tlrevmdſ\t\n\r 0123456789٣!?.,-—…「」、。中文日本語テスト"
    "กขคภาษาไทยभारतहिन्दी한국어　\xa0é́ñ\x1c\x1f\u200bั\U0001F600"
    ) + ["<|im_end|>", "<|AUDIO|>", "'S", "'LL", "'Re"]),
    max_size=40).map("".join)


@settings(max_examples=300, deadline=None)
@given(MIXED)
def test_tokenizer_matches_jax_on_mixed_scripts(tokenizers, text):
    jax_tok, tok = tokenizers
    ids = tok.encode(text)
    assert ids == jax_tok.encode(text)
    assert tok.decode(ids) == jax_tok.decode(ids)


@settings(max_examples=300, deadline=None)
@given(MIXED)
def test_pre_tokenizer_matches_regex(text):
    assert pre_tokenize(text, QWEN) == regex.findall(_QWEN_PATTERN, text)
    assert pre_tokenize(text, GPT2) == regex.findall(_GPT2_PATTERN, text)
