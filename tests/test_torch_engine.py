"""The port's TranscriptionEngine against the JAX engine in f32 on the CPU,
on the in-repo trained checkpoint: token ids identical on every clip, on a
long-form clip split at silence, and batch equal to solo."""
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint as jax_load
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.runtime.engine import MAX_SEGMENT_S, TARGET_SR
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
CLIPS = sorted(glob.glob(os.path.join(ROOT, "real", "*.wav")))


def jax_engine(path: str = CKPT) -> JaxEngine:
    cfg, params = jax_load(path, dtype=jnp.float32, cache=False)
    model = JaxModel(cfg, params,
                     JaxTokenizer.from_file(os.path.join(path,
                                                         "tokenizer.json")),
                     JaxTemplate.from_checkpoint(path))
    return JaxEngine(model, dtype=jnp.float32)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    return jax_engine(), load_engine(CKPT, device="cpu")


def _clip(path):
    with open(path, "rb") as f:
        return decode_audio(f.read())


@pytest.mark.parametrize("clip", [os.path.basename(c) for c in CLIPS])
def test_token_ids_identical_to_jax(engines, clip):
    jax_eng, eng = engines
    audio, sr = _clip(os.path.join(ROOT, "real", clip))
    ref = jax_eng.transcribe(audio, sr)
    ours = eng.transcribe(audio, sr)
    assert len(ours) == len(ref) == 1
    assert ours[0].token_ids == ref[0].token_ids
    assert (ours[0].text, ours[0].language) == (ref[0].text, ref[0].language)
    with open(os.path.join(ROOT, "real", clip[:-4] + ".txt"),
              encoding="utf-8") as f:
        assert ours[0].text == f.read().strip()


def test_long_form_split_identical_to_jax(engines):
    jax_eng, eng = engines
    parts = [_clip(CLIPS[i])[0] for i in (0, 2, 5, 7)]   # ~41 s
    gap = np.zeros(TARGET_SR // 4, np.float32)
    audio = np.concatenate([x for p in parts for x in (p, gap)])
    assert len(audio) > MAX_SEGMENT_S * TARGET_SR
    ref = jax_eng.transcribe(audio, TARGET_SR, language="auto")
    ours = eng.transcribe(audio, TARGET_SR, language="auto")
    assert len(ours) == len(ref) >= 2
    for o, r in zip(ours, ref):
        assert (o.start_time, o.end_time) == (r.start_time, r.end_time)
        assert o.token_ids == r.token_ids
        assert (o.text, o.language) == (r.text, r.language)


def test_transcribe_batch_equals_solo(engines):
    _, eng = engines
    clips = [_clip(CLIPS[i]) for i in (2, 4, 8, 3)]   # two buckets
    batch = eng.transcribe_batch(clips)
    for (audio, sr), res in zip(clips, batch):
        solo = eng.transcribe(audio, sr)[0]
        assert res.token_ids == solo.token_ids
        assert (res.text, res.language, res.end_time) == (
            solo.text, solo.language, solo.end_time)


def test_explicit_language_matches_jax(engines):
    jax_eng, eng = engines
    audio, sr = _clip(CLIPS[4])
    ref = jax_eng.transcribe(audio, sr, language="English")[0]
    ours = eng.transcribe(audio, sr, language="English")[0]
    assert ours.token_ids == ref.token_ids and ours.language == "en"
