"""The port's TranscriptionEngine against the JAX engine in f32 on the CPU,
on the in-repo trained checkpoint: token ids identical on every clip, on a
long-form clip split at silence, and batch equal to solo; and with an fp8
KV cache on a head_dim-128 decoder, against the JAX engine's TPU decode
kernel in interpret mode."""
import dataclasses
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
from qwen3_asr_tpu.models.decoder import init_decoder_params as jax_init_dec
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.models.asr import AsrModel, PromptTemplate
from qwen3_asr_tpu_torch.models.config import AsrConfig
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.engine import (MAX_SEGMENT_S, TARGET_SR,
                                                TranscriptionEngine)
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
from qwen3_asr_tpu_torch.text.tokenizer import BpeTokenizer

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


HD128 = dict(num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, head_dim=128)


def hd128_models():
    """trained_ckpt's encoder, embeddings and tokenizer with a random
    2-layer head_dim-128 decoder (seeded numpy weights at scale 0.3, so the
    tokens vary), as a JAX model and the port's."""
    jcfg, jparams = jax_load(CKPT, dtype=jnp.float32, cache=False)
    jcfg = dataclasses.replace(
        jcfg, decoder=dataclasses.replace(jcfg.decoder, **HD128))
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_init_dec(jcfg.decoder,
                                                 jax.random.PRNGKey(0)))
    layers = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
              for k, v in shapes["layers"].items()}
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        layers[n] = 1.0 + layers[n] / 3
    tree = jax.device_get(jparams)
    tree["decoder"] = dict(tree["decoder"], layers=layers)
    tok = os.path.join(CKPT, "tokenizer.json")
    jax_model = JaxModel(jcfg, jax.tree.map(jnp.asarray, tree),
                         JaxTokenizer.from_file(tok),
                         JaxTemplate.from_checkpoint(CKPT))
    cfg = AsrConfig.from_json(os.path.join(CKPT, "config.json"))
    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, **HD128))
    model = AsrModel(cfg, params_from_jax(tree, "cpu"),
                     BpeTokenizer.from_file(tok),
                     PromptTemplate.from_checkpoint(CKPT))
    return jax_model, model


def test_fp8_cache_engine_matches_jax_batched_kernel(monkeypatch):
    """Every decode step takes the batched kernel: its plain version here,
    the TPU kernel in interpret mode in JAX (B=1, then B=2 in one run)."""
    jax_model, model = hd128_models()
    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    jax_eng = JaxEngine(jax_model, dtype=jnp.float32,
                        cache_dtype=jnp.float8_e4m3fn)
    eng = TranscriptionEngine(model, device="cpu",
                              cache_dtype=torch.float8_e4m3fn)
    clips = [_clip(CLIPS[i]) for i in (5, 11)]
    clips = [(a[:int(1.5 * sr)], sr) for a, sr in clips]   # the 2 s bucket
    ref = jax_eng.transcribe(*clips[0])[0]
    ours = eng.transcribe(*clips[0])[0]
    assert ours.token_ids == ref.token_ids
    assert len(set(ours.token_ids)) >= 3
    bucket = eng.bucket_frames(len(clips[0][0]))
    assert bucket == jax_eng.bucket_frames(len(clips[0][0]))
    audio = [a for a, _ in clips]
    _, ref = jax_eng._run_bucket(audio, *bucket, None)
    _, ours = eng._run_bucket(audio, *bucket, None)
    assert eng.last_run["batch"] == 2
    assert ours == ref


@pytest.mark.parametrize("kv,error", [("fp8", ValueError),
                                      ("bf16", ValueError),
                                      ("int4", ValueError),
                                      ("int8", ValueError)])
def test_cache_dtypes_the_engine_refuses(monkeypatch, kv, error):
    """On trained_ckpt (head_dim 48, f32 on the CPU): fp8 and int4 need
    head_dim 128 and raise at construction; a bf16 cache is neither the
    working dtype nor fp8; int8 is no cache dtype."""
    monkeypatch.setenv("ASR_KV_CACHE_DTYPE", kv)
    with pytest.raises(error):
        load_engine(CKPT, device="cpu")


def test_kv_cache_dtype_from_env(monkeypatch):
    _, model = hd128_models()
    for kv, want in (("", torch.float32), ("fp8", torch.float8_e4m3fn)):
        monkeypatch.setenv("ASR_KV_CACHE_DTYPE", kv)
        from qwen3_asr_tpu_torch.runtime.lifecycle import (
            kv_cache_dtype_from_env)
        eng = TranscriptionEngine(model, device="cpu",
                                  cache_dtype=kv_cache_dtype_from_env())
        assert eng.cache_dtype == want


@pytest.mark.parametrize("env,cap", [(None, 8), ("8", 8), ("6", 4), ("3", 2),
                                     ("1", 1), ("0", 1), ("16", 16)])
def test_long_form_batch_from_env(monkeypatch, env, cap):
    """ASR_LONG_FORM_BATCH floored to a power of two, as the JAX engine
    reads it (``qwen3_asr_tpu/runtime/engine.py:780-781``); the long-form
    path runs batches of at most that many segments."""
    from qwen3_asr_tpu_torch.runtime import engine as engine_mod
    if env is None:
        monkeypatch.delenv("ASR_LONG_FORM_BATCH", raising=False)
    else:
        monkeypatch.setenv("ASR_LONG_FORM_BATCH", env)
    assert engine_mod.long_form_batch() == cap
    eng = TranscriptionEngine.__new__(TranscriptionEngine)
    sizes = []
    monkeypatch.setattr(eng, "bucket_frames", lambda n: (3000, 30.0),
                        raising=False)
    monkeypatch.setattr(
        eng, "_run_bucket", lambda clips, *a: (
            sizes.append(len(clips)) or ([""] * len(clips),
                                         [[]] * len(clips))), raising=False)
    segments = [(0, np.zeros(10, np.int16))] * 11
    eng._run_segments_batched(segments, None, "")
    assert max(sizes) <= cap and sum(sizes) >= 11
