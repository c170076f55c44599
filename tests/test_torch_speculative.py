"""The port's token-level speculative decoding (``runtime/speculative.py``
``SpecLoop``: predicated rounds, chunked, device-resident) against the JAX
package's ``speculative_generate`` (one ``lax.while_loop``) on the CPU, in
f32: a counterpart of each case of ``tests/test_speculative.py``, its
parametrizations included, each holding the port's tokens, lengths and
verifier rounds equal to JAX's on the same numpy weights and prompts, and
its tokens equal to JAX's verifier greedy. Then the engine: the draft
``e2e/data/trained_draft`` attached to ``trained_ckpt``, against the JAX
engine with the same draft and the port's plain greedy; an int8-weight,
fp8-cache pair on a head_dim-128 decoder; ``ASR_SPEC_GAMMA`` below 2; and
``attach_draft``'s two refusals.

On the CPU a ``Graph`` runs its function eagerly, so these tests run the
very functions and buffers the card captures and replays."""
import dataclasses
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models.config import DecoderConfig as JaxDecoderConfig
from qwen3_asr_tpu.models.decoder import init_decoder_params as jax_init_dec
from qwen3_asr_tpu.runtime.generate import greedy_generate as jax_greedy
from qwen3_asr_tpu.runtime.speculative import \
    speculative_generate as jax_spec
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.models.config import DecoderConfig
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.generate import greedy_generate
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
from qwen3_asr_tpu_torch.runtime.speculative import (rounds_per_chunk,
                                                     speculative_generate)

JAX_CFG = JaxDecoderConfig(
    vocab_size=128, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=8, tie_word_embeddings=True)
CFG = DecoderConfig(**{f: getattr(JAX_CFG, f)
                       for f in DecoderConfig.__dataclass_fields__})
EOS, PAD = 100, 101

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
DRAFT = os.path.join(ROOT, "trained_draft")
CLIPS = sorted(glob.glob(os.path.join(ROOT, "real", "*.wav")))


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_params(seed):
    """JAX's random decoder (``init_decoder_params``) as numpy: the weights
    both packages run."""
    return jax.device_get(jax_init_dec(JAX_CFG, jax.random.PRNGKey(seed)))


def _embeds(seed, b=1, t=10):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (b, t, JAX_CFG.hidden_size),
                                      jnp.float32))


def _both(draft_seed, verify_seed, emb_d, emb_v, vf, gamma, max_new=16):
    """(JAX's spec, JAX's verifier greedy, the port's spec) on the same
    weights and prompts."""
    draft, verify = _jax_params(draft_seed), _jax_params(verify_seed)
    jvf = jnp.asarray(vf, jnp.int32)
    ref = jax_spec(draft, verify, JAX_CFG, JAX_CFG, jnp.asarray(emb_d),
                   jnp.asarray(emb_v), jvf, jvf, gamma=gamma,
                   max_new=max_new, eos_id=EOS, pad_id=PAD,
                   cache_dtype=jnp.float32)
    greedy = jax_greedy(verify, JAX_CFG, jnp.asarray(emb_v), jvf,
                        max_new=max_new, eos_id=EOS, pad_id=PAD,
                        cache_dtype=jnp.float32)
    tvf = torch.from_numpy(np.asarray(vf, np.int32))
    ours = speculative_generate(
        params_from_jax(draft, "cpu"), params_from_jax(verify, "cpu"), CFG,
        CFG, torch.from_numpy(emb_d), torch.from_numpy(emb_v), tvf, tvf,
        gamma=gamma, max_new=max_new, eos_id=EOS, pad_id=PAD,
        cache_dtype=torch.float32)
    return ref, greedy, ours


def _rows(tokens):
    return [[t for t in row if t != PAD] for row in np.asarray(tokens)]


def _check(ref, greedy, ours):
    assert np.array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    assert np.array_equal(ours.lengths.numpy(), np.asarray(ref.lengths))
    assert ours.steps == int(ref.steps)
    assert _rows(ours.tokens) == _rows(greedy.tokens)


@pytest.mark.parametrize("gamma", [2, 4])
def test_self_draft_equals_greedy(gamma):
    emb = _embeds(1)
    ref, greedy, ours = _both(0, 0, emb, emb, [0], gamma)
    _check(ref, greedy, ours)
    assert ours.steps <= int(greedy.lengths[0]) // gamma + 2


@pytest.mark.parametrize("gamma", [2, 3, 4])
def test_bad_draft_still_equals_verifier_greedy(gamma):
    ref, greedy, ours = _both(42, 0, _embeds(2), _embeds(1), [0], gamma)
    _check(ref, greedy, ours)


def test_different_prompt_lengths():
    ref, greedy, ours = _both(7, 0, _embeds(2, t=9), _embeds(1, t=12), [0],
                              3)
    _check(ref, greedy, ours)


def test_max_new_respected():
    emb = _embeds(4)
    ref, greedy, ours = _both(3, 3, emb, emb, [0], 4, max_new=5)
    _check(ref, greedy, ours)
    assert tuple(ours.tokens.shape) == (1, 5)
    assert int(ours.lengths[0]) <= 5


def test_left_padded_prompts():
    ref, greedy, ours = _both(9, 0, _embeds(6, t=12), _embeds(5, t=12), [3],
                              3, max_new=12)
    _check(ref, greedy, ours)


@pytest.mark.parametrize("gamma", [2, 4])
def test_batched_spec_equals_greedy_per_row(gamma):
    """Rows accept different prefix lengths a round: per-row write
    positions and causal q_offsets keep each row its own greedy."""
    ref, greedy, ours = _both(42, 0, _embeds(2, b=4), _embeds(1, b=4),
                              [0, 2, 1, 3], gamma)
    _check(ref, greedy, ours)


def test_batched_spec_self_draft_round_count():
    emb = _embeds(6, b=3)
    ref, greedy, ours = _both(5, 5, emb, emb, [0, 0, 0], 4)
    _check(ref, greedy, ours)
    assert ours.steps <= int(np.max(np.asarray(greedy.lengths))) // 4 + 2


def test_rounds_per_chunk_bounds_tokens_per_chunk():
    """A chunk at full acceptance emits at most the greedy chunk's 8
    tokens a row: 2 rounds at the default γ = 4."""
    assert rounds_per_chunk(4) == 2
    assert [rounds_per_chunk(g) * g for g in (2, 3, 4, 8)] == [8, 6, 8, 8]
    assert rounds_per_chunk(9) == 1


# -- the engine's draft ------------------------------------------------------

def _jax_model(path):
    from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
    from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
    from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint
    from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
    cfg, params = load_asr_checkpoint(path, dtype=jnp.float32, cache=False)
    return JaxModel(cfg, params,
                    JaxTokenizer.from_file(os.path.join(path,
                                                        "tokenizer.json")),
                    JaxTemplate.from_checkpoint(path))


@pytest.fixture(scope="module")
def engines():
    """(JAX's engine with trained_draft attached, the port's with it, the
    port's plain engine): trained_ckpt in f32 on the CPU."""
    from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
    jax_eng = JaxEngine(_jax_model(CKPT), dtype=jnp.float32)
    jax_eng.attach_draft(_jax_model(DRAFT))
    spec = load_engine(CKPT, device="cpu")
    spec.attach_draft(load_engine(DRAFT, device="cpu").model)
    return jax_eng, spec, load_engine(CKPT, device="cpu")


def _clip(path):
    with open(path, "rb") as f:
        return decode_audio(f.read())


@pytest.mark.parametrize("clip", [os.path.basename(c) for c in CLIPS])
def test_engine_with_draft_matches_plain(engines, clip):
    """Attaching trained_draft changes no token: the port's spec ids are
    JAX's spec engine's and the port's own greedy's, through a spec key;
    the draft, trained on the same data, is accepted often."""
    jax_eng, spec, plain = engines
    audio, sr = _clip(os.path.join(ROOT, "real", clip))
    ref = jax_eng.transcribe(audio, sr, language="en")
    ours = spec.transcribe(audio, sr, language="en")
    run = spec.last_run
    greedy = plain.transcribe(audio, sr, language="en")
    assert [r.token_ids for r in ours] == [r.token_ids for r in ref]
    assert [r.token_ids for r in ours] == [r.token_ids for r in greedy]
    assert [r.text for r in ours] == [r.text for r in ref]
    assert run["spec"] and run["gamma"] == 4
    assert run["rounds"] >= 1
    assert 0.0 <= run["tokens_per_round"] <= 4.0


def test_engine_acceptance_on_the_trained_pair(engines):
    """Over the clips the draft's tokens are accepted well above a foreign
    draft's near-zero rate: fewer verifier rounds than tokens."""
    _, spec, _ = engines
    tokens = rounds = 0
    for path in CLIPS[:4]:
        spec.transcribe(*_clip(path), language="en")
        tokens += spec.last_run["generated"] - 1
        rounds += spec.last_run["rounds"]
    assert rounds < tokens


def test_engine_batched_spec_matches_plain(engines):
    """transcribe_batch with the draft attached (the micro-batcher's
    path): one spec key at B=3, rows at their own frontiers, ids equal to
    JAX's spec engine's and the plain engine's."""
    jax_eng, spec, plain = engines
    clips = [_clip(CLIPS[i]) for i in (2, 4, 8)]
    bucket = spec.bucket_frames(max(len(a) for a, _ in clips))
    audio = [a for a, _ in clips]
    _, ref = jax_eng._run_bucket(audio, *bucket, "en")
    _, ours = spec._run_bucket(audio, *bucket, "en")
    assert spec.last_run["batch"] == 3 and spec.last_run["spec"]
    _, greedy = plain._run_bucket(audio, *bucket, "en")
    assert ours == ref == greedy
    keys = [k for k in spec.executables if "spec" in k]
    assert (bucket[0], spec.last_run["max_new"], 3, torch.float32, "spec",
            4) in keys


def test_spec_gamma_below_two_takes_two(monkeypatch, caplog):
    monkeypatch.setenv("ASR_SPEC_GAMMA", "1")
    eng = load_engine(CKPT, device="cpu")
    eng.attach_draft(load_engine(DRAFT, device="cpu").model)
    audio, sr = _clip(CLIPS[3])
    with caplog.at_level("WARNING"):
        ours = eng.transcribe(audio, sr, language="en")
    assert "ASR_SPEC_GAMMA=1 below the minimum" in caplog.text
    assert eng.last_run["gamma"] == 2
    assert all(k[-2:] == ("spec", 2) for k in eng.executables)
    plain = load_engine(CKPT, device="cpu").transcribe(audio, sr,
                                                       language="en")
    assert ours[0].token_ids == plain[0].token_ids


def test_attach_draft_refusals():
    """A draft that chunks the audio differently (AssertionError) or
    tokenizes the prompt differently (ValueError) is refused, as JAX's."""
    from qwen3_asr_tpu_torch.models.asr import AsrModel
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    eng = load_engine(CKPT, device="cpu")
    draft = load_engine(DRAFT, device="cpu").model
    cfg = dataclasses.replace(draft.cfg, encoder=dataclasses.replace(
        draft.cfg.encoder, n_window=draft.cfg.encoder.n_window // 2))
    with pytest.raises(AssertionError, match="chunking"):
        eng.attach_draft(AsrModel(cfg, draft.params, draft.tokenizer,
                                  draft.template))
    foreign = AsrModel(draft.cfg, draft.params,
                       preset_tokenizer(draft.cfg.decoder.vocab_size))
    with pytest.raises(ValueError, match="prompt ids"):
        eng.attach_draft(foreign)
    assert eng.draft_model is None


def test_attach_draft_drops_earlier_spec_keys(engines):
    """A spec key never outlives the draft it captured."""
    eng = load_engine(CKPT, device="cpu")
    eng.attach_draft(load_engine(DRAFT, device="cpu").model)
    audio, sr = _clip(CLIPS[0])
    eng.transcribe(audio, sr, language="en")
    held = [k for k in eng.executables if "spec" in k]
    assert held and eng.executable_count == len(eng.executables)
    assert eng.held_bytes() > 0
    eng.attach_draft(load_engine(DRAFT, device="cpu").model)
    assert not [k for k in eng.executables if "spec" in k]


def _hd128_pair(mode="int8"):
    """(JAX verifier, JAX draft, the port's verifier, the port's draft):
    ``hd128_models()``'s head_dim-128 decoder as the verifier, the same
    model with decoder layers from another numpy seed as the draft, both
    quantized to ``mode``."""
    from qwen3_asr_tpu.ops import quant as jq
    from qwen3_asr_tpu_torch.ops import quant
    from tests.test_torch_engine import hd128_models
    jax_v, ours_v = hd128_models()
    jax_d, ours_d = hd128_models()
    rng = np.random.default_rng(1)
    layers = {k: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
              for k, x in jax.device_get(
                  jax_d.params["decoder"]["layers"]).items()}
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        layers[n] = 1.0 + layers[n] / 3
    jax_d.params = dict(jax_d.params, decoder=dict(
        jax_d.params["decoder"], layers=jax.tree.map(jnp.asarray, layers)))
    ours_d.params["decoder"]["layers"] = params_from_jax(
        {"layers": layers}, "cpu")["layers"]
    for m in (jax_v, jax_d):
        m.params = jq.quantize_params(m.params, mode)
    for m in (ours_v, ours_d):
        m.params = quant.quantize_params(m.params, mode)
    return jax_v, jax_d, ours_v, ours_d


def test_int8_fp8_cache_spec_engine_matches_jax(monkeypatch):
    """int8 weights and an fp8 KV cache in both models: the draft's steps
    on the batched kernel (its plain version here; the TPU kernel in
    interpret mode in JAX), the verify window over a widened layer, ids
    equal to JAX's spec engine and to the port's plain int8 engine."""
    from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    jax_v, jax_d, ours_v, ours_d = _hd128_pair()
    jax_eng = JaxEngine(jax_v, dtype=jnp.float32,
                        cache_dtype=jnp.float8_e4m3fn)
    jax_eng.attach_draft(jax_d)
    plain = TranscriptionEngine(ours_v, device="cpu",
                                cache_dtype=torch.float8_e4m3fn)
    eng = TranscriptionEngine(ours_v, device="cpu",
                              cache_dtype=torch.float8_e4m3fn)
    eng.attach_draft(ours_d)
    audio, sr = _clip(CLIPS[5])
    audio = audio[:int(1.5 * sr)]                  # the 2 s bucket
    ref = jax_eng.transcribe(audio, sr)[0]
    ours = eng.transcribe(audio, sr)[0]
    assert eng.last_run["spec"] and eng.last_run["rounds"] >= 1
    exe = next(e for k, e in eng.executables.items() if "spec" in k)
    assert exe.loop.cache_d.k.dtype == torch.float8_e4m3fn
    assert ours.token_ids == ref.token_ids
    assert ours.token_ids == plain.transcribe(audio, sr)[0].token_ids
    assert len(set(ours.token_ids)) >= 3
