"""Resume decoding in the port (``runtime/resume.py``, the engine's resume
keys) against the JAX package's ``runtime/resume.py`` on the CPU, in f32,
the same numpy inputs through both; and the per-row KV-cache write it
needs (``write_pos`` [B]) against JAX's per-row scatter.

Each case of ``tests/test_resume.py`` is a case here against the JAX
function: a draft that is the stream's own output, an empty draft, a
garbage draft and another stream's output; the three-tick streaming
scenario; batch rows against per-row greedy and against batch-1 resume;
the engine's resume against its plain run; batched ticks against solo.
Tokens and lengths are identical to JAX's, and so are the continuation
steps (JAX's ``steps``). On the CPU a ``Graph`` runs its function
eagerly, so these run the very functions the card captures.

The per-row write: ``decoder_forward`` with ``write_pos`` [B] (T = 1 and
T = 3, rows at distinct positions, one at the cache's last key) against
JAX's ``decoder_forward`` for f32, bf16, fp8 and int4 caches: the int4
cache's bytes equal, the others' K/V and the hidden rows within the
tolerances of ``CACHE_TOL`` and ``HIDDEN_TOL`` (the frameworks' products
round apart); and the write alone, the same K and V through the port's
plain per-row write and JAX's scatter: the cache's bytes equal for bf16,
fp8 and int4, T = 1 and T = 3."""
import dataclasses
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models import config as jcfg
from qwen3_asr_tpu.models import decoder as jdec
from qwen3_asr_tpu.models.decoder import init_decoder_params as jax_init_dec
from qwen3_asr_tpu.ops.attention import AttnSpec as JaxSpec
from qwen3_asr_tpu.runtime.generate import greedy_generate as jax_greedy
from qwen3_asr_tpu.runtime.resume import resume_generate as jax_resume
from qwen3_asr_tpu.runtime.resume import \
    resume_generate_batch as jax_resume_batch
from qwen3_asr_tpu_torch.models.config import DecoderConfig
from qwen3_asr_tpu_torch.models.decoder import decoder_forward, init_kv_cache
from qwen3_asr_tpu_torch.ops.attention import AttnSpec
from qwen3_asr_tpu_torch.ops.kv_int4 import unpack
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.resume import (resume_generate,
                                                resume_generate_batch,
                                                verify_and_continue)

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")

CFG = DecoderConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=8, rms_norm_eps=1e-6,
                    rope_theta=10000.0, tie_word_embeddings=True)
EOS, PAD = 100, 101
MAX_NEW = 12


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_cfg(cfg=CFG):
    cls = jcfg.DecoderConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def _tree(cfg, seed=1, scale=0.3):
    """Seeded numpy weights (norms near 1), so rows emit many ids."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_init_dec(_jax_cfg(cfg),
                                                 jax.random.PRNGKey(0)))
    out = {}
    for k, v in shapes.items():
        out[k] = ({n: (rng.standard_normal(x.shape) * scale)
                   .astype(np.float32) for n, x in v.items()}
                  if isinstance(v, dict) else
                  (rng.standard_normal(v.shape) * scale).astype(np.float32))
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        out["layers"][n] = 1.0 + out["layers"][n] / 3
    out["final_norm"] = 1.0 + out["final_norm"] / 3
    return out


@pytest.fixture(scope="module")
def tree():
    return _tree(CFG)


def _embeds(seed, t=10, b=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, CFG.hidden_size)).astype(np.float32)


def _jgreedy(tree, embeds):
    b = embeds.shape[0]
    return jax_greedy(jax.tree.map(jnp.asarray, tree), _jax_cfg(),
                      jnp.asarray(embeds), jnp.zeros((b,), jnp.int32),
                      max_new=MAX_NEW, eos_id=EOS, pad_id=PAD,
                      cache_dtype=jnp.float32)


def _jresume(tree, embeds, prev, prev_len):
    return jax_resume(jax.tree.map(jnp.asarray, tree), _jax_cfg(),
                      jnp.asarray(embeds), jnp.zeros((1,), jnp.int32),
                      jnp.asarray(prev, jnp.int32)[None, :],
                      jnp.asarray([prev_len], jnp.int32), max_new=MAX_NEW,
                      eos_id=EOS, pad_id=PAD, cache_dtype=jnp.float32)


def _jresume_batch(tree, embeds, prev, prev_len):
    b = embeds.shape[0]
    return jax_resume_batch(jax.tree.map(jnp.asarray, tree), _jax_cfg(),
                            jnp.asarray(embeds), jnp.zeros((b,), jnp.int32),
                            jnp.asarray(prev, jnp.int32),
                            jnp.asarray(prev_len, jnp.int32),
                            max_new=MAX_NEW, eos_id=EOS, pad_id=PAD,
                            cache_dtype=jnp.float32)


def _ours(tree, embeds, prev, prev_len, batch_fn=False):
    params = params_from_jax(tree, "cpu")
    b = embeds.shape[0]
    fn = resume_generate_batch if batch_fn else resume_generate
    return fn(params, CFG, torch.from_numpy(embeds),
              torch.zeros(b, dtype=torch.int32),
              torch.from_numpy(np.asarray(prev, np.int32).reshape(b, -1)),
              torch.from_numpy(np.asarray(prev_len, np.int32).reshape(b)),
              max_new=MAX_NEW, eos_id=EOS, pad_id=PAD)


def _strip(row):
    return [t for t in np.asarray(row).tolist() if t != PAD]


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(ours.steps.numpy().reshape(-1),
                                  np.asarray(ref.steps).reshape(-1))


def test_resume_with_own_output_matches_jax(tree):
    embeds = _embeds(1)
    ref = _jgreedy(tree, embeds)
    prev = np.asarray(ref.tokens)[0]
    n = int(ref.lengths[0])
    ours = _ours(tree, embeds, prev, n)
    _assert_same(ours, _jresume(tree, embeds, prev, n))
    assert _strip(ours.tokens[0]) == _strip(ref.tokens[0])
    assert len(set(_strip(ours.tokens[0]))) >= 3
    assert int(ours.steps[0]) <= 2          # only the continuation probe
    assert int(ours.accepted[0]) >= min(n, MAX_NEW - 1) - 1


@pytest.mark.parametrize("draft", ["empty", "garbage", "other_stream"])
def test_resume_drafts_match_jax(tree, draft):
    embeds = _embeds({"empty": 2, "garbage": 3, "other_stream": 5}[draft])
    if draft == "empty":
        prev, n = np.full(MAX_NEW, PAD, np.int32), 0
    elif draft == "garbage":
        prev = np.random.default_rng(0).integers(0, 99, MAX_NEW) \
            .astype(np.int32)
        n = MAX_NEW
    else:
        other = _jgreedy(tree, _embeds(4))
        prev, n = np.asarray(other.tokens)[0], int(other.lengths[0])
    ours = _ours(tree, embeds, prev, n)
    _assert_same(ours, _jresume(tree, embeds, prev, n))
    assert _strip(ours.tokens[0]) == _strip(_jgreedy(tree, embeds).tokens[0])


def test_resume_streaming_scenario_matches_jax(tree):
    """Three ticks, each reusing the last tick's tokens: every tick equals
    JAX's resume and from-scratch greedy."""
    prev, n = np.full(MAX_NEW, PAD, np.int32), 0
    for seed in (10, 11, 12):
        embeds = _embeds(seed, t=8 + seed % 3)
        ours = _ours(tree, embeds, prev, n)
        _assert_same(ours, _jresume(tree, embeds, prev, n))
        assert _strip(ours.tokens[0]) == _strip(
            _jgreedy(tree, embeds).tokens[0]), seed
        prev, n = ours.tokens[0].numpy(), int(ours.lengths[0])


def _batch_drafts(tree, refs):
    prev = np.full((4, MAX_NEW), PAD, np.int32)
    prev_len = np.zeros(4, np.int32)
    prev[0], prev_len[0] = np.asarray(refs[0].tokens)[0], int(
        refs[0].lengths[0])                                # own output
    prev[2] = np.random.default_rng(7).integers(0, 99, MAX_NEW)
    prev_len[2] = MAX_NEW                                  # garbage
    prev[3], prev_len[3] = prev[0], prev_len[0]            # other stream
    return prev, prev_len


def test_resume_batch_rows_match_jax_and_per_row_greedy(tree):
    embeds = np.concatenate([_embeds(s) for s in (21, 22, 23, 24)])
    refs = [_jgreedy(tree, embeds[i:i + 1]) for i in range(4)]
    prev, prev_len = _batch_drafts(tree, refs)
    ours = _ours(tree, embeds, prev, prev_len, batch_fn=True)
    _assert_same(ours, _jresume_batch(tree, embeds, prev, prev_len))
    for r in range(4):
        assert _strip(ours.tokens[r]) == _strip(refs[r].tokens[0]), r
    # the rows sit at different frontiers: some accept, some decode
    assert len(set(ours.accepted.tolist())) >= 2


def test_resume_batch_accepted_rows_take_few_steps(tree):
    embeds = np.concatenate([_embeds(s) for s in (31, 32)])
    refs = [_jgreedy(tree, embeds[i:i + 1]) for i in range(2)]
    prev = np.stack([np.asarray(r.tokens)[0] for r in refs])
    prev_len = np.asarray([int(r.lengths[0]) for r in refs], np.int32)
    ours = _ours(tree, embeds, prev, prev_len, batch_fn=True)
    _assert_same(ours, _jresume_batch(tree, embeds, prev, prev_len))
    assert max(ours.steps.tolist()) <= 2


def test_resume_batch_matches_batch1_resume(tree):
    embeds = _embeds(41)
    prev = np.asarray(_jgreedy(tree, _embeds(42)).tokens)[0]
    a = _ours(tree, embeds, prev, MAX_NEW)
    b = _ours(tree, embeds, prev, MAX_NEW, batch_fn=True)
    _assert_same(a, _jresume_batch(tree, embeds, prev[None],
                                   np.asarray([MAX_NEW], np.int32)))
    assert _strip(a.tokens[0]) == _strip(b.tokens[0])
    assert int(a.lengths[0]) == int(b.lengths[0])


def test_verify_and_continue_on_a_prefilled_cache(tree):
    """The verify-and-continue entry on a cache the caller prefilled gives
    resume_generate's tokens."""
    from qwen3_asr_tpu_torch.runtime.generate import GreedyLoop
    embeds = _embeds(51)
    prev = np.asarray(_jgreedy(tree, _embeds(52)).tokens)[0]
    params = params_from_jax(tree, "cpu")
    loop = GreedyLoop(params, CFG, 1, embeds.shape[1], MAX_NEW, eos_id=EOS,
                      pad_id=PAD, cache_dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        first = loop.prompt(torch.from_numpy(embeds))
    _, ours = verify_and_continue(
        params, CFG, loop.cache, embeds.shape[1], first,
        torch.zeros(1, dtype=torch.int32), torch.from_numpy(prev[None]),
        torch.tensor([MAX_NEW], dtype=torch.int32), max_new=MAX_NEW,
        eos_id=EOS, pad_id=PAD)
    _assert_same(ours, _jresume(tree, embeds, prev, MAX_NEW))


# -- the engine: resume keys and tick batches -----------------------------------

@pytest.fixture(scope="module")
def engines():
    from tests.test_torch_engine import jax_engine
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    return jax_engine(), load_engine(CKPT, device="cpu")


def _clips():
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    out = []
    for name in ("english_01.wav", "chinese_02.wav", "english_02.wav",
                 "japanese_01.wav"):
        with open(os.path.join(ROOT, "real", name), "rb") as f:
            audio, sr = decode_audio(f.read())
        out.append(audio[:int(1.8 * sr)])       # one 2 s bucket
    return out


def test_engine_resume_equals_plain_and_jax(engines):
    """resume_tokens (garbage, then the clip's own output) never changes
    the tokens, and matches the JAX engine's resume run."""
    jax_eng, eng = engines
    clip = _clips()[0]
    ref = eng.transcribe(clip, 16000, language="en")
    assert ref[0].token_ids == jax_eng.transcribe(clip, 16000,
                                                  language="en")[0].token_ids
    for draft in ([5, 9, 2, 7], ref[0].token_ids):
        out = eng.transcribe(clip, 16000, language="en", resume_tokens=draft)
        jout = jax_eng.transcribe(clip, 16000, language="en",
                                  resume_tokens=draft)
        assert out[0].token_ids == jout[0].token_ids == ref[0].token_ids
        assert out[0].text == ref[0].text
    assert eng.last_run["resume"] and eng.last_run["accepted"][0] >= 1
    bf = eng.last_run["bucket_frames"]
    assert (bf, eng.last_run["max_new"], 1, torch.float32,
            "resume") in eng.executables


def test_engine_batched_ticks_match_solo_and_jax(engines):
    """A tick batch (own draft, no draft, garbage, another stream's tokens;
    mixed languages per row) gives each row's solo tokens and the JAX
    engine's tick batch."""
    from qwen3_asr_tpu_torch.models.asr import normalize_language
    jax_eng, eng = engines
    clips = _clips()
    langs = ["en", "zh", "en", None]
    refs = [eng.transcribe(c, 16000, language=l)
            for c, l in zip(clips, langs)]
    rows = [refs[0][0].token_ids, None, [5, 9, 2, 7], refs[0][0].token_ids]
    codes = [normalize_language(l)[0] for l in langs]
    bucket = eng.bucket_frames(len(clips[0]))
    assert bucket == jax_eng.bucket_frames(len(clips[0]))
    texts, ids = eng._run_bucket(clips, *bucket, None, resume_rows=rows,
                                 language_rows=codes)
    jtexts, jids = jax_eng._run_bucket(clips, *bucket, None,
                                       resume_rows=rows, language_rows=codes)
    assert ids == jids == [r[0].token_ids for r in refs]
    assert texts == jtexts == [r[0].text for r in refs]
    assert eng.last_run["batch"] == 4 and eng.last_run["resume"]


# -- the per-row KV write -------------------------------------------------------

HD = 128
RCFG = DecoderConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=HD, rms_norm_eps=1e-6,
                     rope_theta=10000.0, tie_word_embeddings=True)
S_LEN = 128
# K/V and hidden rows against JAX: f32 within 2e-5 (tests/test_torch_model.py
# allows 1e-4); bf16 within 2e-2 relative plus 5e-2 (two layers of bf16
# products summed in different orders); an fp8 cache one e4m3 step (1/8
# relative) on K/V, and the hidden rows that read such a step within 1e-2
CACHE_TOL = {"f32": dict(rtol=2e-5, atol=2e-5),
             "bf16": dict(rtol=2e-2, atol=5e-2),
             "fp8": dict(rtol=0.125, atol=2 ** -9)}
HIDDEN_TOL = {"f32": dict(rtol=2e-5, atol=2e-5),
              "bf16": dict(rtol=2e-2, atol=5e-2),
              "fp8": dict(rtol=1e-2, atol=1e-2),
              "int4": dict(rtol=2e-5, atol=2e-5)}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16,
        "fp8": torch.float8_e4m3fn, "int4": torch.int4}
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16,
        "fp8": jnp.float8_e4m3fn, "int4": jnp.int4}


def _cache_bytes_t(cache):
    if cache.int4:
        return [unpack(cache.k).numpy(), unpack(cache.v).numpy(),
                cache.k_scale.view(torch.int16).numpy(),
                cache.v_scale.view(torch.int16).numpy()]
    return [x.view(torch.uint8 if x.dtype == torch.float8_e4m3fn
                   else (torch.int16 if x.dtype == torch.bfloat16
                         else torch.int32)).numpy()
            for x in (cache.k, cache.v)]


def _cache_bytes_j(cache):
    out = []
    for x in ([cache.k, cache.v, cache.k_scale, cache.v_scale]
              if cache.k.dtype == jnp.int4 else [cache.k, cache.v]):
        a = np.asarray(x.astype(jnp.int8) if x.dtype == jnp.int4 else x)
        view = {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
        out.append(a.view(view) if a.dtype != np.int8 else a)
    return out


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kv", ["f32", "bf16", "fp8", "int4"])
def test_per_row_write_matches_jax(kv, t):
    """Rows at positions 5, 40, S - t (the last key) and 17: the cache's
    bytes equal JAX's scatter, hidden rows within the model tolerance."""
    b = 4
    act = torch.bfloat16 if kv == "bf16" else torch.float32
    jact = jnp.bfloat16 if kv == "bf16" else jnp.float32
    tree = _tree(RCFG, seed=3, scale=0.1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, t, RCFG.hidden_size)).astype(np.float32)
    pos = np.asarray([5, 40, S_LEN - t, 17], np.int64)
    positions = pos[:, None] + np.arange(t)[None, :]
    vf = np.asarray([0, 3, 0, 2], np.int32)
    vt = (pos + t).astype(np.int32)
    # a prior prompt fills every row's first keys, so attention has keys
    prompt = rng.standard_normal((b, 20, RCFG.hidden_size)).astype(
        np.float32)

    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(jact), tree)
    jcache = jdec.init_kv_cache(_jax_cfg(RCFG), b, S_LEN, dtype=J_DT[kv])
    _, jcache = jdec.decoder_forward(
        jtree, _jax_cfg(RCFG), jnp.asarray(prompt).astype(jact),
        jnp.broadcast_to(jnp.arange(20), (b, 20)), jcache, jnp.int32(0),
        JaxSpec(causal=True, valid_from=jnp.asarray(vf)))
    spec_j = JaxSpec(causal=t > 1, q_offset=jnp.asarray(pos, jnp.int32),
                     valid_from=jnp.asarray(vf), valid_to=jnp.asarray(vt))
    jh, jcache = jdec.decoder_forward(
        jtree, _jax_cfg(RCFG), jnp.asarray(x).astype(jact),
        jnp.asarray(positions, jnp.int32), jcache,
        jnp.asarray(pos, jnp.int32), spec_j)

    params = _cast(params_from_jax(tree, "cpu"), act)
    cache = init_kv_cache(RCFG, b, S_LEN, T_DT[kv], "cpu")
    with torch.inference_mode():
        decoder_forward(params, RCFG, torch.from_numpy(prompt).to(act),
                        torch.arange(20).expand(b, 20), cache, 0,
                        AttnSpec(causal=True,
                                 valid_from=torch.from_numpy(vf)))
        spec = AttnSpec(causal=t > 1,
                        q_offset=torch.from_numpy(pos.astype(np.int32)),
                        valid_from=torch.from_numpy(vf),
                        valid_to=torch.from_numpy(vt))
        h, _ = decoder_forward(params, RCFG, torch.from_numpy(x).to(act),
                               torch.from_numpy(positions), cache,
                               torch.from_numpy(pos), spec)
    # the keys written: the prompt's from valid_from (below it are pad
    # rows, whose attention sees no key: JAX's CPU route gives them the
    # mean of v, the port 0, ROADMAP §3) and each row's new ones (an int4
    # cache's unwritten zeros unpack to -8 in the port, 0 in JAX)
    keys = np.arange(S_LEN)
    live = [((keys >= vf[r]) & (keys < 20))
            | ((keys >= pos[r]) & (keys < pos[r] + t)) for r in range(b)]
    if kv == "int4":
        pairs = list(zip(_cache_bytes_t(cache), _cache_bytes_j(jcache)))
    else:
        pairs = [(cache.k.float().numpy(),
                  np.asarray(jcache.k.astype(jnp.float32))),
                 (cache.v.float().numpy(),
                  np.asarray(jcache.v.astype(jnp.float32)))]
    for ours, ref in pairs:
        for r in range(b):
            got, want = ours[:, r, :, live[r]], ref[:, r, :, live[r]]
            if kv == "int4":
                np.testing.assert_array_equal(got, want)
            else:
                # the two frameworks' products sum in different orders, so
                # K and V may round a step of the cache's dtype apart; the
                # placement itself is byte-exact (the test below)
                np.testing.assert_allclose(got, want, **CACHE_TOL[kv])
    ref_h = np.asarray(jh.astype(jnp.float32))
    np.testing.assert_allclose(h.float().numpy(), ref_h, **HIDDEN_TOL[kv])


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kv", ["bf16", "fp8", "int4"])
def test_per_row_write_bytes_match_jax_scatter(kv, t):
    """The same K and V through the port's plain per-row write and JAX's
    (``astype`` or ``_kv_quantize``, then the scatter of
    ``qwen3_asr_tpu/models/decoder.py:249-257``): the cache's bytes are
    equal, pads included."""
    from qwen3_asr_tpu_torch.ops.kv_int4 import kv_int4_write_plain, write_kv
    b, nkv, layers, layer = 4, 2, 3, 1
    rng = np.random.default_rng(7 + t)
    k = (rng.standard_normal((b, nkv, t, HD)) * 3).astype(np.float32)
    v = (rng.standard_normal((b, nkv, t, HD)) * 3).astype(np.float32)
    pos = np.asarray([5, 40, S_LEN - t, 17], np.int64)
    cache = init_kv_cache(dataclasses.replace(RCFG, num_hidden_layers=layers,
                                              num_key_value_heads=nkv),
                          b, S_LEN, T_DT[kv], "cpu")
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if kv == "bf16":
        kt, vt = kt.bfloat16(), vt.bfloat16()
    wp = torch.from_numpy(pos)
    if kv == "int4":
        kv_int4_write_plain(cache, layer, kt, vt, wp)
    else:
        write_kv(cache.k[layer], kt, wp)
        write_kv(cache.v[layer], vt, wp)

    rows = jnp.arange(b)[:, None]
    offs = jnp.asarray(pos)[:, None] + jnp.arange(t)[None, :]
    shape = (layers, b, nkv, S_LEN, HD)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if kv == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    if kv == "int4":
        (kq, ks), (vq, vs) = jdec._kv_quantize(jk), jdec._kv_quantize(jv)
        writes = [(jnp.zeros(shape, jnp.int4), kq),
                  (jnp.zeros(shape, jnp.int4), vq),
                  (jnp.zeros(shape[:-1] + (1,), jnp.bfloat16), ks),
                  (jnp.zeros(shape[:-1] + (1,), jnp.bfloat16), vs)]
    else:
        writes = [(jnp.zeros(shape, J_DT[kv]), jk.astype(J_DT[kv])),
                  (jnp.zeros(shape, J_DT[kv]), jv.astype(J_DT[kv]))]
    ref = [dst.at[layer, rows, :, offs].set(val.transpose(0, 2, 1, 3))
           for dst, val in writes]
    got = _cache_bytes_t(cache)
    if kv == "int4":
        # the port's unwritten packed zeros read -8: compare written keys
        # and all-zero scales elsewhere
        written = np.zeros(shape[:-1], bool)
        for r in range(b):
            written[layer, r, :, pos[r]:pos[r] + t] = True
        for ours, want in zip(got[:2], ref[:2]):
            want = np.asarray(want.astype(jnp.int8))
            np.testing.assert_array_equal(ours[written], want[written])
        for ours, want in zip(got[2:], ref[2:]):
            np.testing.assert_array_equal(
                ours, np.asarray(want).view(np.int16))
    else:
        for ours, want in zip(got, _cache_bytes_j(
                types.SimpleNamespace(k=ref[0], v=ref[1]))):
            np.testing.assert_array_equal(ours, want)


def _cast(params, dtype):
    if isinstance(params, dict):
        return {k: _cast(v, dtype) for k, v in params.items()}
    return params.to(dtype)


def test_per_row_write_drops_keys_past_the_cache():
    """A row whose keys run past S writes the ones inside and drops the
    rest (JAX's scatter drops them too); the other rows are untouched."""
    from qwen3_asr_tpu_torch.ops.kv_int4 import write_kv
    layer = torch.zeros(3, 2, 8, 4)
    new = torch.arange(3 * 2 * 3 * 4, dtype=torch.float32).reshape(3, 2, 3, 4)
    write_kv(layer, new, torch.tensor([6, 0, 9]))
    ref = jnp.zeros((3, 2, 8, 4)).at[
        jnp.arange(3)[:, None], :,
        jnp.asarray([6, 0, 9])[:, None] + jnp.arange(3)[None, :]].set(
            jnp.asarray(new.numpy()).transpose(0, 2, 1, 3))
    np.testing.assert_array_equal(layer.numpy(), np.asarray(ref))
    assert layer[2].abs().sum() == 0 and layer[0, :, 6:].abs().sum() > 0
