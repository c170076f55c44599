"""The port's chunked, predicated greedy loop against the JAX package's
``greedy_generate`` (one ``lax.while_loop``) on the CPU, in f32: identical
``tokens``, ``lengths`` and ``steps`` at chunk-boundary edges, rows that end
at different steps, a first token that ends every row, a cache filled to
its last slot, the batched decode route with an fp8 and a bf16 cache, and
requests that reuse one engine key. Then the warmup: the port's
``_warmup_buckets`` on the cases of ``tests/test_warmup_buckets.py``, and
the keys ``warmup`` and ``ModelManager.start`` build.

On the CPU a ``Graph`` runs its function eagerly, so these tests run the
very functions and buffers the card captures and replays."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models import config as jcfg
from qwen3_asr_tpu.models.decoder import init_decoder_params as jax_init_dec
from qwen3_asr_tpu.runtime.generate import greedy_generate as jax_generate
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.models.config import DecoderConfig
from qwen3_asr_tpu_torch.ops.attention import decode_kernel
from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
    decode_attention_batched)
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.engine import (AUDIO_BUCKETS_S,
                                                max_new_tokens_for)
from qwen3_asr_tpu_torch.runtime.generate import (DECODE_CHUNK,
                                                  greedy_generate)
from qwen3_asr_tpu_torch.runtime.lifecycle import (ModelManager,
                                                   _warmup_buckets,
                                                   load_engine)

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
NEVER = -1      # an eos id no argmax emits

# head_dim 128, so B >= 2 with a bf16 or fp8 cache takes the batched kernel
CFG = DecoderConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=2,
                    num_key_value_heads=1, head_dim=128, rms_norm_eps=1e-6,
                    rope_theta=10000.0, tie_word_embeddings=True)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy weights at scale 0.3 (norms near 1): rows emit many
    distinct ids, so a match is not the trivial one of a row repeating one
    id or ending at once."""
    jc = _jax_cfg()
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: jax_init_dec(jc, jax.random.PRNGKey(0)))
    out = {}
    for k, v in shapes.items():
        out[k] = ({n: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
                   for n, x in v.items()} if isinstance(v, dict) else
                  (rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        out["layers"][n] = 1.0 + out["layers"][n] / 3
    out["final_norm"] = 1.0 + out["final_norm"] / 3
    return out


def _jax_cfg():
    cls = jcfg.DecoderConfig
    return cls(**{f: getattr(CFG, f) for f in cls.__dataclass_fields__})


def _prompt(b, prompt_len, seed=2):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, prompt_len, CFG.hidden_size)).astype(
        np.float32)
    vf = (np.arange(b) * 3 % max(1, prompt_len - 1)).astype(np.int32)
    return embeds, vf


def _jax(tree, embeds, vf, *, max_new, eos, pad, cache_dtype=jnp.float32):
    return jax_generate(jax.tree.map(jnp.asarray, tree), _jax_cfg(),
                        jnp.asarray(embeds), jnp.asarray(vf),
                        max_new=max_new, eos_id=eos, pad_id=pad,
                        cache_dtype=cache_dtype)


def _ours(tree, embeds, vf, *, max_new, eos, pad, dtype=torch.float32,
          cache_dtype=None):
    params = _cast(params_from_jax(tree, "cpu"), dtype)
    return greedy_generate(params, CFG, torch.from_numpy(embeds).to(dtype),
                           torch.from_numpy(vf), max_new=max_new, eos_id=eos,
                           pad_id=pad, cache_dtype=cache_dtype)


def _cast(params, dtype):
    if isinstance(params, dict):
        return {k: _cast(v, dtype) for k, v in params.items()}
    return params.to(dtype)


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert ours.steps == int(ref.steps)
    # whole chunks, at most DECODE_CHUNK - 1 steps past the last live one
    live = ours.steps - 1
    assert ours.steps_run % DECODE_CHUNK == 0
    assert live <= ours.steps_run <= live + DECODE_CHUNK - 1


@pytest.mark.parametrize("max_new", [3, 8, 13, 20],
                         ids=["below_chunk", "one_chunk_plus_1",
                              "not_a_multiple", "two_chunks_plus_4"])
def test_budget_edges_match_jax(tree, max_new):
    """No row ends early: the loop runs to the budget, whose last step
    falls inside a chunk (or right after the prefill's token)."""
    embeds, vf = _prompt(2, 10)
    ref = _jax(tree, embeds, vf, max_new=max_new, eos=NEVER, pad=NEVER)
    ours = _ours(tree, embeds, vf, max_new=max_new, eos=NEVER, pad=NEVER)
    _assert_same(ours, ref)
    assert ours.steps == max_new


def test_rows_ending_at_different_steps_match_jax(tree):
    """EOS is an id row 0 first emits at step 5 or later and row 1 later
    or never, so one row is done (and feeds pad, an id neither row emits,
    back in) while the other decodes on."""
    embeds, vf = _prompt(2, 10)
    free = _jax(tree, embeds, vf, max_new=24, eos=NEVER, pad=NEVER)
    rows = np.asarray(free.tokens).tolist()
    eos = next(t for t in rows[0][5:]
               if t not in rows[0][:rows[0].index(t)]
               and (t not in rows[1] or rows[1].index(t) > rows[0].index(t)))
    pad = min(set(range(CFG.vocab_size)) - set(rows[0]) - set(rows[1]))
    ref = _jax(tree, embeds, vf, max_new=24, eos=eos, pad=pad)
    ours = _ours(tree, embeds, vf, max_new=24, eos=eos, pad=pad)
    _assert_same(ours, ref)
    lengths = ours.lengths.tolist()
    assert lengths[0] < lengths[1] and len(set(rows[0][:lengths[0]])) >= 3


def test_first_token_ending_every_row_matches_jax(tree):
    """Each row's first token is EOS or pad: steps == 1 and no chunk runs."""
    embeds, vf = _prompt(2, 10)
    free = _jax(tree, embeds, vf, max_new=12, eos=NEVER, pad=NEVER)
    first = np.asarray(free.tokens)[:, 0].tolist()
    ref = _jax(tree, embeds, vf, max_new=12, eos=first[0], pad=first[1])
    ours = _ours(tree, embeds, vf, max_new=12, eos=first[0], pad=first[1])
    _assert_same(ours, ref)
    assert ours.steps == 1 and ours.steps_run == 0


def test_cache_filled_to_its_last_slot_matches_jax(tree):
    """prompt_len + max_new == 128: the cache is exactly that long, and the
    last live step writes its final slot."""
    embeds, vf = _prompt(2, 11)
    ref = _jax(tree, embeds, vf, max_new=117, eos=NEVER, pad=NEVER)
    ours = _ours(tree, embeds, vf, max_new=117, eos=NEVER, pad=NEVER)
    _assert_same(ours, ref)
    assert ours.steps == 117 and ours.steps_run == 120


@pytest.mark.parametrize("kv", ["fp8", "bf16"])
def test_batched_route_matches_jax(tree, monkeypatch, kv):
    """B=2 with an fp8 cache (f32 activations) or in bf16 throughout: every
    decode step takes the batched kernel, its plain version here, and the
    TPU kernel in interpret mode in the JAX package."""
    if kv == "fp8":
        dtype, cache, jcache = (torch.float32, torch.float8_e4m3fn,
                                jnp.float8_e4m3fn)
    else:
        dtype, cache, jcache = torch.bfloat16, None, jnp.bfloat16
    assert decode_kernel(2, CFG.head_dim, 128,
                         cache or dtype) == "batched"
    embeds, vf = _prompt(2, 12, seed=3)
    jtree = (tree if dtype == torch.float32 else
             jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree))
    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    ref = _jax(jtree, embeds.astype(jnp.bfloat16) if kv == "bf16" else
               embeds, vf, max_new=21, eos=1, pad=0, cache_dtype=jcache)
    before = decode_attention_batched.launches
    ours = _ours(tree, embeds, vf, max_new=21, eos=1, pad=0, dtype=dtype,
                 cache_dtype=cache)
    _assert_same(ours, ref)
    assert decode_attention_batched.launches == before   # plain, on the CPU
    for row in ours.tokens.tolist():
        text = row[:row.index(1)] if 1 in row else row
        assert len(set(text) - {0}) >= 3


@pytest.fixture(scope="module")
def engine():
    return load_engine(CKPT, device="cpu")


def _clip(name, seconds):
    with open(os.path.join(ROOT, "real", name), "rb") as f:
        audio, sr = decode_audio(f.read())
    return audio[:int(seconds * sr)]


def test_one_key_reused_gives_two_fresh_runs(engine):
    """Two requests in a row on one key (the second shorter, so the first
    leaves cache rows and tokens past its end) give the tokens of two
    fresh engines; the key is built once."""
    a, b = _clip("english_01.wav", 3.5), _clip("chinese_02.wav", 3.5)
    bucket = engine.bucket_frames(len(a))
    assert bucket == engine.bucket_frames(len(b))
    engine.executables.clear()
    runs = [engine._run_bucket([x], *bucket, None)[1][0] for x in (a, b)]
    assert len(engine.executables) == 1
    fresh = [load_engine(CKPT, device="cpu")._run_bucket([x], *bucket,
                                                         None)[1][0]
             for x in (a, b)]
    assert runs == fresh and runs[0] != runs[1]
    assert engine.last_run["steps_run"] % DECODE_CHUNK == 0
    assert engine.last_run["replays"] == 0          # nothing captured
    assert engine.last_run["capture_s"] == 0.0      # its key was built


@pytest.fixture
def _clean_env(monkeypatch):
    for var in ("USE_CUDA_GRAPHS", "ASR_WARMUP_BUCKETS", "WS_WINDOW_MAX_S",
                "WS_FLUSH_SILENCE_MS", "ASR_WARMUP_BATCH_SHAPES",
                "SKIP_WARMUP", "ASR_WS_TICK_MAX_BATCH", "ASR_WS_STREAM_MODE",
                "ASR_WS_PREFIX_CACHE", "ASR_WS_TICK_BATCH",
                "ASR_WS_GROUP_MIN_CAP_S", "ASR_WS_TICK_MIN_SESSIONS"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# (environment, buckets): the cases of tests/test_warmup_buckets.py
WARMUP_CASES = {
    "default_covers_ws_ladder_at_6s_cap": ({}, (1, 2, 4, 6, 10)),
    "default_follows_configured_cap": ({"WS_WINDOW_MAX_S": "2.0"},
                                       (1, 2, 4)),
    "no_flush_pad_closes_at_the_cap": (
        {"WS_WINDOW_MAX_S": "10.0", "WS_FLUSH_SILENCE_MS": "0"},
        (1, 2, 4, 6, 10)),
    "flush_pad_growth_rounds_up": (
        {"WS_WINDOW_MAX_S": "10.0", "WS_FLUSH_SILENCE_MS": "600"},
        (1, 2, 4, 6, 10, 15)),
    "use_cuda_graphs_sweeps_all": ({"USE_CUDA_GRAPHS": "true"},
                                   AUDIO_BUCKETS_S),
    "explicit_list_override": ({"ASR_WARMUP_BUCKETS": "1,2"}, (1, 2)),
    "unknown_entries_fall_back_small": ({"ASR_WARMUP_BUCKETS": "3,7"},
                                        (1, 2)),
    # the JAX package raises on these mid-load (ADVICE.md); the port drops
    # them as it drops unknown buckets
    "malformed_entry_dropped": ({"ASR_WARMUP_BUCKETS": "1s,2"}, (2,)),
    "only_malformed_fall_back_small": ({"ASR_WARMUP_BUCKETS": "ten"},
                                       (1, 2)),
    "cap_beyond_ladder_clamps": ({"WS_WINDOW_MAX_S": "60.0"},
                                 (1, 2, 4, 6, 10, 15, 20, 30)),
}


@pytest.mark.parametrize("case", list(WARMUP_CASES))
def test_warmup_buckets(_clean_env, case):
    env, want = WARMUP_CASES[case]
    for k, v in env.items():
        _clean_env.setenv(k, v)
    assert _warmup_buckets() == want


def _ws_keys(eng, buckets, ticks=(2, 4, 8)):
    """The keys the WS part of the warmup adds at the default cap (6 s,
    modes solo and tick): each bucket's resume key at B=1, the batched
    resume keys of the buckets at or below the cap, and the plain keys of
    the flush bucket (6.6 s, so 10 s) at the tick batches."""
    keys = set()
    for sec in buckets:
        bf, bs = eng.bucket_frames(int(16000 * sec))
        key = (bf, max_new_tokens_for(bs))
        keys |= {key + (b, torch.float32, "resume") for b in (1,) + ticks}
    bf, bs = eng.bucket_frames(int(16000 * 6.6))
    keys |= {(bf, max_new_tokens_for(bs), b, torch.float32) for b in ticks}
    return keys


def test_warmup_builds_the_listed_keys(_clean_env):
    _clean_env.setenv("ASR_WARMUP_BATCH_SHAPES", "2")
    eng = load_engine(CKPT, device="cpu")
    eng.warmup((1, 2))
    keys = set()
    for sec in (1, 2):
        bf, bs = eng.bucket_frames(int(16000 * sec))
        keys |= {(bf, max_new_tokens_for(bs), b, torch.float32)
                 for b in (1, 2)}
    assert len(keys) == 4
    keys |= _ws_keys(eng, (1, 2))
    assert set(eng.executables) == keys and len(keys) == 4 + 8 + 3


@pytest.mark.parametrize("skip", [False, True], ids=["warms", "skips"])
def test_manager_start_warms_unless_skipped(_clean_env, skip):
    _clean_env.setenv("ASR_WARMUP_BUCKETS", "1")
    if skip:
        _clean_env.setenv("SKIP_WARMUP", "true")
    eng = load_engine(CKPT, device="cpu")
    mgr = ModelManager(eng)
    mgr.start()
    try:
        bf, bs = eng.bucket_frames(16000)
        want = set() if skip else ({(bf, max_new_tokens_for(bs), 1,
                                     torch.float32)} | _ws_keys(eng, (1,)))
        assert set(eng.executables) == want
    finally:
        mgr.stop()
