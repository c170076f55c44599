"""The port's checkpoint reader, encoder and decoder against the JAX
package, in f32 on the CPU. Model outputs agree to 1e-4 (the summation
order differs); decoder hidden states are compared only at positions at or
after ``valid_from``: left-padded rows see no key, and the flash path gives
them 0 where the JAX CPU path (XLA softmax over a uniform MASK_VALUE row)
gives the mean of v — those rows only feed keys that real rows mask out."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models import config as jcfg
from qwen3_asr_tpu.models.decoder import decoder_forward as jax_decoder_forward
from qwen3_asr_tpu.models.decoder import init_decoder_params as jax_init_dec
from qwen3_asr_tpu.models.decoder import init_kv_cache as jax_init_kv_cache
from qwen3_asr_tpu.models.decoder import lm_logits as jax_lm_logits
from qwen3_asr_tpu.models.encoder import encoder_forward as jax_encoder_forward
from qwen3_asr_tpu.models.encoder import init_encoder_params as jax_init_enc
from qwen3_asr_tpu.ops.attention import AttnSpec as JaxSpec
from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint as jax_load
from qwen3_asr_tpu.runtime.checkpoint import load_safetensors_dir as jax_read
from qwen3_asr_tpu_torch.models.config import (AsrConfig, AudioEncoderConfig,
                                               DecoderConfig, preset)
from qwen3_asr_tpu_torch.models.decoder import (decoder_forward,
                                                init_decoder_params,
                                                init_kv_cache, lm_logits)
from qwen3_asr_tpu_torch.models.encoder import (encoder_forward,
                                                init_encoder_params)
from qwen3_asr_tpu_torch.ops.attention import AttnSpec
from qwen3_asr_tpu_torch.runtime.checkpoint import (load_asr_checkpoint,
                                                    load_safetensors_dir,
                                                    params_from_jax)

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
TOL = 1e-4

# preset:tiny, and 2-layer configs at the full model's head dims
ENCODERS = {
    "tiny": preset("tiny").encoder,
    "hd64": AudioEncoderConfig(num_mel_bins=32, d_model=128, encoder_layers=2,
                               encoder_attention_heads=2, encoder_ffn_dim=256,
                               output_dim=256, downsample_hidden_size=16,
                               n_window=50, n_window_infer=200),
}
DECODERS = {
    "tiny": preset("tiny").decoder,
    "hd128": DecoderConfig(vocab_size=300, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           head_dim=128),
}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _to_jax_cfg(cfg):
    cls = getattr(jcfg, type(cfg).__name__)
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def _random_tree(shapes, rng):
    """Seeded numpy weights at scale 0.02; norm weights near 1."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _random_tree(v, rng)
            continue
        x = (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
        if "ln" in k and not k.endswith("_b") or "norm" in k:
            x += 1.0
        out[k] = x
    return out


def _shapes(fn, cfg):
    return jax.eval_shape(lambda: fn(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("ckpt", ["trained_ckpt", "trained_draft"])
def test_safetensors_reader_matches(ckpt):
    ref = jax_read(os.path.join(ROOT, ckpt))
    ours = load_safetensors_dir(os.path.join(ROOT, ckpt))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("ckpt", ["trained_ckpt", "trained_draft"])
def test_checkpoint_conversion_matches_params_from_jax(ckpt):
    path = os.path.join(ROOT, ckpt)
    cfg_j, params_j = jax_load(path, dtype=jnp.float32, cache=False)
    cfg, params = load_asr_checkpoint(path, "cpu")
    carried = params_from_jax(jax.device_get(params_j), "cpu")
    assert cfg == AsrConfig.from_json(os.path.join(path, "config.json"))

    def walk(a, b, c, where=""):
        assert sorted(a) == sorted(b) == sorted(c), where
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], c[k], f"{where}.{k}")
            else:
                assert torch.equal(b[k], c[k]), f"{where}.{k}"
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))

    walk(params_j, params, carried)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax(name):
    cfg = ENCODERS[name]
    rng = np.random.default_rng(11)
    tree = _random_tree(_shapes(jax_init_enc, _to_jax_cfg(cfg)), rng)
    chunk = cfg.n_window * 2
    mel = rng.standard_normal((2, cfg.num_mel_bins, 3 * chunk)).astype(
        np.float32)
    flens = np.asarray([3 * chunk, 2 * chunk - 37], np.int32)
    ref, ref_lens = jax_encoder_forward(
        jax.tree.map(jnp.asarray, tree), _to_jax_cfg(cfg), jnp.asarray(mel),
        jnp.asarray(flens))
    ours, lens = encoder_forward(params_from_jax(tree, "cpu"), cfg,
                                 torch.from_numpy(mel), torch.from_numpy(flens))
    assert lens.tolist() == np.asarray(ref_lens).tolist()
    ref = np.asarray(ref)
    for b, n in enumerate(lens.tolist()):   # tokens past the length: garbage
        np.testing.assert_allclose(ours[b, :n].numpy(), ref[b, :n],
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_prefill_and_decode_match_jax(name):
    cfg = DECODERS[name]
    jc = _to_jax_cfg(cfg)
    rng = np.random.default_rng(12)
    tree = _random_tree(_shapes(jax_init_dec, jc), rng)
    params = params_from_jax(tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    b, t, s = 2, 20, 128
    vf = np.asarray([0, 5], np.int32)
    embeds = rng.standard_normal((b, t + 3, cfg.hidden_size)).astype(np.float32)

    jcache = jax_init_kv_cache(jc, b, s, dtype=jnp.float32)
    cache = init_kv_cache(cfg, b, s, torch.float32, "cpu")
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    ref_h, jcache = jax_decoder_forward(
        jparams, jc, jnp.asarray(embeds[:, :t]), jnp.asarray(pos), jcache,
        jnp.int32(0), JaxSpec(causal=True, valid_from=jnp.asarray(vf)))
    h, cache = decoder_forward(
        params, cfg, torch.from_numpy(embeds[:, :t].copy()),
        torch.from_numpy(pos.astype(np.int64)), cache, 0,
        AttnSpec(causal=True, valid_from=torch.from_numpy(vf)))
    ref_h = np.asarray(ref_h)
    for row in range(b):
        np.testing.assert_allclose(h[row, vf[row]:].numpy(),
                                   ref_h[row, vf[row]:], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        lm_logits(params, cfg, h[:, -1]).numpy(),
        np.asarray(jax_lm_logits(jparams, jc, jnp.asarray(ref_h[:, -1]))),
        atol=TOL, rtol=TOL)

    for step in range(3):
        p = t + step
        x = embeds[:, p:p + 1].copy()
        vt = np.full((b,), p + 1, np.int32)
        ref_h, jcache = jax_decoder_forward(
            jparams, jc, jnp.asarray(x), jnp.full((b, 1), p, jnp.int32),
            jcache, jnp.int32(p),
            JaxSpec(valid_from=jnp.asarray(vf), valid_to=jnp.asarray(vt)))
        h, cache = decoder_forward(
            params, cfg, torch.from_numpy(x), torch.full((b, 1), p), cache, p,
            AttnSpec(valid_from=torch.from_numpy(vf),
                     valid_to=torch.from_numpy(vt)))
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(
            lm_logits(params, cfg, h[:, -1]).numpy(),
            np.asarray(jax_lm_logits(jparams, jc, ref_h[:, -1])),
            atol=TOL, rtol=TOL)


def test_init_params_have_the_jax_layout():
    cfg = preset("tiny")
    gen = torch.Generator().manual_seed(0)
    for ours, fn, sub in (
            (init_encoder_params(cfg.encoder, gen, "cpu"), jax_init_enc,
             cfg.encoder),
            (init_decoder_params(cfg.decoder, gen, "cpu"), jax_init_dec,
             cfg.decoder)):
        ref = _shapes(fn, _to_jax_cfg(sub))
        flat = jax.tree_util.tree_leaves_with_path(ref)
        for path, leaf in flat:
            node = ours
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == tuple(leaf.shape), path


# The tiny head_dim-128 config of tests/test_decode_attention_batch.py
ROUTED = DecoderConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=2,
                       num_key_value_heads=1, head_dim=128,
                       rms_norm_eps=1e-6, rope_theta=10000.0,
                       tie_word_embeddings=True)


def test_fp8_greedy_through_batched_kernel_matches_jax(monkeypatch):
    """greedy_generate with an fp8 cache at B=2: every decode step takes the
    batched kernel (its plain version here) in the port, and the TPU
    kernel in interpret mode in the JAX package. Seed 1 and weights at
    scale 0.3 make each row emit many distinct ids, so the match is not
    the trivial one of a row repeating one id or ending at once."""
    from qwen3_asr_tpu.runtime.generate import greedy_generate as jax_generate
    from qwen3_asr_tpu_torch.runtime.generate import greedy_generate
    jc = _to_jax_cfg(ROUTED)
    rng = np.random.default_rng(1)
    tree = {}
    for k, v in _shapes(jax_init_dec, jc).items():
        tree[k] = ({n: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
                    for n, x in v.items()} if isinstance(v, dict) else
                   (rng.standard_normal(v.shape) * 0.3).astype(np.float32))
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        tree["layers"][n] = 1.0 + tree["layers"][n] / 3
    tree["final_norm"] = 1.0 + tree["final_norm"] / 3
    embeds = rng.standard_normal((2, 12, ROUTED.hidden_size)).astype(
        np.float32)
    vf = np.asarray([0, 3], np.int32)
    max_new, eos, pad = 20, 1, 0

    monkeypatch.setenv("ASR_ATTN_BACKEND", "bstream_interpret")
    ref = jax_generate(jax.tree.map(jnp.asarray, tree), jc,
                       jnp.asarray(embeds), jnp.asarray(vf), max_new=max_new,
                       eos_id=eos, pad_id=pad, cache_dtype=jnp.float8_e4m3fn)
    ours = greedy_generate(params_from_jax(tree, "cpu"), ROUTED,
                           torch.from_numpy(embeds), torch.from_numpy(vf),
                           max_new=max_new, eos_id=eos, pad_id=pad,
                           cache_dtype=torch.float8_e4m3fn)
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    for row in ours.tokens.tolist():
        text = row[:row.index(eos)] if eos in row else row
        assert len(set(text) - {pad}) >= 3


def test_kv_cache_refuses_dtypes_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6"):
        init_kv_cache(ROUTED, 1, 128, torch.int8, "cpu")
    assert init_kv_cache(ROUTED, 1, 128, torch.float8_e4m3fn,
                         "cpu").k.dtype == torch.float8_e4m3fn
    # an f32 cache under bf16 activations is neither the working dtype
    # nor fp8 (the check comes before any weight is read)
    with pytest.raises(ValueError, match="neither"):
        decoder_forward({}, ROUTED,
                        torch.zeros((1, 1, 64), dtype=torch.bfloat16),
                        torch.zeros((1, 1), dtype=torch.int64),
                        init_kv_cache(ROUTED, 1, 128, torch.float32, "cpu"),
                        0, AttnSpec())
