"""The port's analytic roofline model (``runtime/roofline.py``) against the
JAX package's: every field of ``RooflineCost`` equal on the tiny checkpoint
and on preset:1.7b's config (shapes only: meta tensors on the port's side,
``jax.eval_shape`` trees on JAX's), at bf16, int8 weights with an int4 KV
cache, and int4 weights, at B = 1, 4 and 8 for the 10/15/30 s buckets; and
the properties ``tests/test_roofline.py`` pins on the JAX model."""
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
from qwen3_asr_tpu.models.config import preset as jax_preset
from qwen3_asr_tpu.models.decoder import init_decoder_params as jax_init_dec
from qwen3_asr_tpu.models.encoder import init_encoder_params as jax_init_enc
from qwen3_asr_tpu.ops.quant import quantize_params as jax_quantize
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.runtime.roofline import analytic_cost as jax_cost
from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
from qwen3_asr_tpu.text.tokenizer import bytes_to_unicode as jax_b2u
from qwen3_asr_tpu_torch.models.asr import AsrModel
from qwen3_asr_tpu_torch.models.config import preset
from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
from qwen3_asr_tpu_torch.models.encoder import init_encoder_params
from qwen3_asr_tpu_torch.ops.quant import quantize_params
from qwen3_asr_tpu_torch.runtime.engine import (TranscriptionEngine,
                                                max_new_tokens_for)
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine, preset_tokenizer
from qwen3_asr_tpu_torch.runtime.roofline import (H100_BF16_DENSE_FLOPS,
                                                  H100_HBM_BYTES_PER_S,
                                                  RooflineCost, _tree_bytes,
                                                  analytic_cost, utilization)

from tests.fixtures import load_tiny_model, write_tiny_checkpoint

# (QUANTIZE, KV cache): port dtype, JAX dtype
CONFIGS = {
    "bf16": ("", None, None),
    "int8_kv4": ("int8", torch.int4, jnp.int4),
    "int4": ("int4", None, None),
}
SHAPES = [(b, s) for b in (1, 4, 8) for s in (10, 15, 30)]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("roofline_ckpt"))
    write_tiny_checkpoint(path)
    return path


def tiny_pair(ckpt, mode, monkeypatch):
    """The tiny checkpoint in both packages, quantized as ``mode`` says."""
    quant = CONFIGS[mode][0]
    monkeypatch.setenv("QUANTIZE", quant)
    model = load_tiny_model(ckpt)
    if quant:
        model.params = jax_quantize(model.params, quant)
    # an int4 KV cache needs head_dim 128, which the tiny checkpoint lacks:
    # its pair keeps the f32 cache (preset:1.7b's pairs hold the int4 one)
    theirs = JaxEngine(model, dtype=jnp.float32)
    ours = load_engine(ckpt, device="cpu")
    return ours, theirs


def preset_pair(mode):
    """preset:1.7b's config in both packages, weights as shapes only."""
    quant, kv, jax_kv = CONFIGS[mode]
    cfg = preset("1.7b")
    meta = torch.device("meta")
    params = {
        "encoder": init_encoder_params(cfg.encoder, None, meta,
                                       torch.bfloat16),
        "decoder": init_decoder_params(cfg.decoder, None, meta,
                                       torch.bfloat16)}
    if quant:
        params = quantize_params(params, quant)
    model = AsrModel(cfg, params, preset_tokenizer(cfg.decoder.vocab_size))
    ours = TranscriptionEngine(model, device="cpu", dtype=torch.bfloat16,
                               cache_dtype=kv)

    jcfg = jax_preset("1.7b")
    key = jax.random.PRNGKey(0)

    def init():
        p = {"encoder": jax_init_enc(jcfg.encoder, key, jnp.bfloat16),
             "decoder": jax_init_dec(jcfg.decoder, key, jnp.bfloat16)}
        return jax_quantize(p, quant) if quant else p

    jparams = jax.eval_shape(init)
    base = 151640
    specials = {t: base + i for i, t in enumerate(
        ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|AUDIO|>",
         "<|audio_bos|>", "<|audio_eos|>"])}
    byte_vocab = {c: i for i, c in enumerate(jax_b2u().values())}
    jmodel = JaxModel(jcfg, jparams, JaxTokenizer(byte_vocab, [], specials))
    theirs = JaxEngine(jmodel, dtype=jnp.bfloat16, cache_dtype=jax_kv)
    return ours, theirs


def assert_equal_costs(ours, theirs):
    for b, s in SHAPES:
        frames, bucket_s = ours.bucket_frames(int(s * 16000) - 160)
        assert (frames, bucket_s) == theirs.bucket_frames(
            int(s * 16000) - 160)
        got = analytic_cost(ours, b, frames, bucket_s)
        want = jax_cost(theirs, b, frames, bucket_s)
        assert got.flops == want.flops, (b, s)
        assert got.hbm_bytes == want.hbm_bytes, (b, s)
        assert got.detail == want.detail, (b, s)
        assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_tiny_checkpoint_equals_jax(ckpt, mode, monkeypatch):
    ours, theirs = tiny_pair(ckpt, mode, monkeypatch)
    assert _tree_bytes(ours.model.params) > 0
    assert_equal_costs(ours, theirs)


@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_preset_1p7b_equals_jax(mode, monkeypatch):
    monkeypatch.setenv("ASR_INT4_GROUP", "128")
    ours, theirs = preset_pair(mode)
    assert ours.model.params["decoder"]["embed"] is not None
    assert_equal_costs(ours, theirs)


def test_weight_bytes_follow_quantization():
    sizes = {}
    for mode in sorted(CONFIGS):
        ours, _ = preset_pair(mode)
        sizes[mode] = _tree_bytes(ours.model.params)
    # int8 about half of bf16, int4 about a quarter (scales on top)
    assert 0.45 < sizes["int8_kv4"] / sizes["bf16"] < 0.55
    assert 0.2 < sizes["int4"] / sizes["bf16"] < 0.3


def test_utilization_shares():
    cost = RooflineCost(flops=989e12, hbm_bytes=3.35e12, detail={})
    shares = utilization(cost, 2.0)
    assert shares == {"mfu": 0.5, "hbm_util": 0.5}
    assert H100_BF16_DENSE_FLOPS == 989e12
    assert H100_HBM_BYTES_PER_S == 3.35e12


# -- the properties of tests/test_roofline.py, on the port's model ------------

@pytest.fixture(scope="module")
def engine(ckpt):
    return load_engine(ckpt, device="cpu")


def test_linear_in_batch(engine):
    bf, bs = engine.bucket_frames(16000)
    c1 = analytic_cost(engine, 1, bf, bs)
    c4 = analytic_cost(engine, 4, bf, bs)
    assert c4.flops == pytest.approx(4 * c1.flops, rel=1e-9)
    assert c1.hbm_bytes < c4.hbm_bytes < 4 * c1.hbm_bytes


def test_monotone_in_clip_length(engine):
    c1 = analytic_cost(engine, 1, *engine.bucket_frames(16000))
    c6 = analytic_cost(engine, 1, *engine.bucket_frames(6 * 16000))
    assert c6.flops > c1.flops and c6.hbm_bytes > c1.hbm_bytes


def test_weights_reread_per_decode_step(engine):
    bf, bs = engine.bucket_frames(16000)
    c = analytic_cost(engine, 1, bf, bs)
    steps = max_new_tokens_for(bs) - 1
    enc_b = _tree_bytes(engine.model.params["encoder"])
    dec_b = _tree_bytes(engine.model.params["decoder"])
    assert c.detail["weights_gb_per_dispatch"] == enc_b + dec_b * (1 + steps)
    assert c.hbm_bytes > c.detail["weights_gb_per_dispatch"]


def test_decode_matmul_flops_hand_math(engine):
    bf, bs = engine.bucket_frames(16000)
    c = analytic_cost(engine, 1, bf, bs)
    dec = engine.model.cfg.decoder
    steps = max_new_tokens_for(bs) - 1
    layer_mm = (2 * dec.hidden_size * dec.num_attention_heads * dec.head_dim
                + 2 * dec.hidden_size * dec.num_key_value_heads * dec.head_dim
                + 3 * dec.hidden_size * dec.intermediate_size)
    mm_only = steps * 2.0 * (dec.num_hidden_layers * layer_mm
                             + dec.hidden_size * dec.vocab_size)
    assert mm_only < c.detail["decode_flops"] < mm_only * 10


def test_as_dict_units(engine):
    bf, bs = engine.bucket_frames(16000)
    d = analytic_cost(engine, 8, bf, bs).as_dict()
    assert set(d) >= {"tflops", "hbm_gb", "encoder_flops", "prefill_flops",
                      "decode_flops"}
    assert all(isinstance(v, float) for v in d.values())
