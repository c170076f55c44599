"""The port's quantization (``ops/quant.py``, ``ops/qgemv.py``,
``ops/qgemm.py``, ``ops/kv_int4.py``) against the JAX package's, in f32 on
the CPU, every input made from a numpy seed: int8/fp8/int4 payloads and
scales and the int4 KV values byte for byte; ``qdot`` in its routes, the
plain versions of kernels A and C, the quantized embedding and logits, the
int4 route of the batched decode kernel's plain version and the decoder
with int8 weights and an int4 cache to 1e-5 or 1e-4; and token ids
identical to the JAX engine with quantized weights (int4 included), an
int4 KV cache and W8A8 prefill."""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models import decoder as jdec
from qwen3_asr_tpu.ops import quant as jq
from qwen3_asr_tpu.ops.attention import AttnSpec as JaxSpec
from qwen3_asr_tpu.ops.attention import attend_xla
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.models.config import DecoderConfig
from qwen3_asr_tpu_torch.models.decoder import (KVCache, decoder_forward,
                                                embed_tokens, init_kv_cache,
                                                lm_logits)
from qwen3_asr_tpu_torch.ops import quant
from qwen3_asr_tpu_torch.ops.attention import AttnSpec
from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
    decode_attention_batched)
from qwen3_asr_tpu_torch.ops.kv_int4 import (kv_int4_write_plain, pack,
                                             quantize_kv, unpack)
from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine

from tests.test_torch_engine import CKPT, CLIPS, hd128_models, jax_engine
from tests.test_torch_model import _to_jax_cfg

TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    for name in ("ASR_INT8_ACT", "ASR_INT8_ACT_MIN_TOKENS", "QUANTIZE",
                 "ASR_QUANTIZE_EMBED", "ASR_KV_CACHE_DTYPE", "ASR_INT4_GROUP"):
        monkeypatch.delenv(name, raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(x) -> np.ndarray:
    """The bytes of a tensor or a JAX/numpy array, as uint8."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy()
    arr = np.ascontiguousarray(np.asarray(x))
    return arr.view(np.uint8)


def _weight(rng, shape, scale=0.05):
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    # one element a hair off a round multiple, so wf/scale lands at the top
    w.flat[7] = 0.4 + 3e-8
    return w


# -- payloads and scales, byte for byte -------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_array_bytes_equal_jax(mode, dtype):
    rng = np.random.default_rng(1)
    w = _weight(rng, (2, 64, 96))
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    ref = jax.device_get(jq.quantize_array(jw, mode))
    ours = quant.quantize_array(tw, mode)
    assert ours["q"].shape == (2, 96, 64)          # [L, out, in]
    assert ours["s"].dtype == tw.dtype and ours["s"].shape == (2, 1, 96)
    np.testing.assert_array_equal(_bits(ours["q"].transpose(1, 2)),
                                  _bits(ref["q"]))
    np.testing.assert_array_equal(_bits(ours["s"]), _bits(ref["s"]))
    np.testing.assert_array_equal(
        quant.dequantize(ours, torch.float32).transpose(1, 2).numpy(),
        np.asarray(jq.dequantize(jq.quantize_array(jw, mode), jnp.float32)))
    if mode == "fp8":
        # the column's absmax lands a hair above 448 at most: both give 448
        col = np.abs(w[0, :, 7]).argmax()
        assert int(_bits(ours["q"])[0, 7, col]) in (0x7e, 0xfe)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_quantize_embed_bytes_equal_jax(mode):
    rng = np.random.default_rng(2)
    e = _weight(rng, (300, 64))
    ref = jax.device_get(jq.quantize_embed(jnp.asarray(e), mode))
    ours = quant.quantize_embed(torch.from_numpy(e), mode)
    np.testing.assert_array_equal(_bits(ours["q"]), _bits(ref["q"]))
    np.testing.assert_array_equal(_bits(ours["s"]), _bits(ref["s"]))


# ASR_INT4_GROUP, K: JAX's default group, another, and K = 192 (the
# trained_ckpt decoder's hidden size), which JAX lowers the 128 group to 96
INT4_GROUPS = {"g128": ("128", 256), "g64": ("64", 256),
               "g128_lowered_to_96": ("128", 192)}


@pytest.mark.parametrize("group", list(INT4_GROUPS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_array_int4_bytes_equal_jax(monkeypatch, dtype, group):
    """int4 payloads (byte j: k = j low, k = j + K/2 high, biased by 8)
    and group scales byte for byte, in the port's layout (JAX's
    transposed); the bf16 source's scales computed and applied in f32, then
    stored in bf16, as JAX does; ``dequantize`` equal to JAX's."""
    env, k = INT4_GROUPS[group]
    monkeypatch.setenv("ASR_INT4_GROUP", env)
    rng = np.random.default_rng(21)
    w = _weight(rng, (2, k, 96))
    w[1, :, 5] = 0.0                              # the 1e-10 floor
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    ref = jax.device_get(jq.quantize_array(jw, "int4"))
    ours = quant.quantize_array(tw, "int4")
    groups = k // (96 if k == 192 else int(env))
    assert quant.is_packed_int4(ours)
    assert ours["q"].shape == (2, 96, k // 2)      # [L, out, in/2]
    assert ours["s"].dtype == tw.dtype and ours["s"].shape == (2, 96, groups)
    np.testing.assert_array_equal(_bits(ours["q"].transpose(1, 2)),
                                  _bits(ref["q"]))
    np.testing.assert_array_equal(
        _bits(ours["s"].transpose(1, 2).contiguous()), _bits(ref["s"]))
    np.testing.assert_array_equal(
        quant.dequantize(ours, torch.float32).transpose(1, 2).numpy(),
        np.asarray(jq.dequantize(jq.quantize_array(jw, "int4"),
                                 jnp.float32)))


def test_kv_quantize_bytes_equal_jax():
    """_kv_quantize's int4 values and bf16 scales, through the port's plain
    quantize, pack and unpack, and through the cache write."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4, 9, 128)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                              # the 1e-8 floor
    x[1, 2, 3, 5] = 70.0                          # one large value
    q_ref, s_ref = jax.device_get(jax.jit(
        lambda a: (lambda q, s: (q.astype(jnp.int8), s))(
            *jdec._kv_quantize(a)))(jnp.asarray(x)))
    q, s = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(unpack(pack(q)).numpy(), q_ref)
    np.testing.assert_array_equal(_bits(s.to(torch.bfloat16)), _bits(s_ref))

    cfg = DecoderConfig(vocab_size=8, hidden_size=8, intermediate_size=8,
                        num_hidden_layers=2, num_attention_heads=8,
                        num_key_value_heads=4, head_dim=128)
    for pos in (3, torch.tensor(3)):
        cache = init_kv_cache(cfg, 2, 16, torch.int4, "cpu")
        kv_int4_write_plain(cache, 1, torch.from_numpy(x),
                            torch.from_numpy(-x), pos)
        np.testing.assert_array_equal(
            unpack(cache.k[1, :, :, 3:12]).numpy(), q_ref)
        np.testing.assert_array_equal(
            unpack(cache.v[1, :, :, 3:12]).numpy(), -q_ref)
        np.testing.assert_array_equal(_bits(cache.k_scale[1, :, :, 3:12]),
                                      _bits(s_ref))
        assert not cache.k[0].any() and not cache.k[1, :, :, 12:].any()


# -- qdot's routes -----------------------------------------------------------------

QDOT_CASES = {
    # (mode, x shape, ASR_INT8_ACT, ASR_INT8_ACT_MIN_TOKENS, route)
    "dequant_int8": ("int8", (2, 7, 64), None, None, "dequant"),
    "dequant_fp8": ("fp8", (3, 64), None, None, "dequant"),
    "w8a8_at_threshold": ("int8", (2, 8, 64), "true", "16", "w8a8"),
    "act_below_threshold": ("int8", (15, 64), "true", "16", "dequant"),
    "act_on_fp8": ("fp8", (2, 8, 64), "true", "1", "dequant"),
    "act_default_threshold": ("int8", (4, 64), "true", None, "dequant"),
    # int4: one group (K = 64 under the default 128), four (a 16 group),
    # and W8A8 on at a threshold it reaches: never for int4
    "dequant_int4_one_group": ("int4", (2, 7, 64), None, None, "dequant"),
    "dequant_int4_groups": ("int4", (3, 64), None, None, "dequant"),
    "act_on_int4": ("int4", (2, 8, 64), "true", "1", "dequant"),
}
QDOT_INT4_GROUP = {"dequant_int4_groups": "16", "act_on_int4": "32"}


@pytest.mark.parametrize("name", list(QDOT_CASES))
def test_qdot_routes_match_jax(monkeypatch, name):
    mode, xshape, act, min_rows, route = QDOT_CASES[name]
    if act:
        monkeypatch.setenv("ASR_INT8_ACT", act)
    if min_rows:
        monkeypatch.setenv("ASR_INT8_ACT_MIN_TOKENS", min_rows)
    if name in QDOT_INT4_GROUP:
        monkeypatch.setenv("ASR_INT4_GROUP", QDOT_INT4_GROUP[name])
    rng = np.random.default_rng(4)
    w = _weight(rng, (64, 96))
    x = rng.standard_normal(xshape).astype(np.float32)
    ref = np.asarray(jq.qdot(jnp.asarray(x),
                             jq.quantize_array(jnp.asarray(w), mode)))
    leaf = quant.quantize_array(torch.from_numpy(w), mode)
    rows = int(np.prod(xshape[:-1]))
    assert quant.qdot_route(rows, on_cuda=False, x_dtype=torch.float32,
                            w_dtype=leaf["q"].dtype, w_ndim=2,
                            min_rows=quant.int8_act_min_rows()) == route
    if mode == "int4":
        want = {"dequant_int4_groups": 4, "act_on_int4": 2}.get(name, 1)
        assert leaf["s"].shape == (96, want)
    ours = quant.qdot(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=1e-6)
    if route == "w8a8":
        # the int32 product and the scales in JAX's order: the same bits
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("rows,cuda,dtype,w,ndim,min_rows,want", [
    (1, True, torch.bfloat16, torch.int8, 2, 0, "gemv"),
    (16, True, torch.bfloat16, torch.float8_e4m3fn, 2, 0, "gemv"),
    (16, True, torch.bfloat16, torch.int8, 2, 8, "gemv"),
    (17, True, torch.bfloat16, torch.int8, 2, 0, "gemm"),
    (4, True, torch.float32, torch.int8, 2, 0, ValueError),
    (4, True, torch.float32, torch.int8, 2, 1, ValueError),
    (17, True, torch.float32, torch.int8, 2, 17, "w8a8"),
    (4, False, torch.bfloat16, torch.int8, 2, 0, "dequant"),
    (1024, True, torch.bfloat16, torch.int8, 2, 1024, "w8a8"),
    (1023, True, torch.bfloat16, torch.int8, 2, 1024, "gemm"),
    (2048, True, torch.bfloat16, torch.float8_e4m3fn, 2, 1024, "gemm"),
    (2048, False, torch.float32, torch.int8, 3, 1024, "dequant"),
    # int4 (uint8 pairs): the GEMV, then the GEMM, never W8A8
    (16, True, torch.bfloat16, torch.uint8, 2, 1, "gemv"),
    (17, True, torch.bfloat16, torch.uint8, 2, 0, "gemm"),
    (2048, True, torch.bfloat16, torch.uint8, 2, 1024, "gemm"),
    (2048, False, torch.float32, torch.uint8, 2, 1, "dequant"),
    (17, True, torch.float32, torch.uint8, 2, 17, ValueError),
    (17, True, torch.float32, torch.int8, 2, 0, ValueError),
])
def test_qdot_route_rule(rows, cuda, dtype, w, ndim, min_rows, want):
    route = functools.partial(quant.qdot_route, rows, on_cuda=cuda,
                              x_dtype=dtype, w_dtype=w, w_ndim=ndim,
                              min_rows=min_rows)
    if want is ValueError:
        # rows on the card have the GEMV, W8A8 or the GEMM, or nothing: no
        # fallback
        with pytest.raises(ValueError, match="bf16"):
            route()
    else:
        assert route() == want


def test_plain_weights_pass_through():
    x, w = torch.randn(3, 8), torch.randn(8, 5)
    assert torch.equal(quant.qdot(x, w), x @ w)


# -- embedding and logits ----------------------------------------------------------

@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", ["int8", "fp8", "int4", "int4_g16"])
def test_embed_and_logits_match_jax(monkeypatch, mode, tied):
    """int4: the embedding packed along H with row scales (tied logits:
    one group), the untied lm_head with one group of H (64 under the
    default 128) or four (``int4_g16``): each group's sum scaled, then
    added, in f32."""
    if mode == "int4_g16":
        monkeypatch.setenv("ASR_INT4_GROUP", "16")
        mode = "int4"
    rng = np.random.default_rng(5)
    cfg = DecoderConfig(vocab_size=300, hidden_size=64, intermediate_size=64,
                        num_hidden_layers=1, num_attention_heads=2,
                        num_key_value_heads=1, head_dim=32,
                        tie_word_embeddings=tied)
    jc = _to_jax_cfg(cfg)
    params = {"embed": _weight(rng, (300, 64)),
              "layers": {"wq": _weight(rng, (1, 64, 64))}}
    if not tied:
        params["lm_head"] = _weight(rng, (64, 300))
    jparams = jax.device_get(jq.quantize_decoder_params(
        jax.tree.map(jnp.asarray, params), mode))
    ours = quant.quantize_decoder_params(params_from_jax(params, "cpu"),
                                         mode)
    carried = params_from_jax(jparams, "cpu")     # the JAX bytes, carried
    for name in ("embed", "lm_head") if not tied else ("embed",):
        for part in ("q", "s"):
            assert torch.equal(ours[name][part].view(torch.uint8),
                               carried[name][part].view(torch.uint8))
    ids = np.asarray([[1, 5, 299], [0, 7, 7]], np.int32)
    np.testing.assert_allclose(
        embed_tokens(ours, torch.from_numpy(ids).long()).numpy(),
        np.asarray(jdec.embed_tokens(jparams, jc, jnp.asarray(ids))),
        rtol=TOL, atol=0)
    h = rng.standard_normal((2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        lm_logits(ours, cfg, torch.from_numpy(h)).numpy(),
        np.asarray(jdec.lm_logits(jparams, jc, jnp.asarray(h))),
        rtol=TOL, atol=1e-6)


def test_quantize_embed_flag_keeps_full_precision(monkeypatch):
    monkeypatch.setenv("ASR_QUANTIZE_EMBED", "false")
    rng = np.random.default_rng(6)
    tree = {"decoder": {"embed": torch.from_numpy(_weight(rng, (30, 16))),
                        "layers": {"wq": torch.zeros(1, 16, 16),
                                   "ln1": torch.ones(1, 16)}},
            "encoder": {"layers": {"fc1_w": torch.zeros(1, 16, 32),
                                   "fc1_b": torch.zeros(1, 32)},
                        "conv_out_w": torch.zeros(16, 16)}}
    out = quant.quantize_params(tree, "int8")
    assert not quant.is_quantized(out["decoder"]["embed"])
    assert out["decoder"]["layers"]["wq"]["q"].dtype == torch.int8
    assert out["encoder"]["layers"]["fc1_w"]["q"].dtype == torch.int8
    assert out["encoder"]["layers"]["fc1_b"] is tree["encoder"]["layers"][
        "fc1_b"]
    assert out["encoder"]["conv_out_w"] is tree["encoder"]["conv_out_w"]
    assert quant.param_bytes(out["decoder"]["layers"]) < quant.param_bytes(
        tree["decoder"]["layers"])


@pytest.mark.parametrize("mode,error", [("int4", None),
                                        ("int2", ValueError)])
def test_quantize_refuses_modes_not_ported(mode, error):
    """An unknown mode raises; int4, ported now, quantizes (a [4, 4]
    weight: one group, two bytes a row)."""
    if error is None:
        leaf = quant.quantize_array(torch.zeros(4, 4), mode)
        assert quant.is_packed_int4(leaf)
        assert leaf["q"].shape == (4, 2) and leaf["s"].shape == (4, 1)
        return
    with pytest.raises(error, match="unknown quantization mode"):
        quant.quantize_array(torch.zeros(4, 4), mode)


# -- the int4 route of the batched decode kernel -----------------------------------

def test_int4_batched_plain_matches_jax_attend_xla():
    """JAX's int4 decode step (``attend_xla`` with scores-side scales) on
    the same values and scales, rows with different live ranges."""
    rng = np.random.default_rng(7)
    b, nq, nkv, s = 3, 8, 4, 256
    q = rng.standard_normal((b, nq, 1, 128)).astype(np.float32)
    kv = rng.integers(-8, 8, size=(2, b, nkv, s, 128)).astype(np.int8)
    sc = (rng.random((2, b, nkv, s, 1)) * 0.3 + 0.01).astype(np.float32)
    sc = np.array(jnp.asarray(sc, jnp.bfloat16).astype(jnp.float32))
    vf = np.asarray([0, 37, 100], np.int32)
    vt = np.asarray([256, 141, 101], np.int32)
    mask = JaxSpec(valid_from=jnp.asarray(vf),
                   valid_to=jnp.asarray(vt)).dense_mask(b, 1, s)
    ref = attend_xla(jnp.asarray(q), jnp.asarray(kv[0], jnp.float32),
                     jnp.asarray(kv[1], jnp.float32), mask=mask[:, None],
                     scale=128 ** -0.5, k_scale=jnp.asarray(sc[0]),
                     v_scale=jnp.asarray(sc[1]))
    planes = torch.from_numpy(sc).to(torch.bfloat16)
    ours = decode_attention_batched(
        torch.from_numpy(q), pack(torch.from_numpy(kv[0]))[None],
        pack(torch.from_numpy(kv[1]))[None], layer_idx=0,
        kv_valid_from=torch.from_numpy(vf), kv_valid_to=torch.from_numpy(vt),
        k_scale=planes[0][None], v_scale=planes[1][None])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


# -- the decoder with int8 weights and an int4 cache --------------------------------

HD128 = DecoderConfig(vocab_size=300, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=128)


def test_decoder_int8_weights_int4_cache_match_jax():
    """Prefill, then three decode steps; rows at or after valid_from (see
    tests/test_torch_model.py). JAX runs under jit: an eager int4 zero-fill
    trips a JAX bug."""
    jc = _to_jax_cfg(HD128)
    rng = np.random.default_rng(8)
    shapes = jax.eval_shape(lambda: jdec.init_decoder_params(
        jc, jax.random.PRNGKey(0)))
    tree = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32),
        shapes)
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        tree["layers"][n] += 1.0
    tree["final_norm"] += 1.0
    jparams = jq.quantize_decoder_params(jax.tree.map(jnp.asarray, tree),
                                         "int8")
    params = quant.quantize_decoder_params(params_from_jax(tree, "cpu"),
                                           "int8")
    b, t, s = 2, 20, 128
    vf = np.asarray([0, 5], np.int32)
    embeds = rng.standard_normal((b, t + 3, 256)).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=(0,))
    def jax_run(steps, embeds):
        cache = jdec.init_kv_cache(jc, b, s, dtype=jnp.int4)
        pos = jnp.broadcast_to(jnp.arange(t), (b, t))
        h, cache = jdec.decoder_forward(
            jparams, jc, embeds[:, :t], pos, cache, jnp.int32(0),
            JaxSpec(causal=True, valid_from=jnp.asarray(vf)))
        outs = [h]
        for p in range(t, t + steps):
            h, cache = jdec.decoder_forward(
                jparams, jc, embeds[:, p:p + 1], jnp.full((b, 1), p),
                cache, jnp.int32(p),
                JaxSpec(valid_from=jnp.asarray(vf),
                        valid_to=jnp.full((b,), p + 1, jnp.int32)))
            outs.append(h)
        return outs, cache.k.astype(jnp.int8), cache.k_scale

    refs, ref_k, ref_ks = jax.device_get(jax_run(3, jnp.asarray(embeds)))
    cache = init_kv_cache(HD128, b, s, torch.int4, "cpu")
    pos = torch.arange(t).expand(b, t)
    h, _ = decoder_forward(params, HD128, torch.from_numpy(embeds[:, :t]),
                           pos, cache, 0,
                           AttnSpec(causal=True, valid_from=torch.from_numpy(
                               vf)))
    for row in range(b):
        np.testing.assert_allclose(h[row, vf[row]:].numpy(),
                                   refs[0][row, vf[row]:], rtol=1e-4,
                                   atol=1e-4)
    for step in range(3):
        p = t + step
        h, _ = decoder_forward(
            params, HD128, torch.from_numpy(embeds[:, p:p + 1]),
            torch.full((b, 1), p), cache, torch.tensor(p),
            AttnSpec(valid_from=torch.from_numpy(vf),
                     valid_to=torch.full((b,), p + 1, dtype=torch.int32)))
        np.testing.assert_allclose(h.numpy(), refs[step + 1], rtol=1e-4,
                                   atol=1e-4)
    # the cache: values written from the same K to within one int4 step
    # (K differs by summation order), and the same scales to a bf16 ulp
    for row in range(b):
        keys = slice(vf[row], t + 3)     # pad keys differ past layer 0
        live = unpack(cache.k[:, row, :, keys]).numpy().astype(int)
        assert np.abs(live - ref_k[:, row, :, keys]).max() <= 1
        np.testing.assert_allclose(
            cache.k_scale[:, row, :, keys].float().numpy(),
            ref_ks[:, row, :, keys].astype(np.float32), rtol=1e-2)


# -- token ids against the JAX engine -----------------------------------------------

def _clip(i, seconds=None):
    with open(CLIPS[i], "rb") as f:
        audio, sr = decode_audio(f.read())
    return (audio if seconds is None else audio[:int(seconds * sr)]), sr


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_trained_ckpt_tokens_match_jax(monkeypatch, mode):
    """QUANTIZE through load_engine against the JAX engine with its own
    quantize_params (what its lifecycle applies), on trained_ckpt."""
    ref_eng = jax_engine()
    ref_eng.model.params = jq.quantize_params(ref_eng.model.params, mode)
    monkeypatch.setenv("QUANTIZE", mode)
    eng = load_engine(CKPT, device="cpu")
    assert eng.model.params["decoder"]["layers"]["wq"]["q"].dtype == (
        torch.int8 if mode == "int8" else torch.float8_e4m3fn)
    for i in (0, 6):
        audio, sr = _clip(i)
        ref = ref_eng.transcribe(audio, sr)[0]
        ours = eng.transcribe(audio, sr)[0]
        assert ours.token_ids == ref.token_ids and ours.text == ref.text
        assert len(set(ours.token_ids)) >= 3


def _hd128(mode="int8"):
    jax_model, model = hd128_models()
    jax_model.params = jq.quantize_params(jax_model.params, mode)
    model.params = quant.quantize_params(model.params, mode)
    return jax_model, model


def test_int8_int4_cache_engine_tokens_match_jax():
    """int8 weights + an int4 KV cache (every decode step on the batched
    kernel's int4 route: its plain version here; JAX's attend_xla with
    scores-side scales), B=1, then B=2 in one run."""
    jax_model, model = _hd128()
    jax_eng = JaxEngine(jax_model, dtype=jnp.float32, cache_dtype=jnp.int4)
    eng = TranscriptionEngine(model, device="cpu", cache_dtype=torch.int4)
    clips = [_clip(i, 1.5) for i in (5, 11)]         # the 2 s bucket
    ref = jax_eng.transcribe(*clips[0])[0]
    ours = eng.transcribe(*clips[0])[0]
    assert ours.token_ids == ref.token_ids
    assert len(set(ours.token_ids)) >= 3
    bucket = eng.bucket_frames(len(clips[0][0]))
    audio = [a for a, _ in clips]
    _, ref = jax_eng._run_bucket(audio, *bucket, None)
    _, ours = eng._run_bucket(audio, *bucket, None)
    assert eng.last_run["batch"] == 2 and ours == ref
    exe = next(iter(eng.executables.values()))
    assert exe.loop.cache.int4 and exe.loop.cache.k.dtype == torch.uint8


def test_w8a8_prefill_engine_tokens_match_jax(monkeypatch):
    """ASR_INT8_ACT=true with a threshold the prompt (and the encoder)
    reach and a decode step does not: W8A8 products in both, tokens
    identical."""
    monkeypatch.setenv("ASR_INT8_ACT", "true")
    monkeypatch.setenv("ASR_INT8_ACT_MIN_TOKENS", "64")
    jax_model, model = _hd128()
    jax_eng = JaxEngine(jax_model, dtype=jnp.float32)
    eng = TranscriptionEngine(model, device="cpu")
    audio, sr = _clip(2, 1.8)
    ref = jax_eng.transcribe(audio, sr)[0]
    ours = eng.transcribe(audio, sr)[0]
    assert eng.last_run["prompt_len"] >= 64
    assert ours.token_ids == ref.token_ids
    assert len(set(ours.token_ids)) >= 3


def test_params_from_jax_carries_quantized_leaves():
    """A JAX-quantized tree crosses bit for bit (int8 as int8, fp8 through
    bytes, bf16 scales as bf16) into the port's layout."""
    rng = np.random.default_rng(9)
    tree = {"embed": _weight(rng, (40, 32)),
            "layers": {"wq": _weight(rng, (2, 32, 48)),
                       "ln1": np.ones((2, 32), np.float32)},
            "lm_head": _weight(rng, (32, 40))}
    for mode in ("int8", "fp8"):
        jtree = jax.device_get(jq.quantize_decoder_params(
            jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree),
            mode))
        ours = params_from_jax(jtree, "cpu")
        for name in ("embed", "lm_head"):
            assert ours[name]["q"].shape == (40, 32)
        wq = ours["layers"]["wq"]
        assert wq["q"].shape == (2, 48, 32) and wq["s"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(wq["q"].transpose(1, 2)),
                                      _bits(jtree["layers"]["wq"]["q"]))
        np.testing.assert_array_equal(_bits(wq["s"]),
                                      _bits(jtree["layers"]["wq"]["s"]))
        assert ours["layers"]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("env,error", [
    ({"QUANTIZE": "int4"}, None),
    ({"QUANTIZE": "nf4"}, ValueError),
    ({"ASR_KV_CACHE_DTYPE": "int4"}, ValueError)])
def test_lifecycle_refuses(monkeypatch, env, error):
    """An unknown mode is refused before any weight is read; an int4
    cache needs head_dim 128 (trained_ckpt has 48). QUANTIZE=int4, ported
    now, loads: every layer and the tied embedding as uint8 pairs."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if error is None:
        dec = load_engine(CKPT, device="cpu").model.params["decoder"]
        assert all(dec["layers"][k]["q"].dtype == torch.uint8
                   for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                             "w_down"))
        assert quant.is_packed_int4(dec["embed"])
        return
    with pytest.raises(error):
        load_engine(CKPT, device="cpu")


def test_int4_cache_layout():
    cache = init_kv_cache(HD128, 3, 256, torch.int4, "cpu")
    assert isinstance(cache, KVCache) and cache.int4
    assert cache.k.shape == (2, 3, 2, 256, 64)
    assert cache.k.dtype == cache.v.dtype == torch.uint8
    assert cache.k_scale.shape == (2, 3, 2, 256, 1)
    assert cache.k_scale.dtype == torch.bfloat16
    assert not init_kv_cache(HD128, 1, 128, torch.bfloat16, "cpu").int4


@pytest.mark.parametrize("s_len,batch", [(768, 1), (768, 8), (512, 96),
                                         (256, 2)])
def test_int4_plan_counts_packed_bytes(s_len, batch):
    """#3's plan for an int4 cache counts 64 payload bytes and a 2-byte
    scale a row; its shared memory holds the payload (the scales sit in a
    static array of their own)."""
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        INT4_PLAN_ITEMSIZE, INT4_SMEM_ITEMSIZE, batch_plan)
    plan = batch_plan(s_len, batch, 8, INT4_PLAN_ITEMSIZE)
    assert plan == batch_plan(s_len, batch, 8, 1)      # as fp8's here
    assert plan.chunk * 66 <= 16384
    assert plan.smem_bytes(INT4_SMEM_ITEMSIZE, 2) >= 2 * plan.chunk * 64


def test_attend_routes_int4_steps_to_the_batched_kernel():
    """At B=1 too (a bf16 cache there takes the single-token kernel), and
    a prefill may not read the packed cache as it is."""
    from qwen3_asr_tpu_torch.ops.attention import attend, decode_kernel
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched_plain)
    assert decode_kernel(1, 128, 256, torch.int4) == "batched"
    with pytest.raises(ValueError, match="head_dim 128"):
        decode_kernel(1, 48, 256, torch.int4)
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 1, 128), generator=gen)
    k, v = (pack(torch.randint(-8, 8, (2, 1, 2, 256, 128), generator=gen,
                               dtype=torch.int8)) for _ in range(2))
    ks, vs = (torch.rand((2, 1, 2, 256, 1), generator=gen).to(torch.bfloat16)
              for _ in range(2))
    vf, vt = torch.tensor([3], dtype=torch.int32), torch.tensor(
        [200], dtype=torch.int32)
    out = attend(q, k, v, AttnSpec(valid_from=vf, valid_to=vt),
                 scale=128 ** -0.5, layer_idx=1, k_scale=ks, v_scale=vs)
    assert torch.equal(out, decode_attention_batched_plain(
        q, k, v, vf, vt, layer_idx=1, sm_scale=128 ** -0.5, k_scale=ks,
        v_scale=vs))
    with pytest.raises(ValueError, match="decode step"):
        attend(q.expand(1, 4, 2, 128), k, v, AttnSpec(causal=True),
               k_scale=ks, v_scale=vs)


def test_scale_planes_alone_mark_an_int4_cache():
    """#3's wrapper reads a cache as int4 when, and only when, its scale
    planes come with it: the packed payload alone, or one plane alone, is
    refused, not read as a plain cache."""
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched)
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((1, 4, 1, 128), generator=gen)
    k, v = (pack(torch.randint(-8, 8, (1, 2, 128, 128), generator=gen,
                               dtype=torch.int8)) for _ in range(2))
    ks = torch.rand((1, 2, 128, 1), generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_batched(q, k, v)
    with pytest.raises(ValueError, match="both"):
        decode_attention_batched(q, k, v, k_scale=ks)
    assert decode_attention_batched(q, k, v, k_scale=ks,
                                    v_scale=ks).shape == q.shape


def test_quantized_weights_on_the_card_need_bf16(monkeypatch):
    """Decode rows on the card have the GEMV (bf16) or nothing, so the
    lifecycle refuses quantized weights there at another working dtype
    before it reads a weight; the CPU takes any dtype."""
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="bf16"):
        quant.check_quantized_dtype(cuda, torch.float32)
    quant.check_quantized_dtype(cuda, torch.bfloat16)
    quant.check_quantized_dtype(torch.device("cpu"), torch.float32)
    import qwen3_asr_tpu_torch.runtime.lifecycle as lifecycle
    monkeypatch.setattr(lifecycle, "resolve_device", torch.device)
    monkeypatch.setattr(lifecycle, "load_asr_checkpoint",
                        lambda *a: pytest.fail("read weights first"))
    monkeypatch.setenv("QUANTIZE", "int8")
    with pytest.raises(ValueError, match="bf16"):
        load_engine(CKPT, device="cuda", dtype=torch.float32)
    leaf = quant.quantize_array(torch.ones(4, 2), "int8")
    assert quant.any_quantized({"a": {"b": leaf}, "c": torch.ones(1)})
    assert not quant.any_quantized({"a": {"b": torch.ones(1)}})


# -- kernel A's plan and the grouped product ---------------------------------------

# (m, output widths, K): the decoder's shapes at preset:1.7b (the tied
# lm_head, the two groups; w_down unsplit at 8 rows, three splits at 16),
# K that no warp or split count divides (1280, 1040, 8192 + 16), and a
# payload narrower than a tile
PLAN_CASES = {
    "wq_wo_m1": (1, [2048], 2048), "wk_wv_m8": (8, [1024], 2048),
    "gate_up_m16": (16, [6144], 2048), "down_m8": (8, [2048], 6144),
    "down_m16": (16, [2048], 6144),
    "lm_head_m1": (1, [151936], 2048), "qkv_group_m8": (8, [2048, 1024,
                                                            1024], 2048),
    "gate_up_group_m1": (1, [6144, 6144], 2048),
    "encoder_fc1_m3": (3, [5120], 1280), "k1040_m9": (9, [40, 24], 1040),
    "k8208_m2": (2, [300], 8208), "narrow_m16": (16, [8, 100, 5], 64),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_gemv_plan_covers_every_tile_and_k_once(name):
    """Kernel A's plan: every column tile of every payload in exactly one
    column group, every 64-k stretch of K in exactly one (split, warp),
    the splits contiguous and in order (the combine adds them so), a warp
    never holding more stretches than its registers (``ks`` of 1, 2, 4, or
    12 for up to 8 rows and one tile a block), the scratch and tickets the
    kernel indexes, and one grid per call."""
    from qwen3_asr_tpu_torch.ops.qgemv import plan
    m, ns, k = PLAN_CASES[name]
    p = plan(m, ns, k)
    assert p.n_tiles == (1 if m <= 8 else 2)
    assert p.tiles == sum(-(-n // 16) for n in ns)
    assert p.stretches * 64 >= k > (p.stretches - 1) * 64
    tiles = sorted(t for g in range(p.groups) for t in p.group_tiles(g))
    assert tiles == list(range(p.tiles))
    assert all(len(p.group_tiles(g)) for g in range(p.groups))
    covered, prev_hi = [], 0
    for split in range(p.splits):
        lo, hi = p.split_range(split)
        assert lo == prev_hi and lo < hi          # in order, none empty
        prev_hi = hi
        for warp in range(8):
            w_lo, w_hi = p.warp_range(split, warp)
            assert w_hi - w_lo <= p.kw <= p.ks and p.ks in (1, 2, 4, 12)
            covered += range(w_lo, w_hi)
    assert prev_hi == p.stretches
    assert covered == list(range(p.stretches))
    assert p.grid == p.groups * p.splits
    if p.ks == 12:
        assert m <= 8 and p.groups == p.tiles and p.splits == 1
    if p.splits > 1:
        # csrc/qgemv.cu: part[(split * m + row) * tiles * 16 + col]
        assert p.scratch == p.splits * m * p.tiles * 16
        assert p.tickets == p.groups <= 4096
    else:
        assert p.scratch == p.tickets == 0


@pytest.mark.parametrize("name", list(PLAN_CASES)[:8])
def test_gemv_plan_fills_the_card(name):
    """At the decoder's shapes: one column tile a block (about two blocks
    an SM at most) or, for the lm_head, one wave of evenly loaded blocks;
    K split only where a warp's registers force it (w_down at 16 rows).
    Splitting the small shapes to reach 132 blocks was measured slower
    (PERF.md; ``tools_perf/qgemv_plans.py``): w_q/w_o (128 blocks) and
    w_k/w_v (64) run unsplit."""
    from qwen3_asr_tpu_torch.ops.qgemv import plan
    m, ns, k = PLAN_CASES[name]
    p = plan(m, ns, k)
    assert p.splits == (3 if name == "down_m16" else 1)
    if p.tiles * p.splits <= 2 * 264:
        assert p.groups == p.tiles
    else:
        assert p.grid <= 264
        sizes = {len(p.group_tiles(g)) for g in range(p.groups)}
        assert max(sizes) - min(sizes) <= 1
    assert p.grid >= 132 or p.tiles < 132


@pytest.mark.parametrize("m,ns,k", [(0, [16], 64), (17, [16], 64),
                                    (1, [16], 100), (1, [16] * 4, 64)])
def test_gemv_plan_refuses(m, ns, k):
    from qwen3_asr_tpu_torch.ops.qgemv import plan
    with pytest.raises(ValueError):
        plan(m, ns, k)


def _leaves(rng, mode, widths, k=64):
    return [torch.from_numpy(_weight(rng, (k, n))) if mode == "bf16"
            else quant.quantize_array(torch.from_numpy(_weight(rng, (k, n))),
                                      mode) for n in widths]


@pytest.mark.parametrize("widths", [[96, 32, 32], [80, 80]],
                         ids=["qkv", "gate_up"])
@pytest.mark.parametrize("mode", ["bf16", "int8", "fp8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdot_group_equals_separate_qdots(mode, widths, dtype):
    """On the CPU ``qdot_group`` is one product per weight: the bits of
    separate ``qdot`` calls, for plain, int8, fp8 and int4 leaves, decode
    rows and prefill rows."""
    rng = np.random.default_rng(13)
    ws = _leaves(rng, mode, widths)
    if mode == "bf16":
        ws = [w.to(dtype) for w in ws]
    for shape in ((2, 1, 64), (1, 37, 64)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
        outs = quant.qdot_group(x, ws)
        assert len(outs) == len(ws)
        for out, w in zip(outs, ws):
            ref = quant.qdot(x, w)
            assert out.dtype == ref.dtype and out.shape == ref.shape
            assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_qdot_group_takes_one_grouped_launch_on_the_gemm_route(
        monkeypatch, mode):
    """Where the route is the GEMM (more than 16 rows on the card; forced
    here), ``qdot_group`` makes ONE ``qgemm_group`` call for all weights,
    whose plain version on the CPU gives the bits of separate ``qdot``
    calls."""
    rng = np.random.default_rng(24)
    ws = _leaves(rng, mode, [96, 32, 32])
    x = torch.from_numpy(rng.standard_normal((2, 20, 64)).astype(
        np.float32))
    refs = [quant.qdot(x, w) for w in ws]
    calls = []
    real = quant.qgemm_group
    monkeypatch.setattr(quant, "_route", lambda *a, **kw: "gemm")
    monkeypatch.setattr(quant, "qgemm_group",
                        lambda *a, **kw: calls.append(len(a[1]))
                        or real(*a, **kw))
    outs = quant.qdot_group(x, ws)
    assert calls == [3]
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_qdot_group_takes_one_grouped_launch_on_the_gemv_route(
        monkeypatch, mode):
    """Where the route is the GEMV (decode rows on the card; forced here),
    ``qdot_group`` makes ONE ``qgemv_group`` call for all weights, whose
    plain version on the CPU gives the bits of separate dequant-route
    ``qdot`` calls; plain weights take ``qdot``."""
    rng = np.random.default_rng(14)
    ws = _leaves(rng, mode, [96, 32, 32])
    x = torch.from_numpy(rng.standard_normal((3, 1, 64)).astype(np.float32))
    refs = [quant.qdot(x, w) for w in ws]
    calls = []
    real = quant.qgemv_group
    monkeypatch.setattr(quant, "_route", lambda *a, **kw: "gemv")
    monkeypatch.setattr(quant, "qgemv_group",
                        lambda *a, **kw: calls.append(len(a[1]))
                        or real(*a, **kw))
    outs = quant.qdot_group(x, ws)
    assert calls == [3]
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)
    quant.qdot_group(x, ws[:2])
    quant.qdot_group(x, _leaves(rng, "bf16", [96, 32]))
    assert calls == [3, 2]


def test_decoder_layer_through_qdot_group_matches_jax(monkeypatch):
    """The decoder with fp8 weights and an f32 cache, whose layers take
    q/k/v and gate/up through ``qdot_group`` (one call each a layer and
    step), against JAX's decoder: prefill, then two decode steps, rows at
    or after valid_from, to 1e-4 as the int8 + int4 test above."""
    import qwen3_asr_tpu_torch.models.decoder as tdec
    jc = _to_jax_cfg(HD128)
    rng = np.random.default_rng(15)
    shapes = jax.eval_shape(lambda: jdec.init_decoder_params(
        jc, jax.random.PRNGKey(0)))
    tree = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32),
        shapes)
    for n in ("ln1", "ln2", "q_norm", "k_norm"):
        tree["layers"][n] += 1.0
    tree["final_norm"] += 1.0
    jparams = jq.quantize_decoder_params(jax.tree.map(jnp.asarray, tree),
                                         "fp8")
    params = quant.quantize_decoder_params(params_from_jax(tree, "cpu"),
                                           "fp8")
    groups = []
    real = tdec.qdot_group
    monkeypatch.setattr(tdec, "qdot_group",
                        lambda x, ws: groups.append(len(ws)) or real(x, ws))
    b, t, s = 2, 12, 64
    vf = np.asarray([0, 3], np.int32)
    embeds = rng.standard_normal((b, t + 2, 256)).astype(np.float32)

    @functools.partial(jax.jit, static_argnums=(0,))
    def jax_run(steps, embeds):
        cache = jdec.init_kv_cache(jc, b, s, dtype=jnp.float32)
        pos = jnp.broadcast_to(jnp.arange(t), (b, t))
        h, cache = jdec.decoder_forward(
            jparams, jc, embeds[:, :t], pos, cache, jnp.int32(0),
            JaxSpec(causal=True, valid_from=jnp.asarray(vf)))
        outs = [h]
        for p in range(t, t + steps):
            h, cache = jdec.decoder_forward(
                jparams, jc, embeds[:, p:p + 1], jnp.full((b, 1), p),
                cache, jnp.int32(p),
                JaxSpec(valid_from=jnp.asarray(vf),
                        valid_to=jnp.full((b,), p + 1, jnp.int32)))
            outs.append(h)
        return outs

    refs = jax.device_get(jax_run(2, jnp.asarray(embeds)))
    cache = init_kv_cache(HD128, b, s, torch.float32, "cpu")
    h, _ = decoder_forward(params, HD128, torch.from_numpy(embeds[:, :t]),
                           torch.arange(t).expand(b, t), cache, 0,
                           AttnSpec(causal=True,
                                    valid_from=torch.from_numpy(vf)))
    for row in range(b):
        np.testing.assert_allclose(h[row, vf[row]:].numpy(),
                                   refs[0][row, vf[row]:], rtol=1e-4,
                                   atol=1e-4)
    for step in range(2):
        p = t + step
        h, _ = decoder_forward(
            params, HD128, torch.from_numpy(embeds[:, p:p + 1]),
            torch.full((b, 1), p), cache, torch.tensor(p),
            AttnSpec(valid_from=torch.from_numpy(vf),
                     valid_to=torch.full((b,), p + 1, dtype=torch.int32)))
        np.testing.assert_allclose(h.numpy(), refs[step + 1], rtol=1e-4,
                                   atol=1e-4)
    layers = HD128.num_hidden_layers
    assert groups == [3, 2] * layers * 3


# -- int4 weights (QUANTIZE=int4) ---------------------------------------------------

@pytest.mark.parametrize("group", ["128", "16"])
def test_params_from_jax_carries_int4_leaves(monkeypatch, group):
    """A JAX int4 tree (bf16 source) crosses bit for bit: layer and untied
    lm_head payloads and their [G, N] scales transposed, the packed
    embedding as it is; the result equals the port's own quantization of
    the same weights, byte for byte."""
    monkeypatch.setenv("ASR_INT4_GROUP", group)
    rng = np.random.default_rng(22)
    tree = {"embed": _weight(rng, (40, 64)),
            "layers": {"wq": _weight(rng, (2, 64, 48)),
                       "w_down": _weight(rng, (2, 96, 64)),
                       "ln1": np.ones((2, 64), np.float32)},
            "lm_head": _weight(rng, (64, 40))}
    jtree = jax.device_get(jq.quantize_decoder_params(
        jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree), "int4"))
    carried = params_from_jax(jtree, "cpu")
    ours = quant.quantize_decoder_params(
        params_from_jax(tree, "cpu", torch.bfloat16), "int4")

    def groups(k):                       # JAX's rule: the group divides K
        return k // next(d for d in range(min(int(group), k), 0, -1)
                         if k % d == 0)

    want = {"embed": ((40, 32), (40, 1)), "lm_head": ((40, 32),
                                                      (40, groups(64))),
            "wq": ((2, 48, 32), (2, 48, groups(64))),
            "w_down": ((2, 64, 48), (2, 64, groups(96)))}
    for name, leaf in (("embed", carried["embed"]),
                       ("lm_head", carried["lm_head"]),
                       ("wq", carried["layers"]["wq"]),
                       ("w_down", carried["layers"]["w_down"])):
        mine = ours[name] if name in ours else ours["layers"][name]
        assert quant.is_packed_int4(leaf) and quant.is_packed_int4(mine)
        assert (tuple(leaf["q"].shape), tuple(leaf["s"].shape)) == want[name]
        assert leaf["s"].dtype == torch.bfloat16
        for part in ("q", "s"):
            np.testing.assert_array_equal(_bits(leaf[part]),
                                          _bits(mine[part]))
    np.testing.assert_array_equal(
        _bits(carried["layers"]["wq"]["q"].transpose(1, 2)),
        _bits(jtree["layers"]["wq"]["q"]))


@pytest.mark.parametrize("group", ["64", "16"], ids=["one_group",
                                                     "four_groups"])
def test_int4_kernel_plain_versions_match_jax_qdot(monkeypatch, group):
    """The plain versions of kernel A (``qgemv_plain``, decode rows) and
    kernel C (``qgemm_plain``, prefill rows) on int4 pairs, and ``qdot``'s
    CPU route, against JAX's int4 ``qdot`` in f32 (one sum times s for one
    group; each group's sum times its scale, added, for more): rtol 1e-5,
    atol 1e-6 (orders of f32 summation)."""
    from qwen3_asr_tpu_torch.ops.qgemm import qgemm, qgemm_plain
    from qwen3_asr_tpu_torch.ops.qgemv import qgemv, qgemv_plain
    monkeypatch.setenv("ASR_INT4_GROUP", group)
    rng = np.random.default_rng(23)
    w = _weight(rng, (64, 80))
    jleaf = jq.quantize_array(jnp.asarray(w), "int4")
    leaf = quant.quantize_array(torch.from_numpy(w), "int4")
    assert leaf["s"].shape == (80, 64 // int(group))
    for rows, fns in ((3, (qgemv_plain, qgemv)), (37, (qgemm_plain, qgemm))):
        x = rng.standard_normal((rows, 64)).astype(np.float32)
        ref = np.asarray(jq.qdot(jnp.asarray(x), jleaf))
        for fn in fns:
            out = fn(torch.from_numpy(x), leaf["q"], quant.row_scales(leaf),
                     out_dtype=torch.float32)
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(
            quant.qdot(torch.from_numpy(x), leaf).numpy(), ref, rtol=1e-5,
            atol=1e-6)


# (m, output widths, K) of int4 products at preset:1.7b and the tied
# lm_head: a warp holds 128 k a stretch, half as many stretches as int8's
INT4_PLAN_CASES = {"wq_m1": (1, [2048], 2048), "down_m8": (8, [2048], 6144),
                   "down_m16": (16, [2048], 6144),
                   "lm_head_m1": (1, [151936], 2048),
                   "qkv_m8": (8, [2048, 1024, 1024], 2048),
                   "k12288_m4": (4, [1024], 12288)}


@pytest.mark.parametrize("name", list(INT4_PLAN_CASES))
def test_int4_gemv_plan_holds_the_same_k_a_warp(name):
    """Kernel A's plan for int4 pairs: stretches of 64 bytes (128 k), a
    warp holding at most 2 (or 6 with one 8-row tile), so a warp's k and
    the splits are those of the int8 plan of the same shape, and every
    stretch of K/2 bytes is in exactly one (split, warp)."""
    from qwen3_asr_tpu_torch.ops.qgemv import plan
    m, ns, k = INT4_PLAN_CASES[name]
    p4, p8 = plan(m, ns, k, packed=True), plan(m, ns, k)
    assert p4.stretches * 64 >= k // 2 > (p4.stretches - 1) * 64
    assert p4.ks in (1, 2, 6) and p4.ks * 2 == p8.ks or p8.ks == 1
    assert (p4.splits, p4.groups, p4.n_tiles) == (p8.splits, p8.groups,
                                                  p8.n_tiles)
    covered = [s for split in range(p4.splits) for warp in range(8)
               for s in range(*p4.warp_range(split, warp))]
    assert covered == list(range(p4.stretches))
    with pytest.raises(ValueError, match="multiple of 32"):
        plan(m, ns, 48, packed=True)


def test_int4_layouts_the_card_refuses():
    """Kernels A and C apply a group's scale to each half-stretch of 64 k,
    so on the card an int4 layout needs K/2 and the group size multiples
    of 64 (or one group): preset:1.7b's (K 1280, 2048, 5120, 6144 at the
    default 128) pass; trained_ckpt's 192 = 2 x 96 does not. The check
    reads shapes only, and names every leaf it refuses; the CPU takes any
    layout."""
    from qwen3_asr_tpu_torch.ops.qgemv import int4_layout_error
    for k in (1280, 2048, 5120, 6144):
        assert int4_layout_error(k, k // 128) is None
    assert int4_layout_error(2048, 1) is None           # the tied lm_head
    assert "multiples of 64" in int4_layout_error(192, 2)
    assert "multiples of 64" in int4_layout_error(2048, 64)    # groups of 32
    assert "multiple of 32" in int4_layout_error(200, 1)
    good = quant.quantize_array(torch.zeros(256, 8), "int4")
    bad = {"q": torch.zeros((8, 96), dtype=torch.uint8),
           "s": torch.ones((8, 2))}
    tree = {"decoder": {"layers": {"wq": good, "wo": bad}}}
    quant.check_int4_layouts(tree, torch.device("cpu"))
    quant.check_int4_layouts({"wq": good}, torch.device("cuda"))
    with pytest.raises(ValueError, match="decoder/layers/wo"):
        quant.check_int4_layouts(tree, torch.device("cuda"))


@pytest.mark.parametrize("group", [None, "32"], ids=["default", "g32"])
def test_int4_trained_ckpt_tokens_match_jax(monkeypatch, group):
    """QUANTIZE=int4 through load_engine (f32, f32 cache: trained_ckpt's
    head_dim 48 refuses an int4 cache) against the JAX engine with its own
    quantize_params, token ids identical. The default group lowers to 96
    at K = 192 and 128 at 512; 32 makes 6 and 16 groups."""
    if group:
        monkeypatch.setenv("ASR_INT4_GROUP", group)
    ref_eng = jax_engine()
    ref_eng.model.params = jq.quantize_params(ref_eng.model.params, "int4")
    monkeypatch.setenv("QUANTIZE", "int4")
    eng = load_engine(CKPT, device="cpu")
    wq = eng.model.params["decoder"]["layers"]["wq"]
    assert wq["q"].dtype == torch.uint8
    assert wq["s"].shape[-1] == (2 if group is None else 6)
    for i in (0, 6):
        audio, sr = _clip(i)
        ref = ref_eng.transcribe(audio, sr)[0]
        ours = eng.transcribe(audio, sr)[0]
        assert ours.token_ids == ref.token_ids and ours.text == ref.text
        assert len(set(ours.token_ids)) >= 3


def test_int4_weights_int4_cache_engine_tokens_match_jax():
    """int4 weights + an int4 KV cache (the card's int4 configuration) on
    the head_dim-128 decoder, B=1, then B=2 in one run: tokens identical
    to the JAX engine."""
    jax_model, model = _hd128("int4")
    jax_eng = JaxEngine(jax_model, dtype=jnp.float32, cache_dtype=jnp.int4)
    eng = TranscriptionEngine(model, device="cpu", cache_dtype=torch.int4)
    clips = [_clip(i, 1.5) for i in (5, 11)]
    ref = jax_eng.transcribe(*clips[0])[0]
    ours = eng.transcribe(*clips[0])[0]
    assert ours.token_ids == ref.token_ids
    assert len(set(ours.token_ids)) >= 3
    bucket = eng.bucket_frames(len(clips[0][0]))
    audio = [a for a, _ in clips]
    _, ref = jax_eng._run_bucket(audio, *bucket, None)
    _, ours = eng._run_bucket(audio, *bucket, None)
    assert eng.last_run["batch"] == 2 and ours == ref


def test_int4_served_through_the_manager_and_server(monkeypatch):
    """QUANTIZE=int4 loads through load_engine and serves through the
    manager and the HTTP server: the response's text is the engine's."""
    from tests.test_torch_server import _post, serving
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    monkeypatch.setenv("QUANTIZE", "int4")
    monkeypatch.setenv("SKIP_WARMUP", "true")
    eng = load_engine(CKPT, device="cpu")
    audio, sr = _clip(3)
    want = eng.transcribe(audio, sr)[0]
    with serving(ModelManager(eng)) as url:
        status, body = _post(url, encode_wav(audio, sr))
    assert status == 200 and body["text"] == want.text
