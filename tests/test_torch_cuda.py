"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a card every test here skips (decided inside the
fixture, so every worker collects the same tests). On a machine with one
(which need not have JAX, hence ``--noconftest``):
``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

import torch

from qwen3_asr_tpu_torch.models.asr import AsrModel
from qwen3_asr_tpu_torch.models.config import AsrConfig, DecoderConfig, preset
from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
from qwen3_asr_tpu_torch.models.encoder import init_encoder_params
from qwen3_asr_tpu_torch.ops import decode_attention as decode_module
from qwen3_asr_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)
from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
    decode_attention_batched, decode_attention_batched_plain)
from qwen3_asr_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from qwen3_asr_tpu_torch.ops.slab_reader import slab_read, slab_read_plain
from qwen3_asr_tpu_torch.runtime import graphs
from qwen3_asr_tpu_torch.runtime.engine import (TranscriptionEngine,
                                                max_new_tokens_for)
from qwen3_asr_tpu_torch.runtime.generate import DECODE_CHUNK, GreedyLoop
from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer

pytestmark = pytest.mark.cuda

# f32: summation order only. bf16 inputs at unit scale: outputs round to
# bf16 (8-bit mantissa, half-ulp 2^-9 relative) on top of f32 math.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


FLASH_CASES = {
    # (b, nq, nkv, t, s, d, causal, window, valid_from, valid_to, q_offset)
    "encoder_window": (2, 4, 4, 125, 125, 64, False, 50, [0, 0], [125, 90],
                       [0, 0]),
    "prefill_causal_left_pad": (2, 16, 8, 97, 256, 128, True, 0, [20, 63],
                                [256, 256], [0, 0]),
    "trained_ckpt_heads": (1, 4, 2, 70, 128, 48, True, 0, [30], [128], [0]),
    "d24_q_offset": (2, 4, 2, 33, 140, 24, True, 0, [0, 5], [140, 120],
                     [60, 100]),
    "fully_masked_rows": (1, 2, 2, 40, 40, 64, False, 0, [45], [40], [0]),
    # the main path's shapes at preset:1.7b (encoder 30 s, prefill 30 s)
    "encoder_30s": (1, 20, 20, 375, 375, 64, False, 50, [0], [375], [0]),
    "prefill_30s": (1, 16, 8, 453, 768, 128, True, 0, [50], [768], [0]),
    # windows crossing 64-key tiles, T not a multiple of the tile's rows
    "window_crossing_tiles": (2, 2, 2, 230, 230, 64, False, 50, [0, 0],
                              [230, 171], [0, 0]),
    # a group of 3 (21 rows a head) and of 8 (8 rows), d 48 and 96
    "group3_d48_q_offset": (2, 6, 2, 50, 120, 48, True, 0, [7, 0],
                            [120, 90], [40, 70]),
    "group8_d96": (1, 16, 2, 29, 200, 96, True, 0, [3], [200], [171]),
    # resume's verify windows at preset:1.7b: T = max_new queries at
    # q_offset = the prompt's length, causal over the whole cache, rows
    # left-padded from valid_from (1 s bucket: prompt 103, T 32; 6 s:
    # prompt 153, T 64; S = 256), and a partial tile of 24 rows
    "verify_1s_t32_b1": (1, 16, 8, 32, 256, 128, True, 0, [12], [256],
                         [103]),
    "verify_1s_t24_b4": (4, 16, 8, 24, 256, 128, True, 0, [12, 15, 0, 12],
                         [256] * 4, [103] * 4),
    "verify_6s_t64_b1": (1, 16, 8, 64, 256, 128, True, 0, [12], [256],
                         [153]),
    "verify_6s_t64_b4": (4, 16, 8, 64, 256, 128, True, 0, [12, 40, 0, 12],
                         [256] * 4, [153] * 4),
    "verify_trained_ckpt_t40": (2, 4, 2, 40, 256, 48, True, 0, [20, 30],
                                [256, 256], [110, 110]),
    # the forced aligner's encoder at preset:1.7b: 25 tokens a 2 s chunk
    # of mel, windows of 50, at 60, 120 and 300 s (T not a multiple of
    # the 64-row tile at 3750)
    "aligner_60s": (1, 20, 20, 750, 750, 64, False, 50, [0], [750], [0]),
    "aligner_120s": (1, 20, 20, 1500, 1500, 64, False, 50, [0], [1500],
                     [0]),
    "aligner_300s": (1, 20, 20, 3750, 3750, 64, False, 50, [0], [3750],
                     [0]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernel_matches_plain(dev, name, dtype):
    b, nq, nkv, t, s, d, causal, window, vf, vt, qo = FLASH_CASES[name]
    rng = np.random.default_rng(0)
    q = _randn(rng, (b, nq, t, d), dtype, dev)
    k = _randn(rng, (b, nkv, s, d), dtype, dev)
    v = _randn(rng, (b, nkv, s, d), dtype, dev)
    vf, vt, qo = (torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in (vf, vt, qo))
    before = flash_attention.launches
    out, m, l = flash_attention(q, k, v, causal=causal, q_offset=qo,
                                kv_valid_from=vf, kv_valid_to=vt,
                                window_block=window, return_residuals=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, m_ref, l_ref = flash_attention_plain(
        q, k, v, vf, vt, qo, causal=causal, window_block=window,
        sm_scale=d ** -0.5)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, m_ref, atol=tol, rtol=tol)
    torch.testing.assert_close(l, l_ref, atol=tol, rtol=tol)


DECODE_CASES = {
    # (layers, b, nq, nkv, s, d, layer, valid_from, valid_to)
    "stacked_1p7b": (4, 2, 16, 8, 768, 128, 3, [20, 63], [500, 768]),
    "one_layer_d48": (0, 3, 4, 2, 256, 48, 0, [0, 30, 10], [129, 200, 10]),
    "stacked_d24": (2, 1, 4, 2, 128, 24, 1, [64], [100]),
    # shorter than one chunk, valid_from inside a chunk, an empty range,
    # valid_to past S
    "short_live_range": (2, 1, 16, 8, 768, 128, 1, [100], [109]),
    "vf_mid_chunk_vt_past_s": (0, 2, 4, 2, 256, 64, 0, [37, 5], [300, 256]),
    "empty_range": (0, 2, 8, 1, 128, 128, 0, [60, 0], [60, 128]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_kernel_matches_plain(dev, name, dtype):
    n_layers, b, nq, nkv, s, d, layer, vf, vt = DECODE_CASES[name]
    rng = np.random.default_rng(1)
    shape = ((n_layers,) if n_layers else ()) + (b, nkv, s, d)
    q = _randn(rng, (b, nq, 1, d), dtype, dev)
    k = _randn(rng, shape, dtype, dev)
    v = _randn(rng, shape, dtype, dev)
    vf = torch.tensor(vf, dtype=torch.int32, device=dev)
    vt = torch.tensor(vt, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    out = decode_attention(q, k, v, layer_idx=layer, kv_valid_from=vf,
                           kv_valid_to=vt)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, k, v, vf, vt, layer_idx=layer,
                                 sm_scale=d ** -0.5)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    dead = torch.minimum(vt, torch.tensor(s, device=dev)) <= vf.clamp(min=0)
    assert not out[dead].float().abs().any()


def _decode_inputs(dev, dtype=torch.bfloat16):
    rng = np.random.default_rng(4)
    q = _randn(rng, (1, 16, 1, 128), dtype, dev)
    k = _randn(rng, (4, 1, 8, 768, 128), dtype, dev)
    v = _randn(rng, (4, 1, 8, 768, 128), dtype, dev)
    vf = torch.tensor([50], dtype=torch.int32, device=dev)
    vt = torch.tensor([620], dtype=torch.int32, device=dev)
    return q, k, v, vf, vt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_is_deterministic(dev, dtype):
    """One launch per call; the same bits twice; every ticket back at 0."""
    q, k, v, vf, vt = _decode_inputs(dev, dtype)
    before = decode_attention.launches
    outs = [decode_attention(q, k, v, layer_idx=2, kv_valid_from=vf,
                             kv_valid_to=vt) for _ in range(2)]
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    assert not decode_module._tickets[outs[0].device].any()


def test_decode_kernel_replays_in_a_cuda_graph(dev):
    q, k, v, vf, vt = _decode_inputs(dev)
    eager = decode_attention(q, k, v, layer_idx=3, kv_valid_from=vf,
                             kv_valid_to=vt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, k, v, layer_idx=3, kv_valid_from=vf,
                         kv_valid_to=vt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, layer_idx=3, kv_valid_from=vf,
                               kv_valid_to=vt)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert not decode_module._tickets[out.device].any()


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 2, 4, 20), device=dev)        # head_dim 20: not x8
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1], q[:, :1])
    q16 = torch.zeros((1, 2, 1, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        decode_attention(q16, q16[:, :1], q16[:, :1])


BATCH_CASES = {
    # (layers, b, nq, nkv, s, layer, valid_from, valid_to)
    "stacked_1p7b_b8": (3, 8, 16, 8, 768, 2, [12] * 7 + [700],
                        [570] * 7 + [768]),
    "one_layer_left_pad": (0, 4, 8, 4, 256, 0, [0, 130, 5, 40],
                           [256, 256, 6, 40]),
    "group8_b2": (2, 2, 16, 2, 384, 1, [0, 200], [129, 384]),
    # B=1: the plan's smallest chunks (16 keys at S=256, 32 at S=768)
    "b1_s256_chunk16": (2, 1, 16, 8, 256, 1, [37], [141]),
    "b1_s768_1p7b": (2, 1, 16, 8, 768, 0, [50], [621]),
    # the JAX serving shape, rows at different fill levels
    "serving_b96_s512": (0, 96, 16, 8, 512, 0, [i % 3 for i in range(96)],
                         [257 + 50 * (i % 5) for i in range(96)]),
    # a live range inside one chunk (64 keys at B=2), one of a single key
    "inside_one_chunk": (0, 2, 16, 8, 768, 0, [70, 200], [75, 201]),
    "empty_range": (0, 2, 8, 4, 256, 0, [60, 0], [60, 0]),
}
# The plain version takes the same max per chunk of the same plan and
# rounds p and q·scale to bf16 at the same points: f32 outputs differ by
# summation order and by expf against torch.exp, which can move one bf16(p)
# by an ulp.
BATCH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float8_e4m3fn), (torch.float32,
                                            torch.float8_e4m3fn)],
    ids=["f32", "bf16", "bf16_fp8", "f32_fp8"])
@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_batched_decode_kernel_matches_plain(dev, name, q_dtype, kv_dtype):
    n_layers, b, nq, nkv, s, layer, vf, vt = BATCH_CASES[name]
    rng = np.random.default_rng(2)
    shape = ((n_layers,) if n_layers else ()) + (b, nkv, s, 128)
    q = _randn(rng, (b, nq, 1, 128), q_dtype, dev)
    k = _randn(rng, shape, torch.float32, dev).to(kv_dtype)
    v = _randn(rng, shape, torch.float32, dev).to(kv_dtype)
    vf = torch.tensor(vf, dtype=torch.int32, device=dev)
    vt = torch.tensor(vt, dtype=torch.int32, device=dev)
    before = decode_attention_batched.launches
    out = decode_attention_batched(q, k, v, layer_idx=layer,
                                   kv_valid_from=vf, kv_valid_to=vt)
    torch.cuda.synchronize()
    assert decode_attention_batched.launches == before + 1
    ref = decode_attention_batched_plain(q, k, v, vf, vt, layer_idx=layer,
                                         sm_scale=128 ** -0.5)
    tol = BATCH_TOL[q_dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    dead = (torch.minimum(vt, torch.tensor(s, device=dev))
            <= vf.clamp(min=0))
    assert not out[dead].float().abs().any()


def _batch_inputs(dev, kv_dtype):
    rng = np.random.default_rng(6)
    q = _randn(rng, (8, 16, 1, 128), torch.bfloat16, dev)
    k = _randn(rng, (4, 8, 8, 768, 128), torch.float32, dev).to(kv_dtype)
    v = _randn(rng, (4, 8, 8, 768, 128), torch.float32, dev).to(kv_dtype)
    vf = torch.tensor([12] * 7 + [700], dtype=torch.int32, device=dev)
    vt = torch.tensor([570] * 7 + [768], dtype=torch.int32, device=dev)
    return q, k, v, vf, vt


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "fp8"])
def test_batched_decode_kernel_is_deterministic(dev, kv_dtype):
    """One launch per call; the same bits twice; every ticket back at 0."""
    q, k, v, vf, vt = _batch_inputs(dev, kv_dtype)
    before = decode_attention_batched.launches
    outs = [decode_attention_batched(q, k, v, layer_idx=2, kv_valid_from=vf,
                                     kv_valid_to=vt) for _ in range(2)]
    torch.cuda.synchronize()
    assert decode_attention_batched.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    assert not decode_module._tickets[outs[0].device].any()


def test_batched_decode_kernel_replays_in_a_cuda_graph(dev):
    q, k, v, vf, vt = _batch_inputs(dev, torch.float8_e4m3fn)
    eager = decode_attention_batched(q, k, v, layer_idx=3, kv_valid_from=vf,
                                     kv_valid_to=vt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_batched(q, k, v, layer_idx=3, kv_valid_from=vf,
                                 kv_valid_to=vt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_batched(q, k, v, layer_idx=3,
                                       kv_valid_from=vf, kv_valid_to=vt)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert not decode_module._tickets[out.device].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "fp8"])
@pytest.mark.parametrize("bs", [128, 32])
def test_slab_kernel_matches_plain(dev, dtype, bs):
    """One launch per call, the same bits twice, tickets back at 0."""
    rng = np.random.default_rng(3)
    shape = (3, 4, 8, 512, 128)
    k = _randn(rng, shape, torch.float32, dev).to(dtype)
    v = _randn(rng, shape, torch.float32, dev).to(dtype)
    before = slab_read.launches
    outs = [slab_read(k, v, layer_idx=1, seed=5, block_s=bs)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert slab_read.launches == before + 2
    assert torch.equal(outs[0], outs[1])
    assert not decode_module._tickets[outs[0].device].any()
    ref = slab_read_plain(k, v, layer_idx=1, seed=5, block_s=bs)
    torch.testing.assert_close(outs[0], ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bs", [128, 32])
def test_slab_kernel_int4_matches_plain(dev, bs):
    """The int4 read (packed payload and scale rows by bulk copies): one
    launch per call, the same bits twice, the plain version's checksum,
    tickets back at 0."""
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import stacked_cache
    gen = torch.Generator(device=dev).manual_seed(bs)
    shape = (3, 8, 8, 768)
    k, v = (torch.randint(0, 256, shape + (64,), generator=gen, device=dev,
                          dtype=torch.uint8) for _ in range(2))
    ks, vs = ((torch.rand(shape + (1,), generator=gen, device=dev) * 0.3
               + 0.01).bfloat16() for _ in range(2))
    before = (slab_read.launches, slab_read.launches_int4)
    outs = [slab_read(k, v, layer_idx=1, seed=5, block_s=bs, k_scale=ks,
                      v_scale=vs) for _ in range(2)]
    torch.cuda.synchronize()
    assert (slab_read.launches, slab_read.launches_int4) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(outs[0], outs[1])
    assert not decode_module._tickets[outs[0].device].any()
    ref = slab_read_plain(k, v, layer_idx=1, seed=5, block_s=bs, k_scale=ks,
                          v_scale=vs)
    torch.testing.assert_close(outs[0], ref, atol=1e-5, rtol=1e-5)
    # the probe's own int4 shape, at its B=96 S=512 layout
    cache = stacked_cache(96, 512, torch.int4, dev)
    out = slab_read(**cache, layer_idx=27, seed=1)
    torch.testing.assert_close(out, slab_read_plain(
        **cache, layer_idx=27, seed=1, block_s=128), atol=1e-5, rtol=1e-5)


def test_new_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((2, 4, 1, 128), device=dev, dtype=torch.float16)
    k = torch.zeros((2, 2, 128, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        decode_attention_batched(q, k, k)        # f16 q
    with pytest.raises(ValueError):
        decode_attention_batched(q.bfloat16(), k[None], k[None],
                                 layer_idx=1)     # one layer only
    with pytest.raises(ValueError):
        slab_read(k.float(), k.float())          # f32 cache


# -- the executables: CUDA graphs of the whole request ---------------------------

# preset:tiny's encoder into a 2-layer decoder at head_dim 128 (so B >= 2
# in bf16, and fp8 at any B, take kernel #3), weights at scale 0.2
SMALL = AsrConfig(
    encoder=dataclasses.replace(preset("tiny").encoder, output_dim=256),
    decoder=DecoderConfig(vocab_size=512, hidden_size=256,
                          intermediate_size=512, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          head_dim=128),
    pad_token_id=0)


def _model(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    dec = init_decoder_params(SMALL.decoder, gen, dev, torch.bfloat16)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        dec["layers"][k] *= 10
    params = {"encoder": init_encoder_params(SMALL.encoder, gen, dev,
                                             torch.bfloat16),
              "decoder": dec}
    return AsrModel(SMALL, params, preset_tokenizer(512))


def _request(eng, batch, seed=0, seconds=1.5):
    """The key and inputs of a ``batch``-row request in the 2 s bucket:
    noise clips of ``seconds`` and the default prompt."""
    rng = np.random.default_rng(seed)
    bf, bs = eng.bucket_frames(32000)
    audio = np.zeros((batch, bf * 160), np.float32)
    audio[:, :int(16000 * seconds)] = rng.standard_normal(
        (batch, int(16000 * seconds))) * 0.1
    prefix, vf = eng.padded_prefix(None, "", batch)
    return (bf, max_new_tokens_for(bs), batch), (audio, prefix, vf)


@pytest.mark.parametrize("batch,kv", [(1, torch.bfloat16),
                                      (8, torch.bfloat16),
                                      (8, torch.float8_e4m3fn)],
                         ids=["b1_bf16", "b8_bf16", "b8_fp8"])
def test_graph_replay_equals_eager_steps(dev, batch, kv):
    """The captured request gives the tokens, bit for bit, of the same
    functions run eagerly; B=1 bf16 decodes on kernel #2, B=8 on #3."""
    eng = TranscriptionEngine(_model(dev), device=dev, cache_dtype=kv)
    key, inputs = _request(eng, batch)
    exe, capture_s = eng.executable(*key)
    assert capture_s > 0 and exe.chunk.graph is not None
    kernel = "decode_attention" if batch == 1 else "decode_attention_batch"
    assert exe.chunk.recorded[kernel] == DECODE_CHUNK * 2
    # QK-norm + RoPE + the cache write: one launch a layer and step, and
    # one a layer for the prefill
    assert exe.chunk.recorded["qk_rope_kv"] == DECODE_CHUNK * 2
    assert exe.front.recorded["qk_rope_kv"] == 2
    graph = exe.run(*inputs)
    eager = exe.run(*inputs, eager=True)
    assert torch.equal(graph.tokens, eager.tokens)
    assert (graph.steps, graph.steps_run) == (eager.steps, eager.steps_run)
    assert len(set(graph.tokens[0].tolist())) >= 3


def test_warm_request_makes_no_eager_launch(dev):
    """A warm request is replays only: the wrappers' counters do not move,
    and the launches are recorded x replays, one flash launch per layer
    and one decode launch per layer and computed step."""
    eng = TranscriptionEngine(_model(dev), device=dev)
    key, (audio, _, _) = _request(eng, 1)
    eng._run_bucket([audio[0]], key[0], key[0] / 100, None)
    exe = eng.executables[key + (torch.bfloat16,)]
    exe.front.replays = exe.chunk.replays = 0
    before = graphs.kernel_launches()
    eng._run_bucket([audio[0]], key[0], key[0] / 100, None)
    assert graphs.kernel_launches() == before
    run = eng.last_run
    assert run["capture_s"] == 0.0
    assert run["replays"] == 1 + run["steps_run"] // DECODE_CHUNK
    got = graphs.launches([exe.front, exe.chunk],
                          dict.fromkeys(before, 0))
    layers = SMALL.encoder.encoder_layers + SMALL.decoder.num_hidden_layers
    assert got == {"flash_attention": layers,
                   "decode_attention": 2 * run["steps_run"],
                   "decode_attention_batch": 0,
                   "decode_attention_batch_int4": 0, "qgemv": 0,
                   "qgemm": 0, "widened_product": 0, "w8a8": 0,
                   "qk_rope_kv": 2 * (1 + run["steps_run"]),
                   "qk_rope_kv_per_row": 0}


# (working dtype, engine KV dtype)
STREAM_KEYS = {"f32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16),
               "bf16_int4": (torch.bfloat16, torch.int4)}


@pytest.mark.parametrize("name", list(STREAM_KEYS))
def test_stream_session_graphs_equal_eager(dev, name):
    """A prefix-mode session (``runtime/stream.py``) at a 4 s cap with
    chunk trims: its graphs give the eager run's ids on every tick; each
    rung's front records the segment prefill and the verify window (kernel
    B twice a layer), the chunk kernel B's per-row route once a layer and
    step; an int4 engine's session runs an fp8 cache through #3. In f32
    every tick's ids are also the fused resume path's."""
    dtype, kv = STREAM_KEYS[name]
    model = _model(dev)
    model.params = _cast_tree(model.params, dtype)
    eng = TranscriptionEngine(model, device=dev, dtype=dtype,
                              cache_dtype=kv)
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal(6 * 16000) * 0.1).astype(np.float32)
    chunk = eng.model.cfg.encoder.n_window * 2 * 160
    wins, w = [], np.zeros(0, np.float32)
    for off in range(0, len(audio), 7200):
        w = np.concatenate([w, audio[off:off + 7200]])
        if len(w) > 4 * 16000:
            w = w[-(-(len(w) - 4 * 16000) // chunk) * chunk:]
        wins.append(w)
    graph = eng.stream_session(4.0, "en")
    ids = [graph.update(x)[1] for x in wins]
    graph.release()
    eager = eng.stream_session(4.0, "en")
    eager.eager = True
    assert [eager.update(x)[1] for x in wins] == ids
    assert graph.stats["tail"] and graph.stats["full"]
    work = eager.work
    layers = SMALL.decoder.num_hidden_layers
    for g in work.fronts.values():
        assert g.recorded["qk_rope_kv"] == 2 * layers
    assert work.chunk.recorded["qk_rope_kv_per_row"] == 0
    assert work.chunk.recorded["qk_rope_kv"] == DECODE_CHUNK * layers
    decode = ("decode_attention_batch" if kv == torch.int4
              else "decode_attention")
    assert work.chunk.recorded[decode] == DECODE_CHUNK * layers
    assert eager.cache_dtype == (torch.float8_e4m3fn if kv == torch.int4
                                 else kv)
    if dtype == torch.float32:
        frames, bucket_s = eng.bucket_frames(4 * 16000)
        prev = []
        for x, want in zip(wins, ids):
            prev = eng._run_bucket([x], frames, bucket_s, "en",
                                   resume_tokens=prev)[1][0]
            assert prev == want


def _group_schedule(eng, eager: bool, cap_s: float = 4.0, slots: int = 4):
    """A fixed schedule of grouped ticks (``runtime/stream_group.py``):
    members a and c tick from the first cadence, b joins at the third, c
    leaves after the sixth and d takes its slot at the eighth; 450 ms
    appends of seeded noise, chunk trims at the cap. Returns (the group,
    every cadence's {member: ids}, every member's windows)."""
    from qwen3_asr_tpu_torch.runtime.stream_group import StreamGroup
    group = StreamGroup(eng, cap_s, slots)
    group.eager = eager
    chunk = eng.model.cfg.encoder.n_window * 2 * 160
    cap = int(cap_s * 16000)
    joins, leaves = {"a": 0, "c": 0, "b": 2, "d": 7}, {"c": 6}
    audio = {n: (np.random.default_rng(i).standard_normal(7 * 16000) * 0.1
                 ).astype(np.float32) for i, n in enumerate("abcd")}
    members, wins, out = {}, {}, []
    for cadence in range(12):
        for n, at in joins.items():
            if at == cadence:
                members[n] = group.attach_or_raise("en")
                wins[n] = [np.zeros(0, np.float32)]
        for n, at in leaves.items():
            if at == cadence:
                members.pop(n).release()
        reqs = []
        for n in sorted(members):
            k = cadence - joins[n]
            w = np.concatenate([wins[n][-1],
                                audio[n][k * 7200:(k + 1) * 7200]])
            if len(w) > cap:
                w = w[-(-(len(w) - cap) // chunk) * chunk:]
            wins[n].append(w)
            reqs.append((members[n], w))
        res = group.tick(reqs)
        out.append({n: ids for n, (_, ids) in zip(sorted(members), res)})
    for m in members.values():
        m.release()
    return group, out, {n: w[1:] for n, w in wins.items()}


# the group test also takes int8 weights (the JAX package's default
# serving row, which chip_smoke.py phase 14 (c) serves at full width)
GROUP_KEYS = dict(STREAM_KEYS, int8_int4=(torch.bfloat16, torch.int4))


@pytest.mark.parametrize("name", list(GROUP_KEYS))
def test_stream_group_graphs_equal_eager(dev, name):
    """A grouped session of 4 slots at a 4 s cap, with a join, a leave and
    a slot reused: its graphs give the eager run's ids on every tick; each
    rung's front records the segment prefill and the verify window (flash
    and kernel B twice a layer), the chunk kernel B's per-row route and
    the decode kernel (#3; #2 for an f32 cache) once a layer and step; an
    int4 engine's group runs an fp8 cache. In f32 each member's ids are
    also a solo session's on its windows."""
    dtype, kv = GROUP_KEYS[name]
    model = _model(dev)
    model.params = _cast_tree(model.params, dtype)
    if name.startswith("int8"):
        model.params = quant.quantize_params(model.params, "int8")
    eng = TranscriptionEngine(model, device=dev, dtype=dtype,
                              cache_dtype=kv)
    group, ids, wins = _group_schedule(eng, eager=False)
    _, eager, _ = _group_schedule(eng, eager=True)
    assert eager == ids
    assert any(len(set(v)) >= 3 for c in ids for v in c.values())
    work = group.work
    assert group.cache_dtype == (torch.float8_e4m3fn if kv == torch.int4
                                 else kv)
    assert work.loop.cache.k.dtype == group.cache_dtype
    layers = SMALL.decoder.num_hidden_layers
    for g in work.fronts.values():
        assert g.recorded["qk_rope_kv"] == 2 * layers
        assert g.recorded["flash_attention"] == 2 * layers
    assert work.chunk.recorded["qk_rope_kv"] == DECODE_CHUNK * layers
    assert work.chunk.recorded["qk_rope_kv_per_row"] == DECODE_CHUNK * layers
    decode = ("decode_attention" if kv == torch.float32
              else "decode_attention_batch")
    assert work.chunk.recorded[decode] == DECODE_CHUNK * layers
    if dtype == torch.float32:
        for n, ws in wins.items():
            sess = eng.stream_session(4.0, "en")
            assert [sess.update(w)[1] for w in ws] == [
                c[n] for c in ids if n in c], n
            sess.release()


def test_warm_group_tick_makes_no_eager_launch(dev):
    """A warm group tick is replays only: the wrappers' counters do not
    move, and its launches are what the captures recorded times their
    replays (flash in the block encoders and twice a layer in the front,
    #3 and kernel B's per-row route once a layer and step)."""
    eng = TranscriptionEngine(_model(dev), device=dev)
    _group_schedule(eng, eager=False)       # builds every graph it meets
    built = eng.stream_graphs()
    for g in built:
        g.replays = 0
    before = graphs.kernel_launches()
    group, _, _ = _group_schedule(eng, eager=False)
    assert graphs.kernel_launches() == before
    assert eng.stream_graphs() == built
    got = graphs.launches(built, dict.fromkeys(before, 0))
    layers = SMALL.decoder.num_hidden_layers
    steps = group.work.chunk.replays * DECODE_CHUNK
    fronts = sum(g.replays for g in group.work.fronts.values())
    assert fronts >= 12 and steps > 0
    assert got["decode_attention_batch"] == layers * steps
    assert got["qk_rope_kv_per_row"] == layers * steps
    assert got["qk_rope_kv"] == 2 * layers * fronts + layers * steps
    assert got["flash_attention"] > 2 * layers * fronts
    assert got["widened_product"] == 0 and got["decode_attention"] == 0


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


# (working dtype, cache dtype, batch)
RESUME_KEYS = {"f32_b1": (torch.float32, torch.float32, 1),
               "f32_b4": (torch.float32, torch.float32, 4),
               "f32_fp8_b4": (torch.float32, torch.float8_e4m3fn, 4),
               "bf16_b1": (torch.bfloat16, torch.bfloat16, 1),
               "bf16_b4": (torch.bfloat16, torch.bfloat16, 4),
               "bf16_fp8_b4": (torch.bfloat16, torch.float8_e4m3fn, 4),
               "bf16_int4_b4": (torch.bfloat16, torch.int4, 4)}


@pytest.mark.parametrize("name", list(RESUME_KEYS))
def test_resume_key_replays_equal_eager(dev, name):
    """A resume key (the front adds the verify window and the accept
    arithmetic, the chunk the per-row continuation) gives the same bits
    captured and eager, and its chunk writes through kernel B's per-row
    route at B > 1. In f32 each row's tokens are also a plain run's of its
    clip (resume is exact there, as the CPU tests hold it against JAX); in
    bf16 the verify window's products round apart from a decode step's, so
    a near-tie may flip a token, and the share that agrees is printed."""
    dtype, kv, batch = RESUME_KEYS[name]
    model = _model(dev)
    model.params = _cast_tree(model.params, dtype)
    eng = TranscriptionEngine(model, device=dev, dtype=dtype,
                              cache_dtype=kv)
    key, (audio, _, _) = _request(eng, batch, seed=5)
    clips = list(audio[:, :24000])
    plain = [eng._run_bucket([c], key[0], key[0] / 100, None)[1][0]
             for c in clips]
    # drafts: a row's own output, nothing, garbage, a truncated own output
    rows = [plain[0], None, [5, 9, 2, 7], plain[-1][:3]][:batch]
    _, ids = eng._run_bucket(clips, key[0], key[0] / 100, None,
                             resume_rows=rows)
    if dtype == torch.float32:
        assert ids == plain
    print(f"resume {name}: rows equal to the plain run "
          f"{sum(a == b for a, b in zip(ids, plain))}/{batch}")
    exe = eng.executables[key[:2] + (batch, kv, "resume")]
    assert exe.chunk.recorded["qk_rope_kv_per_row"] == (
        DECODE_CHUNK * 2 if batch > 1 else 0)
    assert exe.front.recorded["qk_rope_kv"] == 2 * 2    # prompt, verify
    inputs = eng.bucket_inputs(clips, key[0], None)
    prev = np.full((batch, key[1]), eng.model.pad_id, np.int32)
    prev_len = np.zeros(batch, np.int32)
    for i, r in enumerate(rows):
        prev[i, :len(r or [])] = r or []
        prev_len[i] = len(r or [])
    graph = exe.run(*inputs, prev=prev, prev_len=prev_len)
    eager = exe.run(*inputs, eager=True, prev=prev, prev_len=prev_len)
    assert torch.equal(graph.tokens, eager.tokens)
    assert torch.equal(graph.steps, eager.steps)
    assert torch.equal(graph.accepted, eager.accepted)
    again = exe.run(*inputs, prev=prev, prev_len=prev_len)
    assert torch.equal(graph.tokens, again.tokens)


def test_failed_capture_raises_and_never_runs_eagerly(dev, monkeypatch):
    """A capture that fails raises out of the request; the engine keeps no
    executable for the key and runs nothing eagerly beyond the warm-up
    runs before the captures."""
    chunk = GreedyLoop.chunk

    def failing(self):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("capture made to fail")
        chunk(self)

    monkeypatch.setattr(GreedyLoop, "chunk", failing)
    eng = TranscriptionEngine(_model(dev), device=dev)
    key, (audio, _, _) = _request(eng, 1)
    before = graphs.kernel_launches()
    with pytest.raises(RuntimeError, match="capture made to fail"):
        eng._run_bucket([audio[0]], key[0], key[0] / 100, None)
    torch.cuda.synchronize()
    assert not eng.executables
    after = graphs.kernel_launches()
    layers = SMALL.encoder.encoder_layers + SMALL.decoder.num_hidden_layers
    # front: warm-up and capture; chunk: warm-up only
    assert after["flash_attention"] - before["flash_attention"] == 2 * layers
    assert (after["decode_attention"] - before["decode_attention"]
            == DECODE_CHUNK * SMALL.decoder.num_hidden_layers)


def test_reused_key_and_tickets_after_replays(dev):
    """Two requests on one key give a fresh engine's tokens (the cache is
    never read stale), and every ticket is back at 0 after the replays."""
    eng = TranscriptionEngine(_model(dev), device=dev,
                              cache_dtype=torch.float8_e4m3fn)
    key, first = _request(eng, 8, seed=1, seconds=1.9)
    _, second = _request(eng, 8, seed=2, seconds=0.6)
    exe, _ = eng.executable(*key)
    exe.run(*first)
    reused = exe.run(*second)
    fresh = TranscriptionEngine(_model(dev), device=dev,
                                cache_dtype=torch.float8_e4m3fn)
    again = fresh.executable(*key)[0].run(*second)
    assert torch.equal(reused.tokens, again.tokens)
    torch.cuda.synchronize()
    assert not decode_module._tickets[torch.device("cuda", 0)].any()


# -- quantized weights and the int4 KV cache -------------------------------------

from qwen3_asr_tpu_torch.ops import quant                      # noqa: E402
from qwen3_asr_tpu_torch.ops.kv_int4 import pack, unpack       # noqa: E402
from qwen3_asr_tpu_torch.ops.qgemm import (qgemm, qgemm_group,  # noqa: E402
                                           qgemm_plain, qgemm_plan)
from qwen3_asr_tpu_torch.ops.qgemv import (qgemv, qgemv_group,  # noqa: E402
                                           qgemv_plain)
from qwen3_asr_tpu_torch.models.decoder import init_kv_cache   # noqa: E402

# (K, N) of every preset:1.7b decoder projection, the tied lm_head, the
# decoder's two grouped launches (q/k/v, gate/up: one N a payload), and a
# K that splits at every row count
QGEMV_SHAPES = {"wq_wo": (2048, 2048), "wk_wv": (2048, 1024),
                "gate_up": (2048, 6144), "down": (6144, 2048),
                "encoder_fc1": (1280, 5120), "lm_head": (2048, 151936),
                "long_k": (12288, 1024),
                "qkv_group": (2048, (2048, 1024, 1024)),
                "gate_up_group": (2048, (6144, 6144))}


def _qgemv_leaves(rng, shape, mode, dev):
    """The payload leaves of a QGEMV_SHAPES entry, and its output dtype
    (int4: the default group of 128, G = 1 at the tied lm_head)."""
    k, n = QGEMV_SHAPES[shape]
    leaves = []
    for width in (n if isinstance(n, tuple) else (n,)):
        w = _randn(rng, (k, width), torch.float32, dev) * 0.02
        leaves.append(quant.quantize_embed(w.t().bfloat16(), mode)
                      if shape == "lm_head"
                      else quant.quantize_array(w.bfloat16(), mode))
    return leaves, torch.float32 if shape == "lm_head" else torch.bfloat16


def _qgemv_call(x, leaves, out_dtype):
    """One launch: ``qgemv`` for one leaf, ``qgemv_group`` for more."""
    pairs = [(leaf["q"], quant.row_scales(leaf)) for leaf in leaves]
    if len(pairs) == 1:
        return [qgemv(x, *pairs[0], out_dtype=out_dtype)]
    return qgemv_group(x, pairs, out_dtype=out_dtype)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("shape", list(QGEMV_SHAPES))
def test_qgemv_matches_plain(dev, shape, mode):
    """Kernel A against its plain version (the payload widened, an f32
    product, the scale, one rounding) at M = 1..16, one launch a call,
    grouped payloads included. Both sum in f32 in different orders: bf16
    layer outputs within one bf16 ulp (rtol 8e-3), f32 logits within 1e-4
    of the largest |plain| value, and both within that atol near zero."""
    rng = np.random.default_rng(7)
    leaves, out_dtype = _qgemv_leaves(rng, shape, mode, dev)
    k = QGEMV_SHAPES[shape][0]
    for m in range(1, 17):
        x = _randn(rng, (m, k), torch.bfloat16, dev)
        before = qgemv.launches
        outs = _qgemv_call(x, leaves, out_dtype)
        torch.cuda.synchronize()
        assert qgemv.launches == before + 1
        for out, leaf in zip(outs, leaves):
            assert out.dtype == out_dtype
            ref = qgemv_plain(x, leaf["q"], quant.row_scales(leaf),
                              out_dtype=out_dtype)
            rtol = 8e-3 if out_dtype == torch.bfloat16 else 0.0
            torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                       atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_qgemv_widens_every_payload_value_exactly(dev, mode):
    """Every payload byte (all 256 int8 values; every e4m3 value but the
    two NaNs, subnormals included; all 16 int4 values in either nibble)
    against a one-hot x at each k of a stretch: the output is the widened
    value times its scale, exactly. int4: row r holds r - 8 in both
    nibbles, and k runs over both halves of the row (128 k, one
    stretch)."""
    if mode == "int4":
        n, k = 16, 128
        byte = torch.arange(16, dtype=torch.uint8) * 17      # r | r << 4
        q = byte.reshape(n, 1).expand(n, k // 2).contiguous().to(dev)
        s = torch.ones((n, 1), dtype=torch.float32, device=dev)
        want = (torch.arange(16) - 8).float().to(dev)
        for hot in range(k):
            x = torch.zeros((1, k), dtype=torch.bfloat16, device=dev)
            x[0, hot] = 1.0
            for fn in (qgemv, qgemm):
                out = fn(x.expand(17 if fn is qgemm else 1, k).contiguous(),
                         q, s, out_dtype=torch.float32)
                torch.cuda.synchronize()
                assert torch.equal(out[0], want), (fn.__name__, hot)
        return
    if mode == "int8":
        vals = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    else:
        bits = torch.tensor([b for b in range(256) if b & 0x7F != 0x7F],
                            dtype=torch.uint8)
        vals = bits.view(torch.float8_e4m3fn)
    n, k = vals.numel(), 64
    # row r holds value r at every k: the product with a one-hot x is it
    q = vals.reshape(n, 1).expand(n, k).contiguous().to(dev)
    s = torch.full((n,), 1.0, dtype=torch.float32, device=dev)
    want = vals.float().to(dev)
    for hot in range(k):
        x = torch.zeros((1, k), dtype=torch.bfloat16, device=dev)
        x[0, hot] = 1.0
        out = qgemv(x, q, s, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want), hot


@pytest.mark.parametrize("shape", ["wk_wv", "down", "long_k",
                                   "qkv_group", "lm_head"])
def test_qgemv_is_deterministic(dev, shape):
    """20 calls give the same bits (split K adds its splits in a fixed
    order; no float atomics), at 1, 8 and 16 rows."""
    rng = np.random.default_rng(11)
    leaves, out_dtype = _qgemv_leaves(rng, shape, "int8", dev)
    for m in (1, 8, 16):
        x = _randn(rng, (m, QGEMV_SHAPES[shape][0]), torch.bfloat16, dev)
        runs = [_qgemv_call(x, leaves, out_dtype) for _ in range(20)]
        torch.cuda.synchronize()
        for outs in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(outs, runs[0]))


@pytest.mark.parametrize("shape,m,splits", [("down", 16, 3),
                                             ("long_k", 1, 6),
                                             ("long_k", 8, 6)])
def test_qgemv_split_k_leaves_tickets_at_zero(dev, shape, m, splits):
    """A call that splits K (w_down at 16 rows, K = 12288 at any) takes
    one ticket per column group and leaves every ticket at zero, in a CUDA
    graph's replays too."""
    from qwen3_asr_tpu_torch.ops.qgemv import plan
    rng = np.random.default_rng(12)
    leaves, out_dtype = _qgemv_leaves(rng, shape, "fp8", dev)
    k, n = QGEMV_SHAPES[shape]
    x = _randn(rng, (m, k), torch.bfloat16, dev)
    assert plan(m, n, k).splits == splits
    eager = _qgemv_call(x, leaves, out_dtype)[0]
    torch.cuda.synchronize()
    tickets = decode_module._tickets[eager.device]
    assert not tickets.any()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _qgemv_call(x, leaves, out_dtype)[0]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert not tickets.any() and torch.equal(out, eager)


# Kernel C, the quantized GEMM: (K, N) of every preset:1.7b decoder and
# encoder product and the tied lm_head (f32 logits), at the rows it takes
QGEMM_SHAPES = {"wq_wo": (2048, 2048), "wk_wv": (2048, 1024),
                "gate_up": (2048, 6144), "down": (6144, 2048),
                "enc_attn": (1280, 1280), "enc_fc1": (1280, 5120),
                "enc_fc2": (5120, 1280), "lm_head": (2048, 151936),
                "qkv_group": (2048, (2048, 1024, 1024)),
                "gate_up_group": (2048, (6144, 6144)),
                "enc_qkv_group": (1280, (1280, 1280, 1280))}
# the front graph's rows (375 and 1000: the encoder at B=1 and B=8; 453 and
# 1624: the prompt), and two below them
QGEMM_ROWS = (17, 64, 375, 453, 1000, 1624)


def _qgemm_leaf(rng, shape, mode, dev):
    """The leaf of a single QGEMM_SHAPES entry, and its output dtype."""
    leaves, out_dtype = _qgemm_leaves(rng, shape, mode, dev)
    return leaves[0], out_dtype


def _qgemm_leaves(rng, shape, mode, dev):
    k, n = QGEMM_SHAPES[shape]
    leaves = []
    for width in (n if isinstance(n, tuple) else (n,)):
        w = _randn(rng, (k, width), torch.float32, dev) * 0.02
        leaves.append(quant.quantize_embed(w.t().bfloat16(), mode)
                      if shape == "lm_head"
                      else quant.quantize_array(w.bfloat16(), mode))
    return leaves, torch.float32 if shape == "lm_head" else torch.bfloat16


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("shape", list(QGEMM_SHAPES))
def test_qgemm_matches_plain(dev, shape, mode):
    """Kernel C against its plain version (``widened_product``; for int4
    JAX's grouped product restated in f32) at 17, 64, 375, 453, 1000 and
    1624 rows (the lm_head at 17 and 64), one launch a call (q/k/v and
    gate/up as one grouped launch), whatever x width and K split the plan
    takes (enc fc2 at 375 rows: four splits). Both sum in f32 in
    different orders: kernel A's bound, bf16 outputs within one bf16 ulp
    (rtol 8e-3), f32 logits within 1e-4 of the largest |plain| value, and
    both within that atol near zero."""
    rng = np.random.default_rng(17)
    leaves, out_dtype = _qgemm_leaves(rng, shape, mode, dev)
    pairs = [(leaf["q"], quant.row_scales(leaf)) for leaf in leaves]
    k = QGEMM_SHAPES[shape][0]
    ns = [q.shape[0] for q, _ in pairs]
    ngroups = pairs[0][1].numel() // ns[0]
    if shape == "enc_fc2":
        assert qgemm_plan(375, ns, k, pairs[0][0].dtype, ngroups).splits > 1
    for m in QGEMM_ROWS:
        if shape == "lm_head" and m > 64:
            continue
        x = _randn(rng, (m, k), torch.bfloat16, dev)
        before = qgemm.launches
        outs = (qgemm_group(x, pairs, out_dtype=out_dtype) if len(pairs) > 1
                else [qgemm(x, *pairs[0], out_dtype=out_dtype)])
        torch.cuda.synchronize()
        assert qgemm.launches == before + 1
        for out, (q, s) in zip(outs, pairs):
            assert out.dtype == out_dtype
            ref = qgemm_plain(x, q, s, out_dtype=out_dtype)
            rtol = 8e-3 if out_dtype == torch.bfloat16 else 0.0
            torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                       atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_kernels_are_deterministic(dev, mode):
    """Kernels A and C give the same bits on 20 calls and under CUDA-graph
    replay, and leave every ticket at 0: A at 1, 8 and 16 rows over
    K = 12288 (split K), C at 453 rows of w_down and 375 rows of enc fc2
    (both split K, one launch a call: the last block of a tile adds the
    splits in order) and 1000 rows of enc fc1 (not split); int4 with group
    scales."""
    rng = np.random.default_rng(19)
    leaves, _ = _qgemv_leaves(rng, "long_k", mode, dev)
    pair = (leaves[0]["q"], quant.row_scales(leaves[0]))
    calls = [(qgemv, _randn(rng, (m, 12288), torch.bfloat16, dev), pair)
             for m in (1, 8, 16)]
    for shape, m, split in (("down", 453, True), ("enc_fc2", 375, True),
                            ("enc_fc1", 1000, False)):
        cleaf, _ = _qgemm_leaf(rng, shape, mode, dev)
        cpair = (cleaf["q"], quant.row_scales(cleaf))
        k, n = QGEMM_SHAPES[shape]
        plan = qgemm_plan(m, [n], k, cpair[0].dtype,
                          cpair[1].numel() // n)
        assert (plan.splits > 1) == split, (shape, plan)
        calls.append((qgemm, _randn(rng, (m, k), torch.bfloat16, dev),
                      cpair))
    for fn, x, (q, s) in calls:
        runs = [fn(x, q, s, out_dtype=torch.bfloat16) for _ in range(20)]
        torch.cuda.synchronize()
        assert all(torch.equal(r, runs[0]) for r in runs[1:])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(x, q, s, out_dtype=torch.bfloat16)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, runs[0])
        assert not decode_module._tickets[x.device].any()


def test_quantized_kernels_refuse_what_they_do_not_take(dev):
    """Kernels A and C raise, never compute, for an f32 x, a non-contiguous
    payload, an int4 group layout they do not take (groups of 32: half a
    stretch), int4 scales that do not match the payload, and x of another
    K; kernel A also past 16 rows."""
    rng = np.random.default_rng(20)
    leaf = quant.quantize_array(
        (_randn(rng, (256, 64), torch.float32, dev) * 0.02).bfloat16(),
        "int4")
    q, s = leaf["q"], quant.row_scales(leaf)
    assert s.shape == (64, 2)
    xb = torch.zeros((20, 256), device=dev, dtype=torch.bfloat16)
    for fn, rows in ((qgemv, 4), (qgemm, 20)):
        x = xb[:rows]
        with pytest.raises(ValueError, match="bf16"):
            fn(x.float(), q, s, out_dtype=torch.bfloat16)
        wide = torch.zeros((64, 256), dtype=torch.uint8, device=dev)
        with pytest.raises(ValueError, match="contiguous"):
            fn(x, wide[:, ::2], s, out_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="multiples of 64"):
            fn(x, q, torch.ones((64, 8), device=dev), out_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="do not match"):
            fn(x, q, torch.ones((63, 2), device=dev), out_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="do not match"):
            fn(xb[:rows, :128].contiguous(), q, s, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows"):
        qgemv(xb[:17].contiguous(), q, s, out_dtype=torch.bfloat16)


def _int4_cache(dev, b, t, layers=3, s_len=256):
    cfg = DecoderConfig(vocab_size=8, hidden_size=8, intermediate_size=8,
                        num_hidden_layers=layers, num_attention_heads=16,
                        num_key_value_heads=8, head_dim=128)
    return cfg, [init_kv_cache(cfg, b, s_len, torch.int4, dev)
                 for _ in range(2)]


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_int4_batched_decode_matches_plain(dev, name):
    """#3's int4 route against its plain version (the same max per chunk,
    p * vs rounded to bf16 at the same point), bf16 tolerance."""
    n_layers, b, nq, nkv, s, layer, vf, vt = BATCH_CASES[name]
    lead = ((n_layers,) if n_layers else ()) + (b, nkv, s)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, nq, 1, 128), generator=gen, device=dev).bfloat16()
    kq, vq = (pack(torch.randint(-8, 8, lead + (128,), generator=gen,
                                 device=dev, dtype=torch.int8))
              for _ in range(2))
    ks, vs = ((torch.rand(lead + (1,), generator=gen, device=dev) * 0.3
               + 0.01).bfloat16() for _ in range(2))
    vf = torch.tensor(vf, dtype=torch.int32, device=dev)
    vt = torch.tensor(vt, dtype=torch.int32, device=dev)
    before = decode_attention_batched.launches_int4
    out = decode_attention_batched(q, kq, vq, layer_idx=layer,
                                   kv_valid_from=vf, kv_valid_to=vt,
                                   k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert decode_attention_batched.launches_int4 == before + 1
    ref = decode_attention_batched_plain(q, kq, vq, vf, vt, layer_idx=layer,
                                         sm_scale=128 ** -0.5, k_scale=ks,
                                         v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    dead = (torch.minimum(vt, torch.tensor(s, device=dev))
            <= vf.clamp(min=0))
    assert not out[dead].float().abs().any()
    assert not decode_module._tickets[out.device].any()


def test_quantized_wrappers_raise_rather_than_compute(dev):
    """On a CUDA tensor a wrapper launches its kernel or raises: f32
    activations for kernel A (and ``qdot``, which has no other route for
    decode rows on the card; the engine refuses quantized weights at f32
    there), head_dim 64 for the int4 cache write, f32 q for the int4
    route, a packed cache without its scale planes."""
    q8 = torch.zeros((64, 128), dtype=torch.int8, device=dev)
    s = torch.ones(64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        qgemv(torch.zeros((2, 128), device=dev), q8, s,
              out_dtype=torch.float32)
    with pytest.raises(ValueError):
        qgemv(torch.zeros((17, 128), device=dev, dtype=torch.bfloat16), q8,
              s, out_dtype=torch.bfloat16)
    leaf = quant.quantize_array(torch.ones((128, 64), device=dev), "int8")
    with pytest.raises(ValueError, match="bf16"):
        quant.qdot(torch.zeros((2, 128), device=dev), leaf)
    model = _model(dev)
    model.params = quant.quantize_params(model.params, "int8")
    with pytest.raises(ValueError, match="bf16"):
        TranscriptionEngine(model, device=dev, dtype=torch.float32)
    cfg = DecoderConfig(vocab_size=8, hidden_size=8, intermediate_size=8,
                        num_hidden_layers=1, num_attention_heads=2,
                        num_key_value_heads=1, head_dim=64)
    cache = init_kv_cache(cfg, 1, 128, torch.int4, dev)
    x = torch.zeros((1, 1, 64), device=dev, dtype=torch.bfloat16)
    w = torch.ones(64, device=dev, dtype=torch.bfloat16)
    cs = torch.ones((1, 1, 64), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        qk_rope_kv_write(torch.cat([x, x], -1), x, x, w, w, cs, cs, 1e-6,
                         cache, 0, 0)
    _, (c4, _) = _int4_cache(dev, 2, 1)
    with pytest.raises(ValueError):
        decode_attention_batched(torch.zeros((2, 16, 1, 128), device=dev),
                                 c4.k, c4.v, layer_idx=0, k_scale=c4.k_scale,
                                 v_scale=c4.v_scale)
    with pytest.raises(ValueError):
        decode_attention_batched(torch.zeros((2, 16, 1, 128), device=dev,
                                             dtype=torch.bfloat16),
                                 c4.k, c4.v, layer_idx=0)


@pytest.mark.parametrize("batch", [1, 8], ids=["b1", "b8"])
def test_int8_int4_graph_replay_equals_eager(dev, batch):
    """An int8-weight, int4-cache key: the captured request gives the
    eager run's tokens bit for bit, and a chunk records four GEMV
    launches per layer and step (q/k/v and gate/up grouped; plus the
    logits), one int4 write and one #3-int4
    launch per layer and step."""
    model = _model(dev)
    model.params = quant.quantize_params(model.params, "int8")
    eng = TranscriptionEngine(model, device=dev, cache_dtype=torch.int4)
    key, inputs = _request(eng, batch)
    exe, _ = eng.executable(*key)
    layers = SMALL.decoder.num_hidden_layers
    rec = exe.chunk.recorded
    assert rec["decode_attention_batch_int4"] == DECODE_CHUNK * layers
    assert rec["qk_rope_kv"] == DECODE_CHUNK * layers
    assert exe.front.recorded["qk_rope_kv"] == layers
    # q/k/v and gate/up one grouped launch each, wo, w_down, the logits
    assert rec["qgemv"] == DECODE_CHUNK * (4 * layers + 1)
    assert rec["decode_attention"] == rec["decode_attention_batch"] == 0
    graph = exe.run(*inputs)
    eager = exe.run(*inputs, eager=True)
    assert torch.equal(graph.tokens, eager.tokens)
    assert (graph.steps, graph.steps_run) == (eager.steps, eager.steps_run)
    assert len(set(graph.tokens[0].tolist())) >= 3


@pytest.mark.parametrize("batch", [1, 8], ids=["b1", "b8"])
def test_int4_weights_graph_replay_equals_eager(dev, batch):
    """An int4-weight, int4-cache key (QUANTIZE=int4, the default group):
    the captured request gives the eager run's tokens bit for bit; a chunk
    records kernel A's int4 route on every decode product and the logits
    (4 launches a layer and step, plus one) and no GEMM; the front records
    kernel C on every prompt and encoder product (4 launches a layer: q/k/v
    grouped, wo, gate/up grouped or fc1, w_down or fc2); no graph calls
    ``widened_product``."""
    model = _model(dev)
    model.params = quant.quantize_params(model.params, "int4")
    assert quant.is_packed_int4(model.params["decoder"]["layers"]["wq"])
    eng = TranscriptionEngine(model, device=dev, cache_dtype=torch.int4)
    key, inputs = _request(eng, batch)
    exe, _ = eng.executable(*key)
    layers = SMALL.decoder.num_hidden_layers
    rec, front = exe.chunk.recorded, exe.front.recorded
    assert rec["qgemv"] == DECODE_CHUNK * (4 * layers + 1)
    enc_layers = SMALL.encoder.encoder_layers
    assert rec["qgemm"] == 0
    assert front["qgemm"] == 4 * (layers + enc_layers)
    assert rec["widened_product"] == front["widened_product"] == 0
    assert rec["decode_attention_batch_int4"] == DECODE_CHUNK * layers
    graph = exe.run(*inputs)
    eager = exe.run(*inputs, eager=True)
    assert torch.equal(graph.tokens, eager.tokens)
    assert (graph.steps, graph.steps_run) == (eager.steps, eager.steps_run)
    assert len(set(graph.tokens[0].tolist())) >= 3


def test_int4_layout_the_kernels_refuse_is_refused_at_load(dev,
                                                           monkeypatch):
    """An int4 group the kernels do not take (32: half a stretch) is
    refused when the engine is built on the card, not at a request."""
    monkeypatch.setenv("ASR_INT4_GROUP", "32")
    model = _model(dev)
    model.params = quant.quantize_params(model.params, "int4")
    with pytest.raises(ValueError, match="ASR_INT4_GROUP"):
        TranscriptionEngine(model, device=dev)


def test_int4_batched_decode_is_deterministic(dev):
    """#3's int4 route at 128-key chunks (B=8, S=384): the same bits on
    every call (the softmax reads V's scales: they must have landed)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    lead = (2, 8, 8, 384)
    q = torch.randn((8, 16, 1, 128), generator=gen, device=dev).bfloat16()
    kq, vq = (pack(torch.randint(-8, 8, lead + (128,), generator=gen,
                                 device=dev, dtype=torch.int8))
              for _ in range(2))
    ks, vs = ((torch.rand(lead + (1,), generator=gen, device=dev) + 0.01
               ).bfloat16() for _ in range(2))
    vf = torch.zeros(8, dtype=torch.int32, device=dev)
    vt = torch.full((8,), 300, dtype=torch.int32, device=dev)
    outs = [decode_attention_batched(q, kq, vq, layer_idx=1,
                                     kv_valid_from=vf, kv_valid_to=vt,
                                     k_scale=ks, v_scale=vs)
            for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    ref = decode_attention_batched_plain(q, kq, vq, vf, vt, layer_idx=1,
                                         sm_scale=128 ** -0.5, k_scale=ks,
                                         v_scale=vs)
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


# -- QK-norm + RoPE + the KV-cache write -----------------------------------------

from qwen3_asr_tpu_torch.models.decoder import rope_cos_sin   # noqa: E402
from qwen3_asr_tpu_torch.ops.qk_rope_kv import (              # noqa: E402
    qk_rope_kv_write, qk_rope_kv_write_plain)

QK_SHAPES = {
    # (b, t, nq, nkv, d, s_len, position, a device position?)
    "1p7b_b1_step": (1, 1, 16, 8, 128, 768, 500, True),
    "1p7b_b8_step": (8, 1, 16, 8, 128, 768, 500, True),
    "1p7b_b96_step": (96, 1, 16, 8, 128, 512, 300, True),
    "1p7b_prefill_30s": (1, 453, 16, 8, 128, 768, 0, False),
    "small_b2_step": (2, 1, 4, 2, 128, 256, 17, True),
    "small_prefill": (2, 70, 4, 2, 128, 256, 0, False),
    "ckpt_d48_step": (2, 1, 4, 2, 48, 128, 40, True),
    "ckpt_d48_prefill": (1, 90, 4, 2, 48, 128, 0, False),
}
# (rows dtype, cache dtype)
QK_ROUTES = {"bf16": (torch.bfloat16, torch.bfloat16),
             "bf16_fp8": (torch.bfloat16, torch.float8_e4m3fn),
             "bf16_int4": (torch.bfloat16, torch.int4),
             "f32": (torch.float32, torch.float32),
             "f32_fp8": (torch.float32, torch.float8_e4m3fn),
             "f32_int4": (torch.float32, torch.int4)}
QK_CASES = [(shape, route) for shape in QK_SHAPES for route in QK_ROUTES
            if QK_SHAPES[shape][4] == 128 or "int4" not in route]
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float8_e4m3fn: torch.int8}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their dtype (f32, bf16 or fp8
    e4m3fn), from the bit patterns: a difference of 1 is one ulp."""
    def key(x):
        bits = x.contiguous().view(_INT_VIEW[x.dtype]).long()
        mag = bits & ((1 << (8 * x.element_size() - 1)) - 1)
        return torch.where(bits < 0, -mag, mag)
    return (key(a) - key(b)).abs()


def _qk_inputs(dev, b, t, nq, nkv, d, rows, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=2.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(rows)

    q, k, v = rnd(b, t, nq * d), rnd(b, t, nkv * d), rnd(b, t, nkv * d)
    q_norm, k_norm = rnd(d, scale=0.2, shift=1.0), rnd(d, scale=0.2,
                                                       shift=1.0)
    positions = torch.randint(0, 4000, (b, t), generator=gen, device=dev)
    cos, sin = rope_cos_sin(positions, d, 1e6)
    return q, k, v, q_norm, k_norm, cos, sin


def _qk_caches(dev, b, nkv, d, s_len, kv, n=2):
    cfg = DecoderConfig(vocab_size=8, hidden_size=8, intermediate_size=8,
                        num_hidden_layers=3, num_attention_heads=nkv,
                        num_key_value_heads=nkv, head_dim=d)
    return [init_kv_cache(cfg, b, s_len, kv, dev) for _ in range(n)]


def _assert_cache_close(ours, ref, what=""):
    """Working-dtype K/V within one ulp; fp8 V bytes equal and K within one
    fp8 ulp; int4 V payload and scales equal, K's nibbles within 1 and its
    scales within one bf16 ulp. Returns the share of K's values that is
    bit-equal."""
    if ours.int4:
        k_n, k_ref = unpack(ours.k).int(), unpack(ref.k).int()
        assert (k_n - k_ref).abs().max() <= 1, f"{what} K nibbles"
        assert _ulps(ours.k_scale, ref.k_scale).max() <= 1, f"{what} K scale"
        assert torch.equal(ours.v, ref.v), f"{what} V payload"
        assert torch.equal(ours.v_scale.view(torch.int16),
                           ref.v_scale.view(torch.int16)), f"{what} V scale"
        return float((k_n == k_ref).float().mean())
    assert _ulps(ours.k, ref.k).max() <= 1, f"{what} K"
    if ours.v.dtype == torch.float8_e4m3fn:
        assert torch.equal(ours.v.view(torch.uint8), ref.v.view(torch.uint8))
    else:
        assert _ulps(ours.v, ref.v).max() <= 1, f"{what} V"
    return float((_ulps(ours.k, ref.k) == 0).float().mean())


@pytest.mark.parametrize("shape,route", QK_CASES)
def test_qk_rope_kv_matches_plain(dev, shape, route):
    """One launch: q within one ulp of the plain chain's (rms_norm ->
    apply_rope on the card), the cache as ``_assert_cache_close`` holds
    it, the rest of the stacked cache untouched; the share of bit-equal
    values is printed."""
    b, t, nq, nkv, d, s_len, pos, on_device = QK_SHAPES[shape]
    rows, kv = QK_ROUTES[route]
    inputs = _qk_inputs(dev, b, t, nq, nkv, d, rows)
    ours, ref = _qk_caches(dev, b, nkv, d, s_len, kv)
    where = torch.tensor(pos, device=dev) if on_device else pos
    before = qk_rope_kv_write.launches
    q = qk_rope_kv_write(*inputs, 1e-6, ours, 2, where)
    torch.cuda.synchronize()
    assert qk_rope_kv_write.launches == before + 1
    q_ref = qk_rope_kv_write_plain(*inputs, 1e-6, ref, 2, where)
    assert q.shape == q_ref.shape and q.is_contiguous()
    assert _ulps(q, q_ref).max() <= 1
    k_share = _assert_cache_close(ours, ref)
    q_share = float((_ulps(q, q_ref) == 0).float().mean())
    print(f"qk_rope_kv {shape} {route}: bit-equal q {q_share:.4%}, "
          f"K {k_share:.4%}")


# one write position a row (the resume loop's continuation and verify):
# (b, t, s_len, positions), distinct per row; a row at S writes nothing
QK_ROW_SHAPES = {
    "1p7b_b8_t1": (8, 1, 256, [153, 160, 200, 17, 254, 255, 12, 256]),
    "1p7b_b96_t1": (96, 1, 512, [(37 * i) % 520 for i in range(96)]),
    "1p7b_b4_t64": (4, 64, 256, [153, 100, 192, 0]),
    "d48_b3_t3": (3, 3, 128, [5, 126, 60]),
}
QK_ROW_CASES = [(shape, route) for shape in QK_ROW_SHAPES
                for route in QK_ROUTES
                if shape != "d48_b3_t3" or "int4" not in route]


@pytest.mark.parametrize("shape,route", QK_ROW_CASES)
def test_qk_rope_kv_per_row_positions_match_plain(dev, shape, route):
    """A ``[B]`` write position: one launch, row b's keys at its own
    position (keys at or past S dropped), as ``_assert_cache_close`` holds
    the cache against the plain per-row write."""
    b, t, s_len, pos = QK_ROW_SHAPES[shape]
    rows, kv = QK_ROUTES[route]
    d = 48 if shape.startswith("d48") else 128
    nq, nkv = (4, 2) if d == 48 else (16, 8)
    inputs = _qk_inputs(dev, b, t, nq, nkv, d, rows, seed=3)
    ours, ref = _qk_caches(dev, b, nkv, d, s_len, kv)
    where = torch.tensor(pos, dtype=torch.int64, device=dev)
    before = (qk_rope_kv_write.launches, qk_rope_kv_write.launches_per_row)
    q = qk_rope_kv_write(*inputs, 1e-6, ours, 2, where)
    torch.cuda.synchronize()
    assert (qk_rope_kv_write.launches,
            qk_rope_kv_write.launches_per_row) == (before[0] + 1,
                                                   before[1] + 1)
    q_ref = qk_rope_kv_write_plain(*inputs, 1e-6, ref, 2, where)
    assert _ulps(q, q_ref).max() <= 1
    k_share = _assert_cache_close(ours, ref, shape)
    # a row's keys land at its own position and nowhere else
    plane = ours.k_scale if ours.int4 else ours.k
    written = plane[2].float().abs().sum(dim=(1, 3)) > 0      # [B, S]
    for r, p in enumerate(pos):
        want = torch.zeros(s_len, dtype=torch.bool, device=dev)
        want[min(p, s_len):min(p + t, s_len)] = True
        assert torch.equal(written[r], want), (shape, r)
    print(f"qk_rope_kv per-row {shape} {route}: K bit-equal {k_share:.4%}")


@pytest.mark.parametrize("route", ["bf16", "bf16_fp8", "bf16_int4"])
def test_qk_rope_kv_per_row_repeats_and_replays(dev, route):
    """Repeat calls give the same bits, and a captured per-row call
    replayed after every row's position moved writes the eager call's
    bytes at the new positions."""
    rows, kv = QK_ROUTES[route]
    inputs = _qk_inputs(dev, 4, 1, 16, 8, 128, rows, seed=4)
    ours, ref, again = _qk_caches(dev, 4, 8, 128, 256, kv, n=3)
    pos = torch.tensor([10, 50, 90, 130], device=dev)
    first = qk_rope_kv_write(*inputs, 1e-6, again, 0, pos)
    for _ in range(5):
        q = qk_rope_kv_write(*inputs, 1e-6, again, 0, pos)
        torch.cuda.synchronize()
        assert torch.equal(q, first)
    qk_rope_kv_write(*inputs, 1e-6, ours, 1, pos)    # warm-up, then clear
    for p in ours:
        if p is not None:
            p.zero_()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        qk_rope_kv_write(*inputs, 1e-6, ours, 1, pos)
    pos.copy_(torch.tensor([200, 3, 77, 255], device=dev))
    graph.replay()
    torch.cuda.synchronize()
    qk_rope_kv_write(*inputs, 1e-6, ref, 1, pos.clone())
    torch.cuda.synchronize()
    for a, b in zip((p for p in ours if p is not None),
                    (p for p in ref if p is not None)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("name", [n for n in FLASH_CASES
                                  if n.startswith("verify")])
def test_flash_verify_windows_repeat_bits(dev, name):
    """The verify windows in bf16: a repeat call gives the first call's
    bits (out, m and l)."""
    b, nq, nkv, t, s, d, causal, window, vf, vt, qo = FLASH_CASES[name]
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, nq, t, d), torch.bfloat16, dev)
    k = _randn(rng, (b, nkv, s, d), torch.bfloat16, dev)
    v = _randn(rng, (b, nkv, s, d), torch.bfloat16, dev)
    vf, vt, qo = (torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in (vf, vt, qo))
    outs = [flash_attention(q, k, v, causal=causal, q_offset=qo,
                            kv_valid_from=vf, kv_valid_to=vt,
                            return_residuals=True) for _ in range(3)]
    torch.cuda.synchronize()
    for again in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], again))


def test_qk_rope_kv_fp8_store_is_torchs_cast(dev):
    """Every bf16 bit pattern, stored as V into an fp8 cache, gives the
    byte of ``tensor.to(torch.float8_e4m3fn)`` on the card: rounding,
    subnormals, saturation past +-448, infinities and NaNs."""
    b, t, nq, nkv, d = 1, 64, 16, 8, 128
    inputs = list(_qk_inputs(dev, b, t, nq, nkv, d, torch.bfloat16))
    every = torch.arange(-32768, 32768, device=dev, dtype=torch.int32)
    inputs[2] = every.to(torch.int16).view(torch.bfloat16).reshape(b, t,
                                                                   nkv * d)
    (cache,) = _qk_caches(dev, b, nkv, d, t, torch.float8_e4m3fn, n=1)
    qk_rope_kv_write(*inputs, 1e-6, cache, 1, 0)
    want = inputs[2].reshape(b, t, nkv, d).transpose(1, 2).to(
        torch.float8_e4m3fn)
    torch.cuda.synchronize()
    assert torch.equal(cache.v[1].view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("route", ["bf16", "bf16_fp8", "bf16_int4"])
def test_qk_rope_kv_is_deterministic(dev, route):
    """20 calls give the same bits: q and the whole cache."""
    rows, kv = QK_ROUTES[route]
    inputs = _qk_inputs(dev, 8, 1, 16, 8, 128, rows)
    (cache,) = _qk_caches(dev, 8, 8, 128, 256, kv, n=1)
    pos = torch.tensor(100, device=dev)
    first = qk_rope_kv_write(*inputs, 1e-6, cache, 0, pos)
    planes = [p.clone() for p in cache if p is not None]
    for _ in range(19):
        q = qk_rope_kv_write(*inputs, 1e-6, cache, 0, pos)
        torch.cuda.synchronize()
        assert torch.equal(q, first)
        assert all(torch.equal(p.view(torch.uint8), c.view(torch.uint8))
                   for p, c in zip(planes, (c for c in cache
                                            if c is not None)))


@pytest.mark.parametrize("route", ["bf16", "bf16_fp8", "bf16_int4"])
def test_qk_rope_kv_replays_at_a_new_position(dev, route):
    """A captured call, replayed after the device position changed,
    writes there and nowhere else; its q and keys are the eager call's at
    that position."""
    rows, kv = QK_ROUTES[route]
    inputs = _qk_inputs(dev, 2, 1, 16, 8, 128, rows)
    ours, ref = _qk_caches(dev, 2, 8, 128, 256, kv)
    pos = torch.tensor(10, device=dev)
    qk_rope_kv_write(*inputs, 1e-6, ours, 1, pos)     # warm-up, then clear
    for p in ours:
        if p is not None:
            p.zero_()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q = qk_rope_kv_write(*inputs, 1e-6, ours, 1, pos)
    pos.fill_(77)
    graph.replay()
    torch.cuda.synchronize()
    q_ref = qk_rope_kv_write(*inputs, 1e-6, ref, 1, 77)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref)
    for a, r in zip(ours, ref):
        if a is not None:
            assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))
    assert (ours.k[1, :, :, 77].view(torch.uint8).any()
            and not ours.k[1, :, :, 10].view(torch.uint8).any())


def _first_tokens(inputs, n):
    """``_qk_inputs`` cut to the first ``n`` tokens."""
    q, k, v, q_norm, k_norm, cos, sin = inputs
    return [x[:, :n].contiguous() for x in (q, k, v)] + [q_norm, k_norm] + [
        x[:, :n].contiguous() for x in (cos, sin)]


@pytest.mark.parametrize("route", ["bf16", "bf16_fp8", "bf16_int4"])
def test_qk_rope_kv_writes_no_key_past_the_end(dev, route):
    """Keys at or past S are not written (T = 5 two keys before the end:
    the first two land; a step at S: none), and q comes back whole."""
    rows, kv = QK_ROUTES[route]
    s_len = 128
    inputs = _qk_inputs(dev, 2, 5, 16, 8, 128, rows)
    ours, ref = _qk_caches(dev, 2, 8, 128, s_len, kv)
    q = qk_rope_kv_write(*inputs, 1e-6, ours, 0, s_len - 2)
    head = _first_tokens(inputs, 2)
    qk_rope_kv_write(*head, 1e-6, ref, 0, s_len - 2)
    torch.cuda.synchronize()
    for a, r in zip(ours, ref):
        if a is not None:
            assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))
    assert ours.k[0, :, :, s_len - 2:].view(torch.uint8).any()
    assert torch.equal(q[:, :, :2], qk_rope_kv_write(*head, 1e-6, ref, 0,
                                                     s_len - 2))
    assert q.shape == (2, 16, 5, 128)
    step = _first_tokens(inputs, 1)
    (empty,) = _qk_caches(dev, 2, 8, 128, s_len, kv, n=1)
    qk_rope_kv_write(*step, 1e-6, empty, 0, torch.tensor(s_len, device=dev))
    torch.cuda.synchronize()
    assert not any(p.view(torch.uint8).any() for p in empty
                   if p is not None)


def test_qk_rope_kv_refuses_what_it_does_not_take(dev):
    """Raises, never computes: norms of another dtype than the rows, rows
    whose last dimension is strided, a cache of another batch, a layer
    past the stack."""
    inputs = list(_qk_inputs(dev, 2, 1, 4, 2, 128, torch.bfloat16))
    (cache,) = _qk_caches(dev, 2, 2, 128, 128, torch.bfloat16, n=1)
    bad = list(inputs)
    bad[3] = bad[3].float()
    with pytest.raises(ValueError, match="one dtype"):
        qk_rope_kv_write(*bad, 1e-6, cache, 0, 0)
    bad = list(inputs)
    bad[0] = torch.zeros((2, 1, 2 * 4 * 128), device=dev,
                         dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dimension"):
        qk_rope_kv_write(*bad, 1e-6, cache, 0, 0)
    (other,) = _qk_caches(dev, 3, 2, 128, 128, torch.bfloat16, n=1)
    with pytest.raises(ValueError, match="cache"):
        qk_rope_kv_write(*inputs, 1e-6, other, 0, 0)
    with pytest.raises(ValueError, match="layer"):
        qk_rope_kv_write(*inputs, 1e-6, cache, 3, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", [n for n in FLASH_CASES
                                  if n.startswith("aligner")])
def test_flash_aligner_lengths_repeat_bits(dev, name, dtype):
    """The aligner's encoder lengths: a repeat call gives the first call's
    bits (out, m and l)."""
    b, nq, nkv, t, s, d, causal, window, vf, vt, qo = FLASH_CASES[name]
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (b, nq, t, d), dtype, dev) for _ in range(3))
    vt = torch.tensor(vt, dtype=torch.int32, device=dev)
    outs = [flash_attention(q, k, v, window_block=window, kv_valid_to=vt,
                            return_residuals=True) for _ in range(3)]
    torch.cuda.synchronize()
    for again in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], again))


ALIGNER_CLIPS = ("english_01", "chinese_02", "japanese_01", "hindi_02")


def _real_clip(name):
    import os
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    root = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
    with open(os.path.join(root, "real", name + ".wav"), "rb") as f:
        audio, _ = decode_audio(f.read())
    with open(os.path.join(root, "real", name + ".txt"),
              encoding="utf-8") as f:
        return audio.astype(np.float32), f.read().strip()


@pytest.fixture
def trained_aligners(dev):
    import os
    from qwen3_asr_tpu_torch.sidecars.aligner import AlignerEngine
    ckpt = os.path.join(os.path.dirname(__file__), "..", "e2e", "data",
                        "trained_ckpt")
    return (AlignerEngine.load(ckpt, device=dev, dtype=torch.float32),
            AlignerEngine.load(ckpt, device="cpu"), ckpt)


@pytest.mark.parametrize("clip", ALIGNER_CLIPS)
def test_aligner_on_the_card_matches_the_cpu(trained_aligners, clip):
    """The forced aligner on the card in f32 (flash on its encoder)
    against the port on the CPU on a real clip: the same words, every edge
    within 1e-3 s, and flash launched once an encoder layer."""
    card, cpu, _ = trained_aligners
    audio, text = _real_clip(clip)
    before = flash_attention.launches
    got = card.align(audio, 16000, text, "en")
    assert flash_attention.launches - before == \
        card.model.cfg.encoder.encoder_layers
    want = cpu.align(audio, 16000, text, "en")
    assert got and [w.text for w in got] == [w.text for w in want]
    for a, b in zip(got, want):
        assert abs(a.start - b.start) <= 1e-3 and abs(a.end - b.end) <= 1e-3


def test_aligner_on_the_card_at_60s_is_optimal_under_the_cpus(
        trained_aligners):
    """60 s of the clips joined, where the partition has near-equal optima
    (``tests/test_torch_aligner.py``): the same words, and the card's
    partition, scored under the CPU's similarity, within the perturbation
    bound of the CPU's (2 · frames · max |Δsim| plus 1e-5 of the score)."""
    from qwen3_asr_tpu_torch.sidecars.aligner import _viterbi_partition
    card, cpu, _ = trained_aligners
    parts = [_real_clip(n) for n in ALIGNER_CLIPS]
    audio = np.tile(np.concatenate([a for a, _ in parts]), 2)[:60 * 16000]
    text = " ".join([" ".join(t for _, t in parts)] * 2)
    got = card.align(audio, 16000, text, "en")
    want = cpu.align(audio, 16000, text, "en")
    assert got and [w.text for w in got] == [w.text for w in want]
    sim = card.similarity(audio, 16000, text)[2]
    ref = cpu.similarity(audio, 16000, text)[2]
    assert sim.shape == ref.shape

    def score(s, entries):
        edges = list(entries) + [s.shape[1]]
        return sum(float(s[i, edges[i]:edges[i + 1]].sum(dtype=np.float64))
                   for i in range(s.shape[0]))

    best = score(ref, _viterbi_partition(ref))
    slack = (2 * sim.shape[1] * float(np.abs(sim - ref).max())
             + 1e-5 * abs(best))
    assert score(ref, _viterbi_partition(sim)) >= best - slack


def test_aligner_loads_on_the_card_in_bf16_by_default(trained_aligners):
    from qwen3_asr_tpu_torch.sidecars.aligner import AlignerEngine
    _, _, ckpt = trained_aligners
    eng = AlignerEngine.load(ckpt)
    assert eng.device.type == "cuda" and eng.dtype == torch.bfloat16
    audio, text = _real_clip("english_01")
    words = eng.align(audio, 16000, text, "en")
    assert [w.text for w in words] == text.split()
    assert all(0 <= w.start <= w.end <= len(audio) / 16000 + 1e-6
               for w in words)
    assert all(a.end <= b.start + 1e-6 for a, b in zip(words, words[1:]))


def test_vad_entry_points_run_on_the_card_by_default(dev, monkeypatch):
    """With no device given every VAD entry point resolves the card (and
    only the card), gives the CPU's probability within 1e-4, and counts no
    failure."""
    from qwen3_asr_tpu_torch.audio import vad, vad_model
    from qwen3_asr_tpu_torch.utils import device as device_mod
    seen = []

    def spy(device=None):
        got = device_mod.resolve_device(device)
        seen.append(got.type)
        return got

    monkeypatch.setattr(vad, "resolve_device", spy)
    monkeypatch.setattr(vad_model, "resolve_device", spy)
    audio, _ = _real_clip("english_01")
    x = audio[:19200]
    before = vad.failures
    for fn in (vad.spectral_probability, vad.speech_probability,
               vad_model.speech_probability):
        seen.clear()
        p = fn(x)
        assert seen and set(seen) == {"cuda"}
        seen.clear()
        assert abs(p - fn(x, "cpu")) <= 1e-4
        assert seen and set(seen) == {"cpu"}
    seen.clear()
    assert vad.is_speech(x) is True
    assert seen and set(seen) == {"cuda"}
    net = vad_model.params_from_jax(vad_model.load_params())
    assert next(net.parameters()).device.type == "cuda"
    assert vad.failures == before


# -- token-level speculation and the lifecycle on the card -------------------------

def _draft_model(dev, seed=1):
    """SMALL with other random weights: the same tokenizer and chunking
    as ``_model``, so it attaches as its draft."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dec = init_decoder_params(SMALL.decoder, gen, dev, torch.bfloat16)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        dec["layers"][k] *= 10
    params = {"encoder": init_encoder_params(SMALL.encoder, gen, dev,
                                             torch.bfloat16),
              "decoder": dec}
    return AsrModel(SMALL, params, preset_tokenizer(512))


@pytest.mark.parametrize("batch,self_draft", [(1, False), (8, False),
                                              (1, True)],
                         ids=["b1", "b8", "b1_self"])
def test_spec_graph_replay_equals_eager(dev, batch, self_draft):
    """A spec key in bf16: the captured request gives the eager run's
    tokens and rounds bit for bit. A chunk records, a round, one flash
    launch a verifier layer (the T = 4 window at a per-row q_offset), the
    draft's γ decode launches a layer (#2 at B=1, #3 at B=8), and kernel
    B once a layer for each draft step and the window (its per-row route
    at B=8)."""
    from qwen3_asr_tpu_torch.runtime.speculative import rounds_per_chunk
    model = _model(dev)
    eng = TranscriptionEngine(model, device=dev)
    eng.attach_draft(model if self_draft else _draft_model(dev))
    key, inputs = _request(eng, batch)
    exe, capture_s = eng.executable(*key, gamma=4)
    assert capture_s > 0 and exe.chunk.graph is not None
    rounds, layers = rounds_per_chunk(4), SMALL.decoder.num_hidden_layers
    rec = exe.chunk.recorded
    kernel = "decode_attention" if batch == 1 else "decode_attention_batch"
    assert rec["flash_attention"] == rounds * layers
    assert rec[kernel] == rounds * 4 * layers
    # one position a row: counted per row at B > 1
    assert rec["qk_rope_kv"] == rounds * 5 * layers
    assert rec["qk_rope_kv_per_row"] == (rec["qk_rope_kv"] if batch > 1
                                         else 0)
    assert exe.front.recorded["qk_rope_kv"] == 2 * layers
    graph = exe.run(*inputs)
    eager = exe.run(*inputs, eager=True)
    assert torch.equal(graph.tokens, eager.tokens)
    assert (graph.steps, graph.steps_run) == (eager.steps, eager.steps_run)
    assert len(set(graph.tokens[0].tolist())) >= 3
    if self_draft:
        # every draft accepted: γ tokens a round
        n = int(graph.lengths[0])
        assert graph.steps <= n // 4 + 2


def _trained(dev, name):
    import os
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    return load_engine(os.path.join(os.path.dirname(__file__), "..", "e2e",
                                    "data", name),
                       device=dev, dtype=torch.float32)


def test_spec_f32_trained_pair_equals_greedy(dev):
    """trained_ckpt with trained_draft attached, f32 on the card: the spec
    ids of real clips, alone and four at once, are the plain greedy ids,
    in fewer verifier rounds than tokens."""
    import glob
    import os
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    plain, spec = _trained(dev, "trained_ckpt"), _trained(dev,
                                                          "trained_ckpt")
    spec.attach_draft(_trained(dev, "trained_draft").model)
    paths = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                          "e2e", "data", "real", "*.wav")))
    clips = []
    tokens = rounds = 0
    for path in paths[:6]:
        with open(path, "rb") as f:
            audio, sr = decode_audio(f.read())
        clips.append((audio, sr))
        got = spec.transcribe(audio, sr)
        assert spec.last_run["spec"]
        tokens += spec.last_run["generated"] - 1
        rounds += spec.last_run["rounds"]
        assert [r.token_ids for r in got] == \
            [r.token_ids for r in plain.transcribe(audio, sr)]
    assert rounds < tokens
    batch = spec.transcribe_batch(clips[:4])
    assert [r.token_ids for r in batch] == \
        [r.token_ids for r in plain.transcribe_batch(clips[:4])]


# what an idle unload may leave allocated on the card: what the first load
# of a process creates and torch keeps for the process (cuBLAS's workspace,
# 32 MiB on the H100, cuFFT's plans, the decode kernels' ticket buffer)
UNLOAD_RESIDUE_BYTES = 64 * 2 ** 20


def test_idle_unload_returns_the_card_memory(dev, monkeypatch):
    """A lazy manager on the card (trained_ckpt and its draft, f32,
    speculative, the pool on): after the unload the allocator holds at
    most ``UNLOAD_RESIDUE_BYTES`` more than before the load, and the
    reload serves the same ids."""
    import gc
    import os
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    root = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
    for k, v in {"MODEL_ID": os.path.join(root, "trained_ckpt"),
                 "FAST_MODEL_ID": os.path.join(root, "trained_draft"),
                 "USE_SPECULATIVE": "true", "ASR_CONTINUOUS_BATCHING": "true",
                 "ASR_POOL_SLOTS": "2", "ASR_WARMUP_BUCKETS": "2",
                 "ASR_WARMUP_BATCH_SHAPES": ""}.items():
        monkeypatch.setenv(k, v)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    mgr = ModelManager(device=dev, dtype=torch.float32)
    mgr.queue.start()
    try:
        mgr.ensure_loaded()
        audio = np.random.default_rng(3).standard_normal(24000).astype(
            np.float32) * 0.1
        first = mgr.queue.submit(lambda: mgr.transcribe_sync(
            audio, 16000, "en")).result(300)
        loaded = torch.cuda.memory_allocated(dev)
        assert mgr.engine.last_run["spec"] and mgr.pool is not None
        mgr.idle_timeout = 0
        mgr.queue.submit(mgr._unload_sync).result(300)
        gc.collect()
        after = torch.cuda.memory_allocated(dev)
        print(f"allocated before {before}, loaded {loaded}, after unload "
              f"{after}: residue {after - before} bytes; reserved "
              f"{torch.cuda.memory_reserved(dev)}")
        assert mgr.engine is None
        assert after - before <= UNLOAD_RESIDUE_BYTES and after < loaded
        mgr.ensure_loaded()
        again = mgr.queue.submit(lambda: mgr.transcribe_sync(
            audio, 16000, "en")).result(300)
        assert again[0].token_ids == first[0].token_ids
    finally:
        mgr.stop()


def test_debug_trace_holds_the_ports_kernels(dev, tmp_path, monkeypatch):
    """``POST /debug/trace`` on a server whose engine is on the card,
    during an upload: the Chrome trace it writes holds the port's flash
    and single-token decode kernels (launched from the device thread's
    graph replays) and no library attention kernel; a second capture
    meanwhile answers 409."""
    import glob
    import json
    import os
    import threading
    import time
    import urllib.error
    import urllib.request
    import uuid
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    from qwen3_asr_tpu_torch.serving.server import build_server
    monkeypatch.setenv("ASR_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("ASR_WARMUP_BUCKETS", "2")
    monkeypatch.setenv("ASR_WARMUP_BATCH_SHAPES", "")
    mgr = ModelManager(TranscriptionEngine(_model(dev), device=dev))
    mgr.start()
    server = build_server(mgr, "127.0.0.1", 0)
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body=b"", headers=None):
        req = urllib.request.Request(base + path, data=body, method="POST",
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    bnd = uuid.uuid4().hex
    wav = encode_wav(np.random.default_rng(5).standard_normal(24000)
                     .astype(np.float32) * 0.1, 16000)
    upload = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
              f"filename=\"a.wav\"\r\n\r\n").encode() + wav + \
        f"\r\n--{bnd}--\r\n".encode()
    answers = {}
    try:
        capture = threading.Thread(target=lambda: answers.update(
            first=post("/debug/trace?seconds=2")))
        capture.start()
        time.sleep(0.3)
        answers["second"] = post("/debug/trace?seconds=2")
        answers["upload"] = post(
            "/v1/audio/transcriptions", upload,
            {"Content-Type": f"multipart/form-data; boundary={bnd}"})
        capture.join(timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        mgr.stop()
        serve.join(timeout=30)
    assert answers["first"][0] == 200 and answers["upload"][0] == 200
    assert answers["second"][0] == 409
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("flash_bf16_kernel" in n for n in names), sorted(names)[:20]
    assert any("decode_split_kernel" in n for n in names), sorted(names)[:20]
    # SDPA's backends (the encoder's convolutions run other cuDNN kernels)
    library = ("flash_fwd", "pytorch_flash", "fmha", "efficient_attention",
               "sdpa", "flash_fprop")
    assert not [n for n in names if any(p in n.lower() for p in library)]


# ---------------------------------------------------------------------------
# training: the backward kernels (csrc/flash_attention_bwd.cu,
# csrc/qk_rope_bwd.cu) against their plain versions on the card

FLASH_BWD_CASES = {
    # (b, nq, nkv, t, s, d, causal, window, valid_from, valid_to, q_offset)
    # the encoder's windows at preset:1.7b (50 tokens a window): 6 s, 30 s
    "encoder_6s": (2, 20, 20, 75, 75, 64, False, 50, [0, 0], [75, 60],
                   [0, 0]),
    "encoder_30s": (1, 20, 20, 375, 375, 64, False, 50, [0], [375], [0]),
    # the training forward at preset:1.7b, 6 s bucket: [prefix 64, audio
    # 75, suffix + targets 78], the prompt from 12
    "train_causal_1p7b": (2, 16, 8, 217, 217, 128, True, 0, [12, 0],
                          [217, 217], [0, 0]),
    "trained_ckpt_heads": (2, 4, 2, 150, 150, 48, True, 0, [20, 45],
                           [150, 150], [0, 0]),
    "fully_masked_rows": (2, 2, 2, 40, 40, 64, False, 0, [45, 3], [40, 30],
                          [0, 0]),
    "group8_q_offset": (1, 16, 2, 29, 200, 96, True, 0, [3], [200], [171]),
    "window_crossing_tiles": (2, 2, 2, 230, 230, 64, False, 50, [0, 0],
                              [230, 171], [0, 0]),
    # trained_draft's head dim, not a multiple of 16: the CUDA cores in
    # bf16 too
    "draft_d24": (2, 4, 2, 60, 60, 24, True, 0, [5, 0], [60, 60], [0, 0]),
}


def _flash_bwd_inputs(dev, name, dtype, seed=0):
    b, nq, nkv, t, s, d, causal, window, vf, vt, qo = FLASH_BWD_CASES[name]
    rng = np.random.default_rng(seed)
    q = _randn(rng, (b, nq, t, d), dtype, dev)
    k = _randn(rng, (b, nkv, s, d), dtype, dev)
    v = _randn(rng, (b, nkv, s, d), dtype, dev)
    g = _randn(rng, (b, nq, t, d), dtype, dev)
    vf, vt, qo = (torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in (vf, vt, qo))
    out, m, l = flash_attention(q, k, v, causal=causal, q_offset=qo,
                                kv_valid_from=vf, kv_valid_to=vt,
                                window_block=window, return_residuals=True)
    kw = dict(causal=causal, window_block=window, sm_scale=d ** -0.5)
    return (q, k, v, g, m, l, vf, vt, qo), kw


def _close_to_max(got, want, tol):
    scale = max(float(want.float().abs().max()), 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLASH_BWD_CASES))
def test_flash_bwd_kernel_matches_plain(dev, name, dtype):
    """Kernel (i) against ``flash_attention_bwd_plain`` on the same card
    inputs: f32 to 2e-5 and bf16 to 2e-2 of each gradient's largest
    magnitude (outputs rounded to bf16 on both sides); a repeat call
    gives the same bits; every fully masked row's dq is 0. bf16 takes the
    tensor-core route but at head dim 24; f32 the CUDA cores."""
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    args, kw = _flash_bwd_inputs(dev, name, dtype)
    route = ("tensor_cores" if dtype == torch.bfloat16 and name != "draft_d24"
             else "cuda_cores")
    before = flash_attention_bwd.launches
    routes = dict(flash_attention_bwd.route_launches)
    got = flash_attention_bwd(*args, **kw)
    again = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert {r: n - routes[r] for r, n in
            flash_attention_bwd.route_launches.items()} == {
        "tensor_cores": 0, "cuda_cores": 0, route: 2}
    want = flash_attention_bwd_plain(*args, **kw)
    for a, b_, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b_)
        _close_to_max(a, w, TOL[dtype])
    l = args[5]
    assert torch.all(got[0][l == 0] == 0)


def test_flash_autograd_on_card_launches_the_backward(dev):
    """flash_attention under autograd on the card: FlashFunction, forward
    kernel then kernel (i); gradients equal the direct call's."""
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_bwd
    (q, k, v, g, m, l, vf, vt, qo), kw = _flash_bwd_inputs(
        dev, "train_causal_1p7b", torch.bfloat16)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*ts, causal=True, kv_valid_from=vf,
                          kv_valid_to=vt, q_offset=qo)
    got = torch.autograd.grad(out, ts, g)
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches
            - b0) == (1, 1)
    want = flash_attention_bwd(q, k, v, g, m, l, vf, vt, qo, **kw)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def _ml_cotangents(args, tie: bool):
    """dm and dl for ``_flash_bwd_inputs``'s args (JAX's residual loss:
    dm = 1e-3, dl = 1/l on live rows); with ``tie`` the keys 4, 9 and 15
    of every head copy key 4, so rows whose maximum is key 4 tie."""
    q, k, v, g, m, l, vf, vt, qo = args
    if tie:
        k = k.clone()
        for c in (9, 15):
            k[:, :, c] = k[:, :, 4]
        k[:, :, 4] *= 4
        k[:, :, 9] *= 4
        k[:, :, 15] *= 4
    dm = torch.full_like(m, 1e-3)
    dl = torch.where(l > 0, 1.0 / torch.clamp(l, min=1e-30),
                     torch.zeros_like(l))
    return (q, k, v, g, m, l, vf, vt, qo), dm, dl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["encoder_6s", "train_causal_1p7b",
                                  "fully_masked_rows", "group8_q_offset",
                                  "draft_d24", "tied"])
def test_flash_bwd_ml_route_matches_plain(dev, name, dtype):
    """Kernel (i)'s m/l route (cotangents on m and l) against
    ``flash_attention_bwd_plain`` with dm and dl: f32 to 2e-5 and bf16 to
    2e-2 of each gradient's largest magnitude, a repeat call's bits, the
    route's launch counter; "tied" duplicates keys so rows tie."""
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    args, kw = _flash_bwd_inputs(
        dev, "train_causal_1p7b" if name == "tied" else name, dtype)
    args, dm, dl = _ml_cotangents(args, name == "tied")
    if name == "tied":   # the residuals of the tied keys' forward
        q, k, v, g, _, _, vf, vt, qo = args
        _, m, l = flash_attention(q, k, v, causal=True, q_offset=qo,
                                  kv_valid_from=vf, kv_valid_to=vt,
                                  return_residuals=True)
        args = (q, k, v, g, m, l, vf, vt, qo)
        dl = torch.where(l > 0, 1.0 / torch.clamp(l, min=1e-30),
                         torch.zeros_like(l))
    ml0 = flash_attention_bwd.ml_launches
    got = flash_attention_bwd(*args, **kw, dm=dm, dl=dl)
    again = flash_attention_bwd(*args, **kw, dm=dm, dl=dl)
    torch.cuda.synchronize()
    assert flash_attention_bwd.ml_launches == ml0 + 2
    want = flash_attention_bwd_plain(*args, **kw, dm=dm, dl=dl)
    for a, b_, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, b_)
        _close_to_max(a, w, TOL[dtype])


def test_flash_autograd_residual_cotangents_on_card(dev):
    """A loss on out, m and l through FlashFunction on the card takes the
    m/l route, and its gradients equal the direct call's."""
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_bwd
    (q, k, v, g, m, l, vf, vt, qo), kw = _flash_bwd_inputs(
        dev, "encoder_6s", torch.bfloat16)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    ml0 = flash_attention_bwd.ml_launches
    out, m2, l2 = flash_attention(*ts, window_block=50, kv_valid_from=vf,
                                  kv_valid_to=vt, q_offset=qo,
                                  return_residuals=True)
    got = torch.autograd.grad((out.float() * g.float()).sum() + m2.sum()
                              + l2.sum(), ts)
    assert flash_attention_bwd.ml_launches == ml0 + 1
    want = flash_attention_bwd(q, k, v, g, m, l, vf, vt, qo, **kw,
                               dm=torch.ones_like(m), dl=torch.ones_like(l))
    for a, w in zip(got, want):
        assert torch.equal(a, w)


QK_BWD_SHAPES = {
    # (b, t, nq, nkv, d): preset:1.7b's training rows, its encoder-free
    # decoder at head_dim 128, trained_ckpt's 48, an odd 24
    "1p7b_b8": (8, 217, 16, 8, 128),
    "trained_ckpt": (2, 150, 4, 2, 48),
    "d24": (3, 7, 4, 2, 24),
    # the vector route at 8 (bf16) and 16 (f32) lanes a row
    "d64": (2, 33, 4, 2, 64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(QK_BWD_SHAPES))
def test_qk_rope_bwd_kernel_matches_plain(dev, shape, dtype):
    """``qk_rope`` on the card: the forward is kernel B (one launch) and
    equals the plain chain within an ulp; kernel (ii)'s dx and norm
    gradients equal ``qk_rope_bwd_plain``'s (f32 2e-5, bf16 2e-2 of the
    largest magnitude), v's cotangent passes through exactly, and a
    repeat call gives the same bits."""
    from qwen3_asr_tpu_torch.models.decoder import rope_cos_sin
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import (
        _heads, apply_rope, qk_rope, qk_rope_bwd, qk_rope_bwd_plain,
        qk_rope_kv_write, rms_norm)
    b, t, nq, nkv, d = QK_BWD_SHAPES[shape]
    rng = np.random.default_rng(1)
    q = _randn(rng, (b, t, nq * d), dtype, dev)
    k = _randn(rng, (b, t, nkv * d), dtype, dev)
    v = _randn(rng, (b, t, nkv * d), dtype, dev)
    wq = (1 + 0.1 * _randn(rng, (d,), torch.float32, dev)).to(dtype)
    wk = (1 + 0.1 * _randn(rng, (d,), torch.float32, dev)).to(dtype)
    gq = _randn(rng, (b, nq, t, d), dtype, dev)
    gk = _randn(rng, (b, nkv, t, d), dtype, dev)
    gv = _randn(rng, (b, nkv, t, d), dtype, dev)
    cos, sin = rope_cos_sin(torch.arange(t, device=dev)[None].expand(b, t),
                            d, 1e6)
    f0 = qk_rope_kv_write.launches
    outs = qk_rope(q, k, v, wq, wk, cos, sin, 1e-6)
    torch.cuda.synchronize()
    assert qk_rope_kv_write.launches == f0 + 1
    refs = (apply_rope(rms_norm(_heads(q, d), wq, 1e-6), cos, sin),
            apply_rope(rms_norm(_heads(k, d), wk, 1e-6), cos, sin),
            _heads(v, d))
    for o, r in zip(outs, refs):
        _close_to_max(o, r, TOL[dtype])
    b0 = qk_rope_bwd.launches
    routes = dict(qk_rope_bwd.route_launches)
    got = qk_rope_bwd(q, k, wq, wk, cos, sin, 1e-6, gq, gk, gv)
    again = qk_rope_bwd(q, k, wq, wk, cos, sin, 1e-6, gq, gk, gv)
    torch.cuda.synchronize()
    assert qk_rope_bwd.launches == b0 + 2
    # 16-byte pieces at head dims 128 and 64; a warp a row at 48 and 24
    route = "vector" if shape in ("1p7b_b8", "d64") else "rows"
    assert {r: n - routes[r] for r, n in
            qk_rope_bwd.route_launches.items()} == {
        "vector": 0, "rows": 0, route: 2}
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    dq, dwq = qk_rope_bwd_plain(_heads(q, d), wq, cos, sin, 1e-6, gq)
    dk, dwk = qk_rope_bwd_plain(_heads(k, d), wk, cos, sin, 1e-6, gk)
    flat = lambda x: x.transpose(1, 2).reshape(b, t, -1)  # noqa: E731
    for a, w in zip(got, (flat(dq), flat(dk), flat(gv), dwq, dwk)):
        assert a.dtype == dtype
        _close_to_max(a, w, TOL[dtype])
    assert torch.equal(got[2], flat(gv))


def test_train_step_on_card_matches_cpu(dev):
    """Three f32 steps of the port's train step (clip + adamw) on a tiny
    random model, card against CPU: losses to 1e-5 relative, and the
    step launched flash's and qk_rope's forward and backward kernels."""
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_bwd
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import (qk_rope_bwd,
                                                    qk_rope_kv_write)
    from qwen3_asr_tpu_torch.runtime import optim
    from qwen3_asr_tpu_torch.runtime.train import (init_train_state,
                                                   make_train_step)
    cfg = preset("tiny")
    rng = np.random.default_rng(0)
    batch = {
        "mel": rng.standard_normal((2, 128, 200)).astype(np.float32),
        "feature_lens": np.array([200, 150], np.int32),
        "prompt_ids": rng.integers(0, 400, (2, 8)).astype(np.int32),
        "target_ids": rng.integers(0, 400, (2, 10)).astype(np.int32),
        "target_mask": np.ones((2, 10), np.int32),
        "valid_from": np.array([0, 3], np.int32),
    }
    losses = {}
    for where in ("cpu", "cuda"):
        gen = torch.Generator(device="cpu").manual_seed(0)
        params = {"encoder": init_encoder_params(cfg.encoder, gen, "cpu"),
                  "decoder": init_decoder_params(cfg.decoder, gen, "cpu")}
        params = optim.tree_map(lambda x: x.to(where), params)
        opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-3))
        state, step = init_train_state(params, opt), make_train_step(cfg, opt)
        counts = [f.launches for f in (flash_attention, flash_attention_bwd,
                                       qk_rope_kv_write, qk_rope_bwd)]
        out = []
        for _ in range(3):
            state, loss = step(state, batch)
            out.append(float(loss))
        losses[where] = out
        if where == "cuda":
            launched = [f.launches - c for f, c in zip(
                (flash_attention, flash_attention_bwd, qk_rope_kv_write,
                 qk_rope_bwd), counts)]
            layers = cfg.encoder.encoder_layers + cfg.decoder.num_hidden_layers
            assert launched == [3 * layers, 3 * layers,
                                3 * cfg.decoder.num_hidden_layers,
                                3 * cfg.decoder.num_hidden_layers], launched
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


# -- slice 23: the registered flash operator, the encoder export, the boot
# cache's libraries and train_vad on the card -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_registered_op_launches_the_kernel(dev, dtype):
    """On a CUDA tensor the operator runs ``_launch`` (one launch, the
    kernel's bits), never the plain version."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(23)
    b, nq, nkv, t, s, d = 2, 4, 2, 70, 96, 64
    q = _randn(rng, (b, nq, t, d), dtype, dev)
    k, v = (_randn(rng, (b, nkv, s, d), dtype, dev) for _ in range(2))
    vf = torch.tensor([0, 9], dtype=torch.int32, device=dev)
    vt = torch.tensor([96, 80], dtype=torch.int32, device=dev)
    qo = torch.tensor([26, 10], dtype=torch.int32, device=dev)
    want = fa._launch(q, k, v, vf, vt, qo, causal=True, window_block=0,
                      sm_scale=0.125)
    fa.flash_attention.launches = 0
    got = fa.registered_op()(q, k, v, vf, vt, qo, True, 0, 0.125)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == 1
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_encoder_export_on_the_card_equals_eager(dev, tmp_path):
    """trained_ckpt's encoder exported on the card: the operator's nodes,
    output bit-equal to the eager encoder, a launch a layer; saved and
    loaded back."""
    import os
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.tools.export_encoder import (bucket_mel_frames,
                                                          export_program,
                                                          flash_nodes,
                                                          load_encoder)
    ckpt = os.path.join(os.path.dirname(__file__), "..", "e2e", "data",
                        "trained_ckpt")
    engine = load_engine(ckpt, device=dev)
    cfg = engine.model.cfg.encoder
    frames = bucket_mel_frames(cfg, 4.0)
    program = export_program(engine.model.params["encoder"], cfg, 2, frames,
                             torch.bfloat16, dev)
    assert flash_nodes(program) == cfg.encoder_layers
    rng = np.random.default_rng(1)
    mel = _randn(rng, (2, cfg.num_mel_bins, frames), torch.bfloat16, dev)
    lens = torch.tensor([frames, frames - 150], dtype=torch.int32,
                        device=dev)
    with torch.inference_mode():
        want = encoder_forward(engine.model.params["encoder"], cfg, mel,
                               lens)[0]
    fa.flash_attention.launches = 0
    got = program.module()(mel, lens)[0]
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == cfg.encoder_layers
    assert torch.equal(got, want)
    path = str(tmp_path / "enc.pt2")
    torch.export.save(program, path)
    assert torch.equal(load_encoder(path).module()(mel, lens)[0], want)


def test_boot_cache_serves_cuda_libraries(dev, tmp_path, monkeypatch):
    """A kernel built into an empty build directory is published to the
    boot cache; another empty build directory then takes it from there
    with no nvcc, and it launches."""
    import subprocess
    from qwen3_asr_tpu_torch.ops import _build
    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b1")
    _build.build(["slab_reader"])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b2")

    def refuse(*a, **k):
        raise AssertionError("nvcc ran: the cache was not used")
    monkeypatch.setattr(subprocess, "Popen", refuse)
    reports = _build.build(["slab_reader"])
    assert (tmp_path / "b2" / _build.library_path("slab_reader").name
            ).is_file()
    assert "registers" in reports["slab_reader"]


def test_train_vad_steps_on_the_card_match_the_cpu(dev):
    """20 steps of the VAD trainer on the card and on the CPU from the same
    weights and batches (f32, TF32 off)."""
    import os
    from qwen3_asr_tpu_torch.tools import train_vad
    rng = np.random.default_rng(3)
    windows = (rng.standard_normal((300, 16000)) * 0.1).astype(np.float32)
    labels = (rng.random(300) > 0.5).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        feats = train_vad.featurize_windows(windows, d)
        params = train_vad.init_params(0, d)
        params, losses = train_vad.train(params, feats, labels, 20, 3e-3, 0,
                                         log_every=0)
        out[d.type] = ({k: v.cpu() for k, v in params.items()},
                       [float(x) for x in losses])
    (gp, gl), (cp, cl) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    for k in cp:
        assert (gp[k] - cp[k]).abs().max() <= 1e-4 * cp[k].abs().max(), k
