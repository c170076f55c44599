"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a card every test here skips (decided inside the
fixture, so every worker collects the same tests). On a machine with one
(which need not have JAX, hence ``--noconftest``):
``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

import torch

from qwen3_asr_tpu_torch.ops import decode_attention as decode_module
from qwen3_asr_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)
from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
    decode_attention_batched, decode_attention_batched_plain)
from qwen3_asr_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from qwen3_asr_tpu_torch.ops.slab_reader import slab_read, slab_read_plain

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
