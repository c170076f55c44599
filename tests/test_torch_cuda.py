"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a card every test here skips (decided inside the
fixture, so every worker collects the same tests). On a machine with one
(which need not have JAX, hence ``--noconftest``):
``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

import torch

from qwen3_asr_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)
from qwen3_asr_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_plain)

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


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 2, 4, 20), device=dev)        # head_dim 20: not x8
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1], q[:, :1])
    q16 = torch.zeros((1, 2, 1, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        decode_attention(q16, q16[:, :1], q16[:, :1])
