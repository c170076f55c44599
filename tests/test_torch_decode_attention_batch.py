"""The port's batch-major decode attention (plain version, CPU) against the
JAX Pallas kernel ``decode_attention_batched`` in interpret mode.

Tolerance atol = rtol = 1e-2 in f32: both round p to bf16 before it weights
V, the port against a per-block softmax max and the TPU kernel against its
running max, so the rounding of p differs by up to half a bf16 ulp."""
import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.ops.decode_attention_batch import (
    decode_attention_batched as jax_batched)
from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
    decode_attention_batched)

TOL = 1e-2


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def fp8_pair(x: np.ndarray):
    """The same fp8 bytes as a JAX array and a torch tensor."""
    x8 = x.astype(ml_dtypes.float8_e4m3fn)
    return (jnp.asarray(x8),
            torch.from_numpy(x8.view(np.uint8).copy()).view(
                torch.float8_e4m3fn))


# (layers, b, nq, nkv, s, kv dtype, q dtype, valid_from, valid_to,
#  layer_idx); layers=0 is one layer's cache.
CASES = {
    "f32_b1": (0, 1, 16, 8, 256, "f32", "f32", [12], [200], 0),
    "f32_b2": (0, 2, 8, 4, 256, "f32", "f32", [0, 3], [256, 130], 0),
    "bf16_b4": (0, 4, 8, 4, 256, "bf16", "bf16", [0, 0, 5, 100],
                [100, 256, 37, 192], 0),
    "fp8_b4": (0, 4, 16, 8, 128, "fp8", "bf16", [0, 7, 0, 64],
               [128, 128, 90, 65], 0),
    "fp8_f32q_b2": (0, 2, 4, 2, 384, "fp8", "f32", [64, 0], [300, 384], 0),
    "stacked_layer0": (3, 2, 8, 4, 256, "f32", "f32", [0, 5], [256, 200], 0),
    "stacked_layer2": (3, 2, 8, 4, 256, "bf16", "f32", [0, 5], [256, 200],
                       2),
    "left_pad_multi_block": (0, 4, 16, 8, 512, "f32", "f32",
                             [10, 200, 300, 0], [150, 512, 301, 512], 0),
    "fully_masked_rows": (0, 4, 8, 4, 256, "f32", "f32", [0, 0, 50, 0],
                          [0, 256, 50, 64], 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret(name):
    n_layers, b, nq, nkv, s, kv, qd, vf, vt, layer = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = ((n_layers,) if n_layers else ()) + (b, nkv, s, 128)
    q = rng.standard_normal((b, nq, 1, 128)).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    vf = np.asarray(vf, np.int32)
    vt = np.asarray(vt, np.int32)
    if kv == "fp8":
        (jk, tk), (jv, tv) = fp8_pair(k), fp8_pair(v)
    else:
        jdt, tdt = ((jnp.float32, torch.float32) if kv == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
        tk = torch.from_numpy(k).to(tdt)
        tv = torch.from_numpy(v).to(tdt)
    jq = jnp.asarray(q, jnp.float32 if qd == "f32" else jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.float32 if qd == "f32"
                                else torch.bfloat16)

    ref = jax_batched(jq, jk, jv, layer_idx=layer,
                      kv_valid_from=jnp.asarray(vf),
                      kv_valid_to=jnp.asarray(vt), interpret=True)
    ours = decode_attention_batched(tq, tk, tv, layer_idx=layer,
                                    kv_valid_from=torch.from_numpy(vf),
                                    kv_valid_to=torch.from_numpy(vt))
    assert ours.dtype == tq.dtype and ours.shape == tq.shape
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=TOL, rtol=TOL)
    for row in range(b):
        if min(vt[row], s) <= max(vf[row], 0):       # no live key: 0
            assert not ours[row].float().abs().any()


def test_fp8_bytes_match_ml_dtypes_up_to_448():
    """torch's cast and ml_dtypes' give the same fp8 bytes over normal and
    subnormal values up to ±448. Beyond it they part: ml_dtypes rounds to
    NaN (0x7f), torch saturates to 448 (0x7e). The port keeps torch's cast;
    K is RMS-normalized per head and never gets near 448."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-448, 448, 4096), rng.standard_normal(4096),
        rng.uniform(-2 ** -6, 2 ** -6, 4096),           # subnormals
        [0.0, -0.0, 448.0, -448.0, 2 ** -9, 2 ** -10, 464.0]]).astype(
            np.float32)
    ours = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
    ref = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(ours.numpy(), ref)
    big = np.asarray([500.0, 1e4, -1e4], np.float32)
    assert torch.from_numpy(big).to(torch.float8_e4m3fn).view(
        torch.uint8).tolist() == [0x7E, 0x7E, 0xFE]
    assert big.astype(ml_dtypes.float8_e4m3fn).view(np.uint8).tolist() == [
        0x7F, 0x7F, 0xFF]


@pytest.mark.parametrize("bad", ["head_dim", "cache_len"])
def test_refuses_shapes_the_kernel_does_not_take(bad):
    d, s = (64, 128) if bad == "head_dim" else (128, 200)
    q = torch.zeros((2, 4, 1, d))
    k = torch.zeros((2, 2, s, d))
    with pytest.raises(ValueError):
        decode_attention_batched(q, k, k)


# (cache dtype, batch, head_dim) -> the plain version attend must take
ROUTES = {
    "fp8_b1": (torch.float8_e4m3fn, 1, 128, "batched"),
    "bf16_b2": (torch.bfloat16, 2, 128, "batched"),
    "bf16_b1": (torch.bfloat16, 1, 128, "single"),
    "bf16_b2_d64": (torch.bfloat16, 2, 64, "single"),
    "f32_b2": (torch.float32, 2, 128, "single"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_attend_routes_decode_steps(name):
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec, attend
    from qwen3_asr_tpu_torch.ops.decode_attention import (
        decode_attention_plain)
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched_plain)
    kv_dtype, b, d, route = ROUTES[name]
    q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((b, 4, 1, d)).astype(
        np.float32)).to(q_dtype)
    k, v = (torch.from_numpy(rng.standard_normal((3, b, 2, 256, d)).astype(
        np.float32)).to(kv_dtype) for _ in range(2))
    vf = torch.tensor([0, 9][:b], dtype=torch.int32)
    vt = torch.tensor([200, 140][:b], dtype=torch.int32)
    out = attend(q, k, v, AttnSpec(valid_from=vf, valid_to=vt),
                 scale=d ** -0.5, layer_idx=1)
    plain = (decode_attention_batched_plain if route == "batched"
             else decode_attention_plain)
    assert torch.equal(out, plain(q, k, v, vf, vt, layer_idx=1,
                                  sm_scale=d ** -0.5))


def test_attend_refuses_fp8_without_head_dim_128():
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec, attend
    q = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 1, 128, 64), dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="head_dim 128"):
        attend(q, k, k, AttnSpec(valid_to=torch.tensor([5])))
