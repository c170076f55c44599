"""QK-norm + RoPE + the KV-cache write (``ops/qk_rope_kv.py``) on the CPU
against the JAX decoder's own chain: ``rms_norm`` -> ``apply_rope`` on q
and k, then ``astype`` or ``_kv_quantize`` and ``dynamic_update_slice``
into the stacked cache (``qwen3_asr_tpu/models/decoder.py:132-170,
240-261``), the same numpy inputs through both.

Covered: f32, bf16, fp8 and int4 caches (fp8 and int4 from f32 and from
bf16 rows); T = 1 at a 0-d position tensor (the decode step's), T = 5 at a
host position, and a write that ends at the last key; head_dim 48 (the
in-repo ``trained_ckpt``) and 128 (int4 at 128 only); B = 1 and 3.
Tolerances, each against JAX:
- f32 q and cache: 1e-6 relative, plus 1e-6 of the largest |value| (the
  two frameworks sum the squares in different orders, and RoPE's sum can
  cancel down to a value far below its terms' ulp);
- bf16 q and cache: one bf16 ulp;
- fp8 bytes equal wherever |value| <= 448; beyond it the port saturates
  to +-448 (0x7e), where ``ml_dtypes`` gives NaN (ROADMAP §3);
- int4 payload and scales byte-equal from f32 rows; from bf16 rows the
  nibbles within 1 and the scales within one bf16 ulp, where K may round
  one ulp apart.
Keys outside the write stay zero in both.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models import decoder as jdec
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.config import DecoderConfig
from qwen3_asr_tpu_torch.models.decoder import (KVCache, decoder_forward,
                                                init_kv_cache)
from qwen3_asr_tpu_torch.ops.attention import AttnSpec
from qwen3_asr_tpu_torch.ops.kv_int4 import unpack
from qwen3_asr_tpu_torch.ops.qk_rope_kv import (check_head_dim,
                                                qk_rope_kv_write,
                                                qk_rope_kv_write_plain)

EPS = 1e-6
S_LEN = 24
LAYERS, LAYER = 3, 1
F32_RTOL = 1e-6
FP8_MAX = 448.0

T_DT = {"f32": torch.float32, "bf16": torch.bfloat16,
        "fp8": torch.float8_e4m3fn, "int4": torch.int4}
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16,
        "fp8": jnp.float8_e4m3fn, "int4": jnp.int4}

# (rows dtype, cache dtype, head_dim, nq, nkv)
ROUTES = {
    "f32_d48": ("f32", "f32", 48, 4, 2),
    "f32_d128": ("f32", "f32", 128, 4, 2),
    "bf16_d48": ("bf16", "bf16", 48, 4, 2),
    "bf16_d128": ("bf16", "bf16", 128, 4, 2),
    "fp8_from_bf16_d48": ("bf16", "fp8", 48, 4, 2),
    "fp8_from_bf16_d128": ("bf16", "fp8", 128, 4, 2),
    "fp8_from_f32_d48": ("f32", "fp8", 48, 4, 2),
    "fp8_from_f32_d128": ("f32", "fp8", 128, 4, 2),
    "int4_from_f32_d128": ("f32", "int4", 128, 4, 2),
    "int4_from_bf16_d128": ("bf16", "int4", 128, 4, 2),
}
# (T, position, a device position?)
WRITES = {
    "t1_device": (1, 9, True),
    "t5_host": (5, 3, False),
    "t5_ends_at_last_key": (5, S_LEN - 5, False),
}


def _cfg(d, nq, nkv):
    return DecoderConfig(vocab_size=8, hidden_size=8, intermediate_size=8,
                         num_hidden_layers=LAYERS, num_attention_heads=nq,
                         num_key_value_heads=nkv, head_dim=d)


def _inputs(rows, b, t, d, nq, nkv, big_v):
    """q, k, v [B, T, heads * D], norms [D] (torch, in ``rows``), cos/sin
    [B, T, D] f32, from a numpy seed. V gets values past +-448 for an fp8
    cache."""
    rng = np.random.default_rng(b * 100 + t * 10 + d)
    dt = T_DT[rows]

    def mk(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).to(dt)

    q, k = mk(b, t, nq * d, scale=2.0), mk(b, t, nkv * d, scale=2.0)
    v = mk(b, t, nkv * d, scale=3.0)
    if big_v:
        big = torch.tensor([500.0, -1000.0, 449.0, -460.0, 470.0], dtype=dt)
        idx = torch.arange(0, v.numel(), 37)
        v.view(-1)[idx] = big[torch.arange(idx.numel()) % len(big)]
    q_norm, k_norm = mk(d, scale=0.2, shift=1.0), mk(d, scale=0.2, shift=1.0)
    pos = rng.integers(0, 4000, (b, t)).astype(np.int32)
    cos, sin = (np.asarray(a) for a in jdec.rope_cos_sin(jnp.asarray(pos), d,
                                                         1e6))
    return (q, k, v, q_norm, k_norm, torch.from_numpy(cos.copy()),
            torch.from_numpy(sin.copy()))


def _jnp(x: torch.Tensor, rows: str):
    return jnp.asarray(x.float().numpy()).astype(J_DT[rows])


def _jax_chain(inputs, rows, cache_dt, b, t, d, nq, nkv, pos):
    """The JAX decoder's lines for these inputs: (q [B, nq, T, D], the
    stacked cache after the write)."""
    q, k, v, q_norm, k_norm, cos, sin = inputs
    q, k, v, q_norm, k_norm = (_jnp(x, rows) for x in (q, k, v, q_norm,
                                                       k_norm))
    cos, sin = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    q = q.reshape(b, t, nq, d).transpose(0, 2, 1, 3)
    k = k.reshape(b, t, nkv, d).transpose(0, 2, 1, 3)
    v = v.reshape(b, t, nkv, d).transpose(0, 2, 1, 3)
    q = jdec.apply_rope(jdec.rms_norm(q, q_norm, EPS), cos, sin)
    k = jdec.apply_rope(jdec.rms_norm(k, k_norm, EPS), cos, sin)
    shape = (LAYERS, b, nkv, S_LEN, d)
    if cache_dt == "int4":
        k_w, ks_w = jdec._kv_quantize(k)
        v_w, vs_w = jdec._kv_quantize(v)
        sshape = shape[:-1] + (1,)
        writes = [(jnp.zeros(shape, jnp.int4), k_w),
                  (jnp.zeros(shape, jnp.int4), v_w),
                  (jnp.zeros(sshape, jnp.bfloat16), ks_w),
                  (jnp.zeros(sshape, jnp.bfloat16), vs_w)]
    else:
        writes = [(jnp.zeros(shape, J_DT[cache_dt]), k.astype(J_DT[cache_dt])),
                  (jnp.zeros(shape, J_DT[cache_dt]), v.astype(J_DT[cache_dt]))]
    cache = [jax.lax.dynamic_update_slice(dst, val[None],
                                          (LAYER, 0, 0, pos, 0))
             for dst, val in writes]
    if cache_dt == "int4":
        cache[:2] = [c.astype(jnp.int8) for c in cache[:2]]
    return q, cache


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) as integers in the order of their values,
    so that one ulp is a difference of 1."""
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, 0x8000 - (b & 0x7fff), 0x8000 + b)


def _bf16_bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _assert_bf16_ulp(ours, ref, what):
    diff = np.abs(_ordered(_bf16_bits(ours)) - _ordered(_bf16_bits(ref)))
    assert diff.max() <= 1, (f"{what}: {int((diff > 1).sum())} values more "
                             f"than one bf16 ulp from JAX's")


def _assert_rows(ours: torch.Tensor, ref, rows: str, what: str):
    if rows == "f32":
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(ref).max(),
                                   err_msg=what)
    else:
        _assert_bf16_ulp(ours, ref, what)


def _fp8_bytes(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("b", [1, 3], ids=["b1", "b3"])
@pytest.mark.parametrize("write", list(WRITES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_qk_rope_kv_matches_jax(route, write, b):
    rows, cache_dt, d, nq, nkv = ROUTES[route]
    t, pos, on_device = WRITES[write]
    inputs = _inputs(rows, b, t, d, nq, nkv, big_v=cache_dt == "fp8")
    cache = init_kv_cache(_cfg(d, nq, nkv), b, S_LEN, T_DT[cache_dt], "cpu")
    q = qk_rope_kv_write(*inputs, EPS, cache, LAYER,
                         torch.tensor(pos) if on_device else pos)
    q_ref, cache_ref = _jax_chain(inputs, rows, cache_dt, b, t, d, nq, nkv,
                                  pos)
    assert q.shape == (b, nq, t, d) and q.is_contiguous()
    _assert_rows(q, q_ref, rows, "q")

    if cache_dt in ("f32", "bf16"):
        for ours, ref, name in zip(cache, cache_ref, "kv"):
            _assert_rows(ours, ref, rows, name)
    elif cache_dt == "fp8":
        v = inputs[2].float().reshape(b, t, nkv, d).transpose(1, 2)
        for ours, ref, name in zip(cache, cache_ref, "kv"):
            got, want = _fp8_bytes(ours), _fp8_bytes(ref)
            big = np.zeros(got.shape, bool)
            if name == "v":
                big[LAYER, :, :, pos:pos + t] = (v.abs() > FP8_MAX).numpy()
                assert big.any()
                # the port saturates where ml_dtypes gives NaN
                assert np.all((got[big] & 0x7f) == 0x7e)
            np.testing.assert_array_equal(got[~big], want[~big],
                                          err_msg=f"{name} fp8 bytes")
    else:
        # the written keys; elsewhere the port's bytes stay 0 (a zeroed
        # int4 cache holds value -8 at scale 0, JAX's holds 0 at scale 0)
        at = (LAYER, slice(None), slice(None), slice(pos, pos + t))
        payload = [unpack(c[at]).numpy() for c in cache[:2]]
        want = [np.asarray(c)[at] for c in cache_ref[:2]]
        for c in cache[:2]:
            rest = c.clone()
            rest[at] = 0
            assert not rest.any()
        if rows == "f32":
            for ours, ref in zip(payload, want):
                np.testing.assert_array_equal(ours, ref)
            for ours, ref in zip(cache[2:], cache_ref[2:]):
                np.testing.assert_array_equal(_bf16_bits(ours),
                                              _bf16_bits(ref))
        else:
            assert np.abs(payload[0].astype(int) - want[0]).max() <= 1
            _assert_bf16_ulp(cache[2], cache_ref[2], "k scale")
            # V is stored as it comes: its bytes equal
            np.testing.assert_array_equal(payload[1], want[1])
            np.testing.assert_array_equal(_bf16_bits(cache[3]),
                                          _bf16_bits(cache_ref[3]))


@pytest.mark.parametrize("head_dim", [2, 24, 48, 64, 96, 128])
def test_check_head_dim_takes_even_widths_up_to_128(head_dim):
    """One warp holds a row, up to 4 elements a lane."""
    check_head_dim(head_dim)


@pytest.mark.parametrize("head_dim", [0, 47, 130, 256])
def test_check_head_dim_refuses_what_the_kernel_does_not_take(head_dim):
    with pytest.raises(ValueError, match="head_dim"):
        check_head_dim(head_dim)


@pytest.mark.parametrize("cache_dt", ["f32", "int4"])
def test_decoder_runs_the_op_once_per_layer(monkeypatch, cache_dt):
    """``decoder_forward`` writes each layer's K/V through the one op, on a
    prefill (host position) and on a decode step (device position); the
    cache it leaves equals the same op's plain version called in its
    place."""
    cfg = DecoderConfig(vocab_size=16, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=LAYERS, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=128)
    gen = torch.Generator().manual_seed(0)
    params = tdec.init_decoder_params(cfg, gen, "cpu")
    calls = []

    def counted(*args):
        calls.append(args[-2:])
        return qk_rope_kv_write_plain(*args)

    monkeypatch.setattr(tdec, "qk_rope_kv_write", counted)
    cache = init_kv_cache(cfg, 1, 128, T_DT[cache_dt], "cpu")
    x = torch.randn((1, 6, 32), generator=gen)
    pos = torch.arange(6)[None]
    decoder_forward(params, cfg, x, pos, cache, 0, AttnSpec(causal=True))
    step = torch.tensor(6)
    decoder_forward(params, cfg, x[:, :1], pos[:, :1] + 6, cache, step,
                    AttnSpec(valid_from=torch.tensor([0], dtype=torch.int32),
                             valid_to=torch.tensor([7], dtype=torch.int32)))
    assert [layer for layer, _ in calls] == list(range(LAYERS)) * 2
    assert all(p == 0 for _, p in calls[:LAYERS])
    assert all(p is step for _, p in calls[LAYERS:])
    assert isinstance(cache, KVCache) and cache.k[:, :, :, :7].any()
    assert not cache.k[:, :, :, 7:].any() and not cache.v[:, :, :, 7:].any()
