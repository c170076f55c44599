"""The port's flash attention (plain version, CPU) against the JAX Pallas
kernel in interpret mode: out, m and l to 2e-5 in f32, and out to 4e-3 in
bf16."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.ops.flash_attention import flash_attention as jax_flash
from qwen3_asr_tpu_torch.ops.attention import AttnSpec, attend
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention

TOL = 2e-5   # docs/ARCHITECTURE.md: flash vs reference in f32


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# (b, nq, nkv, t, s, d, kwargs)
CASES = {
    "full": (2, 4, 2, 40, 40, 32, {}),
    "causal_gqa": (1, 4, 2, 64, 64, 64, {"causal": True}),
    "causal_unaligned_q_offset": (
        2, 2, 1, 30, 150, 64, {"causal": True, "q_offset": [80, 100]}),
    "valid_from_left_pad": (
        2, 4, 2, 48, 48, 24,
        {"causal": True, "valid_from": [10, 47]}),
    "valid_from_fully_masked_rows": (
        1, 2, 2, 20, 20, 24, {"valid_from": [25]}),
    "valid_to": (2, 2, 2, 50, 50, 64, {"valid_to": [13, 50]}),
    "window_block": (
        2, 4, 4, 75, 75, 64, {"window_block": 25, "valid_to": [75, 60]}),
    "head_dim_128_prefill": (
        1, 4, 2, 37, 128, 128, {"causal": True, "valid_from": [5]}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_jax_interpret(name):
    b, nq, nkv, t, s, d, kw = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    q = rng.standard_normal((b, nq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    vf = np.asarray(kw.get("valid_from", [0] * b), np.int32)
    vt = np.asarray(kw.get("valid_to", [s] * b), np.int32)
    q_off = np.asarray(kw.get("q_offset", [0] * b), np.int32)
    common = dict(causal=kw.get("causal", False),
                  window_block=kw.get("window_block", 0))

    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    q_offset=jnp.asarray(q_off),
                    kv_valid_from=jnp.asarray(vf), kv_valid_to=jnp.asarray(vt),
                    interpret=True, return_residuals=True, **common)
    ours = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), q_offset=torch.from_numpy(q_off),
                           kv_valid_from=torch.from_numpy(vf),
                           kv_valid_to=torch.from_numpy(vt),
                           return_residuals=True, **common)
    for r, o, what in zip(ref, ours, ("out", "m", "l")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL, err_msg=what)


# bf16 inputs: (b, nq, nkv, t, s, d, kwargs). Rows at or after valid_from
# are compared (ROADMAP.md §3: pad rows are excluded).
BF16_CASES = {
    "causal_gqa_left_pad": (1, 4, 2, 70, 128, 64,
                            {"causal": True, "valid_from": [10]}),
    "window_valid_to": (2, 4, 4, 75, 75, 64,
                        {"window_block": 25, "valid_to": [75, 60]}),
}
# The TPU kernel rounds p to v's dtype before P·V. The plain version does
# the same, so the two differ by summation order, i.e. at most one bf16
# rounding of the output (0 and 1.95e-3 measured on these two cases).
# Keeping p in f32 instead moves the output by 7.8e-3 on both, so 4e-3
# tells the two apart.
BF16_TOL = 4e-3


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_flash_bf16_rounds_p_as_the_tpu_kernel(name):
    b, nq, nkv, t, s, d, kw = BF16_CASES[name]
    rng = np.random.default_rng(10 + list(BF16_CASES).index(name))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, nq, t, d), (b, nkv, s, d), (b, nkv, s, d)))
    vf = np.asarray(kw.get("valid_from", [0] * b), np.int32)
    vt = np.asarray(kw.get("valid_to", [s] * b), np.int32)
    common = dict(causal=kw.get("causal", False),
                  window_block=kw.get("window_block", 0))
    ref = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    kv_valid_from=jnp.asarray(vf), kv_valid_to=jnp.asarray(vt),
                    interpret=True, **common)
    ours = flash_attention(*(torch.from_numpy(x).bfloat16()
                             for x in (q, k, v)),
                           kv_valid_from=torch.from_numpy(vf),
                           kv_valid_to=torch.from_numpy(vt), **common)
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    ours = ours.float().numpy()
    for row in range(b):
        np.testing.assert_allclose(ours[row, :, vf[row]:],
                                   ref[row, :, vf[row]:], atol=BF16_TOL,
                                   rtol=0)


def test_attend_routes_prefill_to_flash_on_cpu():
    """attend() with a prefill spec equals flash_attention on the same
    inputs and does not count a kernel launch on the CPU."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 9, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 1, 9, 16)).astype(np.float32))
    spec = AttnSpec(causal=True, valid_from=torch.tensor([2], dtype=torch.int32))
    before = flash_attention.launches
    out = attend(q, k, v, spec)
    ref = flash_attention(q, k, v, causal=True, kv_valid_from=spec.valid_from)
    assert torch.equal(out, ref)
    assert flash_attention.launches == before
