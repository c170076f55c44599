"""The port's decode attention (plain version, CPU) against the JAX Pallas
kernel in interpret mode, to 2e-5 in f32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.ops.decode_attention import decode_attention as jax_decode
from qwen3_asr_tpu_torch.ops.attention import AttnSpec, attend
from qwen3_asr_tpu_torch.ops.decode_attention import (decode_attention,
                                                      split_plan)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# (layers, b, nq, nkv, s, d, valid_from, valid_to, layer_idx); layers=0 is
# one layer's cache. Row 1 of the stacked cases lives in a later block.
CASES = {
    "one_layer": (0, 2, 4, 2, 200, 64, [0, 30], [200, 120], 0),
    "one_layer_empty_row": (0, 2, 2, 1, 64, 24, [5, 40], [60, 40], 0),
    "stacked_layer1": (3, 2, 4, 2, 256, 64, [3, 130], [90, 256], 1),
    "stacked_d128_late_block": (2, 3, 16, 8, 384, 128,
                                [64, 200, 0], [453 - 69, 384, 1], 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax_interpret(name):
    n_layers, b, nq, nkv, s, d, vf, vt, layer = CASES[name]
    rng = np.random.default_rng(len(name))
    cache_shape = ((n_layers,) if n_layers else ()) + (b, nkv, s, d)
    q = rng.standard_normal((b, nq, 1, d)).astype(np.float32)
    k = rng.standard_normal(cache_shape).astype(np.float32)
    v = rng.standard_normal(cache_shape).astype(np.float32)
    vf = np.asarray(vf, np.int32)
    vt = np.asarray(vt, np.int32)

    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     layer_idx=layer, kv_valid_from=jnp.asarray(vf),
                     kv_valid_to=jnp.asarray(vt), interpret=True)
    ours = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), layer_idx=layer,
                            kv_valid_from=torch.from_numpy(vf),
                            kv_valid_to=torch.from_numpy(vt))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_attend_routes_decode_step_with_layer_idx():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 2, 2, 40, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 2, 2, 40, 32)).astype(np.float32))
    spec = AttnSpec(valid_from=torch.tensor([0, 4], dtype=torch.int32),
                    valid_to=torch.tensor([17, 40], dtype=torch.int32))
    out = attend(q, k, v, spec, layer_idx=2)
    ref = decode_attention(q, k[2], v[2], kv_valid_from=spec.valid_from,
                           kv_valid_to=spec.valid_to)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("s_len,batch,nkv,d,itemsize", [
    (768, 1, 8, 128, 2), (768, 8, 8, 128, 2), (768, 1, 8, 128, 4),
    (256, 1, 2, 48, 4), (300, 2, 2, 24, 2), (4096, 1, 8, 128, 2),
    (5, 1, 1, 8, 4)])
def test_decode_split_plan_tiles_the_cache(s_len, batch, nkv, d, itemsize):
    """The kernel's chunks tile [0, S) exactly, a chunk of K fits the
    kernel's 16 KB, and the grid fills the card's 132 SMs where S allows."""
    chunk, n_split = split_plan(s_len, batch, nkv, d, itemsize)
    starts = [j * chunk for j in range(n_split)]
    assert starts[0] == 0 and starts[-1] < s_len <= starts[-1] + chunk
    assert chunk & (chunk - 1) == 0 and 16 <= chunk <= 128
    assert chunk * d * itemsize <= 16384
    if chunk > 16:
        assert n_split * nkv * batch >= 132


def test_decode_split_plan_fills_the_card_at_batch_1():
    chunk, n_split = split_plan(768, 1, 8, 128, 2)   # preset:1.7b, bf16
    assert (chunk, n_split) == (32, 24) and n_split * 8 >= 132
