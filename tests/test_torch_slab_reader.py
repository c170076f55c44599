"""The port's KV slab-read probe (plain version, CPU) against a numpy
restatement of the TPU kernel ``_slab_kernel`` (``tools_perf/attn_phase.py``
:108-118), to 1e-6 relative.

That kernel has no interpret-mode test in the JAX package, and its module
cannot be imported on the CPU (it builds TPU-only Pallas calls at import),
so the restatement below is the reference: grid (B // rows, S // bs), the
output block zeroed at j == 0, then ``o += (k[:, 0, 0, :] + v[:, 0, 0, :])
+ seed`` in f32 for every slab j in order."""
import ml_dtypes
import numpy as np
import pytest

import torch

from qwen3_asr_tpu_torch.ops.slab_reader import slab_read


def slab_kernel_numpy(k, v, seed, rows, bs):
    """k/v: one layer [B, Nkv, S, D] as float32 numpy (the kernel widens
    each slab to f32 before it adds)."""
    b, _, s, d = k.shape
    o = np.zeros((b, d), np.float32)
    for i in range(b // rows):
        for j in range(s // bs):
            kb = k[i * rows:(i + 1) * rows, :, j * bs:(j + 1) * bs]
            vb = v[i * rows:(i + 1) * rows, :, j * bs:(j + 1) * bs]
            acc = kb[:, 0, 0, :] + vb[:, 0, 0, :]
            o[i * rows:(i + 1) * rows] += acc + np.float32(seed)
    return o


@pytest.mark.parametrize("dtype,layer,bs,seed", [
    ("bf16", 0, 128, 0), ("bf16", 2, 64, 7), ("fp8", 1, 128, -3),
    ("fp8", 2, 32, 1000)])
def test_plain_matches_slab_kernel_restatement(dtype, layer, bs, seed):
    rng = np.random.default_rng(bs + layer)
    shape = (3, 4, 2, 256, 128)
    k = rng.standard_normal(shape).astype(np.float32) * 4
    v = rng.standard_normal(shape).astype(np.float32) * 4
    if dtype == "fp8":
        k8, v8 = (x.astype(ml_dtypes.float8_e4m3fn) for x in (k, v))
        tk, tv = (torch.from_numpy(x.view(np.uint8).copy()).view(
            torch.float8_e4m3fn) for x in (k8, v8))
        kf, vf = k8.astype(np.float32), v8.astype(np.float32)
    else:
        tk = torch.from_numpy(k).to(torch.bfloat16)
        tv = torch.from_numpy(v).to(torch.bfloat16)
        kf, vf = tk.float().numpy(), tv.float().numpy()
    ref = slab_kernel_numpy(kf[layer], vf[layer], seed, rows=2, bs=bs)
    ours = slab_read(tk, tv, layer_idx=layer, seed=seed, block_s=bs)
    assert ours.dtype == torch.float32 and ours.shape == (4, 128)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_refuses_a_cache_that_does_not_tile():
    k = torch.zeros((1, 2, 2, 100, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        slab_read(k, k, block_s=64)


def _int4_cache(rng, shape):
    """A packed int4 cache [.., S, 64] uint8 and its bf16 scales [.., S, 1],
    with the values unpacked to numpy as the restatement reads them."""
    vals = rng.integers(-8, 8, size=shape).astype(np.int8)
    packed = ((vals[..., 0::2] + 8).astype(np.uint8)
              | ((vals[..., 1::2] + 8).astype(np.uint8) << 4))
    scale = torch.from_numpy(
        rng.uniform(0.01, 0.3, size=shape[:-1] + (1,)).astype(np.float32)
    ).to(torch.bfloat16)
    return torch.from_numpy(packed), scale, vals.astype(np.float32)


@pytest.mark.parametrize("layer,bs,seed", [(0, 128, 0), (2, 32, -5)])
def test_int4_plain_matches_restatement(layer, bs, seed):
    """The int4 shape: each slab's sliver term is the dequantized value
    (payload times its row's scale), K plus V plus the seed, summed over
    the slabs in f32."""
    rng = np.random.default_rng(40 + layer)
    shape = (3, 4, 2, 256, 128)
    k, ks, kf = _int4_cache(rng, shape)
    v, vs, vf = _int4_cache(rng, shape)
    kd = kf * ks.float().numpy()
    vd = vf * vs.float().numpy()
    ref = slab_kernel_numpy(kd[layer], vd[layer], seed, rows=2, bs=bs)
    ours = slab_read(k, v, layer_idx=layer, seed=seed, block_s=bs,
                     k_scale=ks, v_scale=vs)
    assert ours.dtype == torch.float32 and ours.shape == (4, 128)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch,nkv,s_len,dtype,row", [
    (8, 8, 768, torch.bfloat16, 256), (8, 8, 768, torch.float8_e4m3fn, 128),
    (8, 8, 768, torch.int4, 66), (96, 8, 512, torch.int4, 66)])
def test_slab_bytes(batch, nkv, s_len, dtype, row):
    """The bytes one call reads: K and V of one layer, a row of 128 dims
    (int4: the 64-byte payload and the 2-byte scale)."""
    from qwen3_asr_tpu_torch.ops.slab_reader import slab_bytes
    assert slab_bytes(batch, nkv, s_len, dtype) == 2 * batch * nkv * s_len * row


def test_int4_needs_both_scales():
    k = torch.zeros((1, 2, 2, 128, 64), dtype=torch.uint8)
    s = torch.ones((1, 2, 2, 128, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        slab_read(k, k, k_scale=s)
