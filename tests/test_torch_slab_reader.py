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
