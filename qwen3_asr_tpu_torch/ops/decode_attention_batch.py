"""Batch-major decode attention against the KV cache: a CUDA kernel written
by hand for Hopper (``csrc/decode_attention_batch.cu``), its plain PyTorch
version, and the wrapper.

Replaces the TPU kernel ``qwen3_asr_tpu/ops/decode_attention_batch.py``
``_kernel`` (public ``decode_attention_batched``).

What it computes: the function of ``ops.decode_attention`` (one query
token per row against one layer of the stacked cache ``[L,B,Nkv,S,128]``
at ``layer_idx``, over the keys in ``[valid_from, valid_to)``) with the
TPU kernel's rounding points: ``q·scale`` rounded to bf16, K and V widened
(fp8, bf16) or rounded (f32) to bf16, scores and the softmax sum in f32,
``p`` rounded to bf16 before it weights V, and a safe divide (a row with no
live key gives 0). K and V may be fp8 (``torch.float8_e4m3fn``, the JAX
package's plain ``astype`` cache with no scales), bf16 or f32.

What bounds it on the H100: the bytes of the live cache,
``2·B·Nkv·live·128·itemsize`` per layer. What the design does about it:
one block per (128-key block, KV head, row) reads only the live rows of
its K and V tiles with 16-byte loads and widens them in shared memory;
a second kernel combines the blocks' partial softmax states by m and l.
Both the kernel and the plain version take the softmax max per 128-key
block (the TPU kernel takes a running max), so p is rounded against the
same max on both.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import load
from .attention import MASK_VALUE

HEAD_DIM = 128            # kD in csrc/decode_attention_batch.cu
BLOCK_S = 128             # kBlockS: keys per block, and S must be a multiple
_MAX_GROUP = 8            # kMaxG
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def decode_attention_batched_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, valid_from: torch.Tensor,
                                   valid_to: torch.Tensor, *, layer_idx: int,
                                   sm_scale: float) -> torch.Tensor:
    """Dense restatement of the kernel's function, with its rounding points
    and its per-block softmax max and combine."""
    if k.dim() == 5:
        k, v = k[layer_idx], v[layer_idx]
    b, nq, _, d = q.shape
    _, nkv, s_len, _ = k.shape
    g, n_blk = nq // nkv, s_len // BLOCK_S
    bf16 = torch.bfloat16
    qs = (q.float() * sm_scale).to(bf16).float().reshape(b, nkv, g, d)
    kb = k.to(bf16).float()
    vb = v.to(bf16).float().reshape(b, nkv, n_blk, BLOCK_S, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qs, kb)
    cols = torch.arange(s_len, device=q.device)[None, :]
    live = ((cols >= valid_from.long()[:, None])
            & (cols < valid_to.long()[:, None]))[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, MASK_VALUE))
    s = s.reshape(b, nkv, g, n_blk, BLOCK_S)
    live = live.reshape(b, 1, 1, n_blk, BLOCK_S)
    m = s.amax(dim=-1, keepdim=True)                     # per block
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)                                    # [b,h,g,blk]
    acc = torch.einsum("bhgjc,bhjcd->bhgjd", p.to(bf16).float(), vb)
    m = m[..., 0]
    # Blocks with no live key have m = MASK_VALUE and l = 0, so their
    # weight is 0 beside any live block, and a row with none gives 0.
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    l_all = (l * w).sum(dim=-1)[..., None]
    out = (acc * w[..., None]).sum(dim=-2)
    out = out / torch.where(l_all == 0.0, torch.ones_like(l_all), l_all)
    return out.reshape(b, nq, 1, d).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = load("decode_attention_batch")
    fn = lib.decode_attention_batch_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, vf, vt, *, layer_idx, sm_scale):
    b, nq, _, d = q.shape
    n_layers = k.shape[0] if k.dim() == 5 else 1
    nkv, s_len = k.shape[-3], k.shape[-2]
    dev = q.device
    if q.dtype not in _Q_CODE:
        raise ValueError(f"decode_attention_batched takes f32 or bf16 q, got "
                         f"{q.dtype}")
    if k.dtype not in _KV_CODE or v.dtype != k.dtype:
        raise ValueError(f"decode_attention_batched takes one cache dtype "
                         f"of {list(_KV_CODE)}, got {k.dtype}/{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention_batched needs contiguous q, k "
                         "and v")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the cache must be 16-byte aligned")
    if v.shape != k.shape or k.shape[-4] != b or k.dim() not in (4, 5):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if nq // nkv > _MAX_GROUP:
        raise ValueError(f"query group {nq // nkv} exceeds {_MAX_GROUP}")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {n_layers})")
    for x, name in ((vf, "kv_valid_from"), (vt, "kv_valid_to")):
        if (x.dtype != torch.int32 or x.shape != (b,) or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor "
                             f"on {dev}")
    out = torch.empty_like(q)
    n_blk = s_len // BLOCK_S
    m = torch.empty((b, nkv, n_blk, nq // nkv), dtype=torch.float32,
                    device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, nkv, n_blk, nq // nkv, d), dtype=torch.float32,
                      device=dev)
    err = _library().decode_attention_batch_fwd(
        _Q_CODE[q.dtype], _KV_CODE[k.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), vf.data_ptr(), vt.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), layer_idx, b, nq, nkv,
        s_len, d, float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_batched kernel launch failed: "
                           f"CUDA error {err}")
    decode_attention_batched.launches += 1
    return out


def decode_attention_batched(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, layer_idx: int = 0,
                             kv_valid_from: Optional[torch.Tensor] = None,
                             kv_valid_to: Optional[torch.Tensor] = None,
                             sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Nq, 1, 128] f32/bf16 → [B, Nq, 1, 128] of q's dtype.

    k/v: one layer's cache [B, Nkv, S, 128] (``layer_idx`` ignored) or the
    stacked cache [L, B, Nkv, S, 128], fp8/bf16/f32, S a multiple of 128.
    A CUDA tensor launches the kernel or raises; only a CPU tensor takes
    the plain version."""
    b, nq, t, d = q.shape
    if t != 1:
        raise ValueError("decode_attention_batched is for single-token "
                         "queries")
    nkv, s_len = k.shape[-3], k.shape[-2]
    if d != HEAD_DIM or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode_attention_batched needs head_dim "
                         f"{HEAD_DIM}, got {d}")
    if s_len % BLOCK_S:
        raise ValueError(f"cache length {s_len} is not a multiple of "
                         f"{BLOCK_S}")
    if nq % nkv:
        raise ValueError(f"query heads {nq} not divisible by kv heads {nkv}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    dev = q.device
    vf = (torch.zeros((b,), dtype=torch.int32, device=dev)
          if kv_valid_from is None else kv_valid_from.to(dev, torch.int32))
    vt = (torch.full((b,), s_len, dtype=torch.int32, device=dev)
          if kv_valid_to is None else kv_valid_to.to(dev, torch.int32))
    layer_idx = int(layer_idx) if k.dim() == 5 else 0
    if dev.type == "cpu":
        return decode_attention_batched_plain(q, k, v, vf, vt,
                                              layer_idx=layer_idx,
                                              sm_scale=float(sm_scale))
    return _launch(q, k, v, vf.contiguous(), vt.contiguous(),
                   layer_idx=layer_idx, sm_scale=float(sm_scale))


decode_attention_batched.launches = 0
