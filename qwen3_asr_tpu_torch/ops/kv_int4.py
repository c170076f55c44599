"""The int4 KV cache: its layout, the plain quantize/pack/unpack, and the
write of a layer's new K and V as a CUDA kernel written by hand for Hopper
(``csrc/kv_int4_write.cu``) with its plain version and wrapper.

No TPU kernel: JAX's ``_kv_quantize`` and its ``dynamic_update_slice``
(``qwen3_asr_tpu/models/decoder.py:132-143,240-261``) run in XLA. JAX
stores ``jnp.int4`` values [L, B, n_kv, S, D] and bf16 scales
[L, B, n_kv, S, 1]. The port stores the same values packed two a byte,
``[L, B, n_kv, S, D/2]`` uint8: byte j of a row holds dims 2j (low nibble)
and 2j + 1 (high nibble), each as value + 8; the scales are the same bf16
planes.

What it computes per (token, head) row of x: ``scale = max(absmax/7,
1e-8)`` in f32, ``q = clip(round(x / scale), -8, 7)`` with the f32 scale
(round half to even), the scale stored rounded to bf16: JAX's bytes.

What bounds the write: nothing much (a few KB a decode step); what the
kernel saves is the chain of small kernels (absmax, divide, round, clip,
pack and four indexed writes, for K and for V) the plain version runs per
layer. One launch writes both K and V of a layer; the position comes from
a device pointer on a decode step, so a CUDA graph replays it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ._build import load
from .quant import div

HEAD_DIM = 128            # kD in csrc/kv_int4_write.cu
_X_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float → (int8 values in [-8, 7], f32 scale [..., 1])."""
    xf = x.float()
    scale = torch.clamp_min(div(xf.abs().amax(dim=-1, keepdim=True), 7.0),
                            1e-8)
    return torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int8), scale


def pack(q: torch.Tensor) -> torch.Tensor:
    """int8 values [..., D] → uint8 [..., D/2] (dims 2j low, 2j + 1 high)."""
    u = (q + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D/2] → int8 values [..., D]."""
    lo = (p & 15).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def dequantize_layer(payload: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """One layer [B, n_kv, S, D/2] + [B, n_kv, S, 1] → [B, n_kv, S, D] in
    ``dtype``: the values times the scale, both in ``dtype``, as JAX folds
    the scales for a prefill (``qwen3_asr_tpu/ops/attention.py:127-135``)."""
    return unpack(payload).to(dtype) * scale.to(dtype)


def _write(dst: torch.Tensor, val: torch.Tensor,
           write_pos: Union[int, torch.Tensor]) -> None:
    if not torch.is_tensor(write_pos):
        dst[:, :, write_pos:write_pos + val.shape[2]] = val
        return
    idx = write_pos.reshape(1) + torch.arange(val.shape[2], device=dst.device)
    dst.index_copy_(2, idx, val)


def kv_int4_write_plain(cache, layer: int, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        write_pos: Union[int, torch.Tensor]) -> None:
    """Quantize k_new / v_new [B, n_kv, T, D] and write them, with their
    scales, into layer ``layer`` of ``cache`` at keys write_pos .. + T - 1."""
    for new, payload, scales in ((k_new, cache.k, cache.k_scale),
                                 (v_new, cache.v, cache.v_scale)):
        q, scale = quantize_kv(new)
        _write(payload[layer], pack(q), write_pos)
        _write(scales[layer], scale.to(torch.bfloat16), write_pos)


def _library() -> ctypes.CDLL:
    lib = load("kv_int4_write")
    fn = lib.kv_int4_write_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(cache, layer, k_new, v_new, write_pos):
    b, nkv, t, d = k_new.shape
    n_layers, _, _, s_len, half = cache.k.shape
    dev = k_new.device
    if k_new.dtype not in _X_CODE or v_new.dtype != k_new.dtype:
        raise ValueError(f"kv_int4_write takes f32 or bf16 K/V, got "
                         f"{k_new.dtype}/{v_new.dtype}")
    if d != HEAD_DIM or half != d // 2 or v_new.shape != k_new.shape:
        raise ValueError(f"kv_int4_write needs head_dim {HEAD_DIM} and "
                         f"matching shapes, got {tuple(k_new.shape)}, "
                         f"{tuple(v_new.shape)} into {tuple(cache.k.shape)}")
    planes = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    if (cache.k.dtype != torch.uint8 or cache.v.dtype != torch.uint8
            or cache.k_scale.dtype != torch.bfloat16
            or cache.v_scale.dtype != torch.bfloat16
            or cache.k_scale.shape != (n_layers, b, nkv, s_len, 1)
            or cache.v.shape != cache.k.shape
            or cache.v_scale.shape != cache.k_scale.shape
            or cache.k.shape[1:3] != (b, nkv)):
        raise ValueError("the cache is not an int4 cache for these rows")
    if any(x.device != dev or not x.is_contiguous() for x in planes):
        raise ValueError("the cache planes must be contiguous, on K's device")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    if torch.is_tensor(write_pos):
        if (write_pos.dtype != torch.int64 or write_pos.numel() != 1
                or write_pos.device != dev):
            raise ValueError("a device write position is one int64 on K's "
                             "device")
        pos_ptr, pos_add = write_pos.data_ptr(), 0
    else:
        pos_ptr, pos_add = None, int(write_pos)
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    err = _library().kv_int4_write_fwd(
        _X_CODE[k_new.dtype], k_new.data_ptr(), v_new.data_ptr(),
        cache.k.data_ptr(), cache.v.data_ptr(), cache.k_scale.data_ptr(),
        cache.v_scale.data_ptr(), pos_ptr, pos_add, layer, b, nkv, t, s_len,
        d, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_int4_write kernel launch failed: CUDA error "
                           f"{err}")
    kv_int4_write.launches += 1


def kv_int4_write(cache, layer: int, k_new: torch.Tensor,
                  v_new: torch.Tensor,
                  write_pos: Union[int, torch.Tensor]) -> None:
    """Write a layer's new K and V [B, n_kv, T, D] into the int4 ``cache``
    (a ``models.decoder.KVCache`` with scale planes) at ``write_pos``: a
    host int, or a 0-d int64 tensor on the cache's device. A CUDA tensor
    launches the kernel or raises; only a CPU tensor takes the plain
    version."""
    if k_new.device.type == "cpu":
        kv_int4_write_plain(cache, layer, k_new, v_new, write_pos)
        return
    _launch(cache, layer, k_new, v_new, write_pos)


kv_int4_write.launches = 0
