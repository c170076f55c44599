"""The KV slab-read probe: a CUDA kernel written by hand for Hopper
(``csrc/slab_reader.cu``), its plain PyTorch version, and the wrapper.

Replaces the TPU kernel ``tools_perf/attn_phase.py`` ``_slab_kernel``
(built by ``make_slab_reader``). It reads one layer of the stacked cache
``[L, B, Nkv, S, 128]``, every byte of it, and returns that kernel's
``[B, 128]`` f32 output over slabs of ``bs`` positions::

    o[b, :] = sum over j of (k[b, 0, j*bs, :] + v[b, 0, j*bs, :] + seed)

It reads the layer as kernel #3 (``ops/decode_attention_batch.py``) reads
a fully live cache: the same plan (``batch_plan``), one chunk a block, its
K and V rows by one bulk copy each into shared memory, one launch with a
ticket per row. It does no work worth counting besides the read, so
its time is the read ceiling of that kernel's design on this card
(``tools_perf/attn_phase.py`` measures it).

An int4 cache (the packed ``uint8`` payload ``[L, B, Nkv, S, 64]`` with
its bf16 scale planes ``k_scale``/``v_scale`` ``[L, B, Nkv, S, 1]``,
``ops/kv_int4.py``'s layout) is read as #3's int4 route reads it: the
payload rows and the chunk's scale rows by bulk copies. Its term is the
dequantized value, ``k * ks + v * vs + seed``, so the scales are read for
what they hold.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import load
from .autograd import refuse_grad
from .decode_attention import ticket_buffer
from .decode_attention_batch import (CACHE_TILE, HEAD_DIM, INT4_PLAN_ITEMSIZE,
                                     batch_plan)
from .kv_int4 import unpack

_DTYPE_CODE = {torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_INT4_CODE = 3


def slab_bytes(batch: int, nkv: int, s_len: int, dtype: torch.dtype) -> int:
    """Bytes one call moves from device memory: K and V of one layer, each
    read once (``torch.int4``: the packed payload, 64 bytes a row, and a
    2-byte scale a row)."""
    row = HEAD_DIM // 2 + 2 if dtype == torch.int4 else (
        HEAD_DIM * torch.empty((), dtype=dtype).element_size())
    return 2 * batch * nkv * s_len * row


def slab_read_plain(k: torch.Tensor, v: torch.Tensor, *, layer_idx: int,
                    seed: int, block_s: int,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe's output without the read: the sliver terms summed."""
    if k.dim() == 5:
        k, v = k[layer_idx], v[layer_idx]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer_idx], v_scale[layer_idx]
    ks, vs = k[:, 0, ::block_s], v[:, 0, ::block_s]
    if k_scale is not None:
        ks = unpack(ks).float() * k_scale[:, 0, ::block_s].float()
        vs = unpack(vs).float() * v_scale[:, 0, ::block_s].float()
    terms = (ks.float() + vs.float()) + float(seed)
    return terms.sum(dim=1)


def _library() -> ctypes.CDLL:
    lib = load("slab_reader")
    fn = lib.slab_read_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(k, v, ks, vs, *, layer_idx, seed, block_s):
    n_layers = k.shape[0] if k.dim() == 5 else 1
    b, nkv, s_len, width = k.shape[-4:]
    dev = k.device
    int4 = ks is not None
    if int4:
        if k.dtype != torch.uint8 or v.dtype != torch.uint8:
            raise ValueError(f"an int4 cache is packed uint8, got "
                             f"{k.dtype}/{v.dtype}")
        lead = tuple(k.shape[:-1])
        for sc in (ks, vs):
            if (sc.dtype != torch.bfloat16 or tuple(sc.shape) != lead + (1,)
                    or sc.device != dev or not sc.is_contiguous()
                    or sc.data_ptr() % 16):
                raise ValueError(f"int4 scales must be contiguous bf16 "
                                 f"{lead + (1,)} on {dev}")
        d = 2 * width
    else:
        if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
            raise ValueError(f"slab_read takes one cache dtype of "
                             f"{list(_DTYPE_CODE)} or a packed int4 cache "
                             f"with its scales, got {k.dtype}/{v.dtype}")
        d = width
    if v.shape != k.shape or v.device != dev or k.dim() not in (4, 5):
        raise ValueError(f"k/v must be one [L,B,Nkv,S,D] shape on one "
                         f"device, got {tuple(k.shape)}/{tuple(v.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("slab_read needs a contiguous cache")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the cache must be 16-byte aligned")
    if d != HEAD_DIM:
        raise ValueError(f"slab_read needs head_dim {HEAD_DIM}, got {d}")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {n_layers})")
    itemsize = INT4_PLAN_ITEMSIZE if int4 else k.element_size()
    chunk = batch_plan(s_len, b, nkv, itemsize).chunk
    tickets = ticket_buffer(dev, b)
    terms = torch.empty((b, s_len // block_s, d), dtype=torch.float32,
                        device=dev)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    err = _library().slab_read_fwd(
        _INT4_CODE if int4 else _DTYPE_CODE[k.dtype], k.data_ptr(),
        v.data_ptr(), ks.data_ptr() if int4 else None,
        vs.data_ptr() if int4 else None, terms.data_ptr(), out.data_ptr(),
        tickets.data_ptr(), layer_idx, b, nkv, s_len, d, block_s, chunk,
        float(seed), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slab_read kernel launch failed: CUDA error {err}")
    slab_read.launches += 1
    if int4:
        slab_read.launches_int4 += 1
    return out


def slab_read(k: torch.Tensor, v: torch.Tensor, *, layer_idx: int = 0,
              seed: int = 0, block_s: int = 128,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k/v: the stacked cache [L, B, Nkv, S, 128] (or one layer [B, Nkv, S,
    128]), bf16 or fp8, or the packed int4 cache [.., S, 64] uint8 with its
    scale planes ``k_scale``/``v_scale`` [.., S, 1] bf16; S a multiple of
    128 and of ``block_s`` → [B, 128] f32.

    A CUDA tensor launches the kernel or raises; only a CPU tensor takes
    the plain version."""
    refuse_grad("slab_read", k, v, k_scale, v_scale)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int4 cache needs both k_scale and v_scale")
    s_len = k.shape[-2]
    if s_len % block_s or s_len % CACHE_TILE:
        raise ValueError(f"cache length {s_len} is not a multiple of "
                         f"block_s {block_s} and of {CACHE_TILE}")
    layer_idx = int(layer_idx) if k.dim() == 5 else 0
    if k.device.type == "cpu":
        return slab_read_plain(k, v, layer_idx=layer_idx, seed=int(seed),
                               block_s=int(block_s), k_scale=k_scale,
                               v_scale=v_scale)
    return _launch(k, v, k_scale, v_scale, layer_idx=layer_idx,
                   seed=int(seed), block_s=int(block_s))


slab_read.launches = 0
slab_read.launches_int4 = 0
