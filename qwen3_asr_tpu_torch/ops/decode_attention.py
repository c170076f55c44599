"""Single-token decode attention against the KV cache: a CUDA kernel written
by hand for Hopper (``csrc/decode_attention.cu``), its plain PyTorch
version, and the wrapper.

Replaces the TPU kernel ``qwen3_asr_tpu/ops/decode_attention.py``
``_kernel`` (public ``decode_attention``).

What it computes: one query token per row, ``q [B,Nq,1,D]``, against one
layer's cache ``[B,Nkv,S,D]`` or the stacked cache ``[L,B,Nkv,S,D]`` at a
runtime ``layer_idx`` (read through a pointer offset, no slice copy), over
the keys in ``[valid_from, valid_to)`` only, with f32 arithmetic and a safe
divide.

What bounds it on the H100: the bytes of the live cache are a few hundred
KB per layer at batch 1, well under a microsecond of HBM time, so the cost
is latency. The kernel splits S across blocks in ONE launch: the grid is
(n_split, Nkv, B) with the chunk length picked here from the cache length
alone (``split_plan``), so batch 1 still fills the card's SMs; each block
copies its chunk's live K and V rows with one bulk copy each, writes its
partial m, l and acc to f32 scratch, and the last block of each (row, KV
head) to take a ticket combines them in split order and resets it. The
output is the same bits on every run and under CUDA-graph replay.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ._build import load
from .autograd import refuse_grad
from .attention import MASK_VALUE

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 8           # kMaxG in csrc/decode_attention.cu
_MAX_D = 128
_MAX_CHUNK = 128         # kMaxChunk
_MIN_CHUNK = 16
_CHUNK_BYTES = 16384     # kChunkBytes: one chunk of K (or of V)
_SMS = 132               # streaming multiprocessors of an H100 SXM
_TICKETS = 4096          # ticket slots, one per (row, KV head) of a call
# One zeroed ticket buffer per device, shared by the kernels that combine
# across blocks (this one, ops/decode_attention_batch.py and
# ops/slab_reader.py) and left zeroed by every call; calls on one device
# share it, so they must run one at a time. They do on the serving path:
# the queue's device thread and the decode pool's both launch on the
# default stream, and a CUDA graph's build, whose eager run is on a side
# stream, holds runtime/graphs.py's device_lock, which every replay takes.
_tickets: Dict[torch.device, torch.Tensor] = {}


def ticket_buffer(dev: torch.device, n: int) -> torch.Tensor:
    """The zeroed ticket buffer of ``dev``, for a call that takes ``n``
    tickets; raises if it has fewer. Never reallocated, so a captured CUDA
    graph keeps a valid pointer."""
    if n > _TICKETS:
        raise ValueError(f"{n} tickets (rows x KV heads) exceed the "
                         f"{_TICKETS} the kernels keep")
    tickets = _tickets.get(dev)
    if tickets is None:
        tickets = torch.zeros(_TICKETS, dtype=torch.int32, device=dev)
        _tickets[dev] = tickets
    return tickets


def split_plan(s_len: int, batch: int, nkv: int, head_dim: int,
               itemsize: int) -> Tuple[int, int]:
    """(chunk, n_split) for the kernel's grid (n_split, Nkv, B): the largest
    power-of-two chunk of keys whose K rows fit ``_CHUNK_BYTES``, halved
    while the grid has fewer blocks than the card has SMs (down to 16
    keys). Depends on the cache length only, never on the valid range."""
    chunk = _MAX_CHUNK
    while chunk > _MIN_CHUNK and chunk * head_dim * itemsize > _CHUNK_BYTES:
        chunk //= 2
    while chunk > _MIN_CHUNK and -(-s_len // chunk) * nkv * batch < _SMS:
        chunk //= 2
    return chunk, -(-s_len // chunk)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_from: torch.Tensor, valid_to: torch.Tensor, *,
                           layer_idx: int, sm_scale: float) -> torch.Tensor:
    """Dense restatement of the kernel's function in f32."""
    if k.dim() == 5:
        k, v = k[layer_idx], v[layer_idx]
    b, nq, _, d = q.shape
    _, nkv, s_len, _ = k.shape
    g = nq // nkv
    qf = q.reshape(b, nkv, g, d).float() * sm_scale
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    cols = torch.arange(s_len, device=q.device)[None, :]
    mask = ((cols >= valid_from.long()[:, None])
            & (cols < valid_to.long()[:, None]))[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / l_safe
    return out.reshape(b, nq, 1, d).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, vf, vt, *, layer_idx, sm_scale):
    b, nq, _, d = q.shape
    stacked = k.dim() == 5
    n_layers = k.shape[0] if stacked else 1
    nkv, s_len = k.shape[-3], k.shape[-2]
    dev = q.device
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q, k and v")
    if d % 8 or d > _MAX_D:
        raise ValueError(f"head_dim {d} is not a multiple of 8 up to {_MAX_D}")
    if (v.shape != k.shape or k.shape[-4] != b or k.shape[-1] != d
            or k.dim() not in (4, 5)):
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
    chunk, n_split = split_plan(s_len, b, nkv, d, q.element_size())
    tickets = ticket_buffer(dev, b * nkv)
    out = torch.empty_like(q)
    part = torch.empty(b * n_split * nq * (d + 4),
                       dtype=torch.float32, device=dev)
    err = _library().decode_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), vf.data_ptr(), vt.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), layer_idx if stacked else 0, b, nq, nkv, s_len,
        d, chunk, float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     layer_idx: int = 0,
                     kv_valid_from: Optional[torch.Tensor] = None,
                     kv_valid_to: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Nq, 1, D] → [B, Nq, 1, D].

    k/v: one layer's cache [B, Nkv, S, D] (``layer_idx`` ignored), or the
    stacked cache [L, B, Nkv, S, D] with ``layer_idx`` selecting the layer
    without a copy. A CUDA tensor launches the kernel or raises; only a CPU
    tensor takes the plain version."""
    refuse_grad("decode_attention", q, k, v)
    b, nq, t, d = q.shape
    if t != 1:
        raise ValueError("decode_attention is for single-token queries")
    nkv, s_len = k.shape[-3], k.shape[-2]
    if nq % nkv:
        raise ValueError(f"query heads {nq} not divisible by kv heads {nkv}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    dev = q.device
    vf = (torch.zeros((b,), dtype=torch.int32, device=dev)
          if kv_valid_from is None else kv_valid_from.to(dev, torch.int32))
    vt = (torch.full((b,), s_len, dtype=torch.int32, device=dev)
          if kv_valid_to is None else kv_valid_to.to(dev, torch.int32))
    layer_idx = int(layer_idx)
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, vf, vt, layer_idx=layer_idx,
                                      sm_scale=float(sm_scale))
    return _launch(q, k, v, vf.contiguous(), vt.contiguous(),
                   layer_idx=layer_idx, sm_scale=float(sm_scale))


decode_attention.launches = 0
