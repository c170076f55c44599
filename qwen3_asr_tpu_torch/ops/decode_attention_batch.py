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

The int4 route (packed ``uint8`` payload ``[L,B,Nkv,S,64]`` with bf16
scale planes ``[L,B,Nkv,S,1]``, ``ops/kv_int4.py``'s layout) computes
JAX's int4 decode step instead, ``attend_xla`` with scores-side scales
(``qwen3_asr_tpu/ops/attention.py:156-189``): ``s = (q·k)·scale·ks`` in
f32, the softmax, weights ``p·vs`` rounded to q's dtype, ``out = w·v``;
on the card q is bf16 and nothing widened is written back.

What bounds it on the H100: the bytes of the live cache,
``2·B·Nkv·live·128·itemsize`` per layer. What the design does about it:
one launch over a grid (n_split, Nkv, B) from ``batch_plan`` (a chunk
length from the cache's shape alone); each block copies its chunk's live K
and V rows into shared memory by bulk copies, computes both products on
tensor cores, and writes one partial softmax state; the last block of each
(row, KV head) to take a ticket combines them in split order. Both the kernel and the plain version
take the softmax max per chunk of the plan (the TPU kernel takes a running
max), so p is rounded against the same max on both.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ._build import load
from .autograd import refuse_grad
from .attention import MASK_VALUE
from .decode_attention import split_plan, ticket_buffer
from .kv_int4 import unpack

HEAD_DIM = 128            # kD in csrc/decode_attention_batch.cu
CACHE_TILE = 128          # S must be a multiple (a chunk divides it)
_MAX_GROUP = 8            # kMaxG
_RECORD = HEAD_DIM + 4    # floats of one partial: m, l, -, -, acc
_COMBINE_BYTES = 65536    # shared memory a combine round stages at most
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_INT4_CODE = 3            # the packed uint8 payload, read with its scales
# The int4 cache's bytes per head dim: for the plan, the packed payload and
# a row's bf16 scale (64 + 2 bytes a row); in shared memory, the payload
# alone (the scales sit in a static array of their own).
INT4_PLAN_ITEMSIZE = (HEAD_DIM // 2 + 2) / HEAD_DIM
INT4_SMEM_ITEMSIZE = 0.5


class Plan(NamedTuple):
    """How kernel #3 (and the read-rate probe) cut one layer of the cache:
    ``chunk`` keys a block (the softmax max is taken per chunk), ``n_split``
    chunks per (row, KV head)."""
    chunk: int
    n_split: int

    def smem_bytes(self, itemsize: float, group: int) -> int:
        """Dynamic shared memory of a block: the chunk's K and V, and room
        for one combine round of partial records."""
        tiles = int(2 * self.chunk * HEAD_DIM * itemsize)
        records = min(self.n_split * group * _RECORD * 4, _COMBINE_BYTES)
        return max(tiles, records)


def batch_plan(s_len: int, batch: int, nkv: int, itemsize: float) -> Plan:
    """The plan for a cache [.., B, Nkv, S, 128] of ``itemsize`` bytes: the
    chunk of ``split_plan`` (a power of two that divides 128, at most 16 KB
    of K, halved while the grid has fewer blocks than the card has SMs),
    from the shape alone, never from the valid range."""
    return Plan(*split_plan(s_len, batch, nkv, HEAD_DIM, itemsize))


def _plan_itemsize(k: torch.Tensor, int4: bool) -> float:
    return INT4_PLAN_ITEMSIZE if int4 else k.element_size()


def decode_attention_batched_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, valid_from: torch.Tensor,
                                   valid_to: torch.Tensor, *, layer_idx: int,
                                   sm_scale: float,
                                   k_scale: Optional[torch.Tensor] = None,
                                   v_scale: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Dense restatement of the kernel's function, with its rounding points
    and its softmax max per chunk of ``batch_plan`` and combine; for an
    int4 cache, the int4 route's (q as it is, the scales on the scores and
    the weights, ``p·vs`` rounded to q's dtype): the int4 cache is the one
    that comes with its scale planes."""
    int4 = k_scale is not None
    if k.dim() == 5:
        k, v = k[layer_idx], v[layer_idx]
        if int4:
            k_scale, v_scale = k_scale[layer_idx], v_scale[layer_idx]
    b, nq, _, d = q.shape
    nkv, s_len = k.shape[1], k.shape[2]
    chunk = batch_plan(s_len, b, nkv, _plan_itemsize(k, int4)).chunk
    g, n_blk = nq // nkv, s_len // chunk
    bf16 = torch.bfloat16
    if int4:
        qs = q.float().reshape(b, nkv, g, d)
        kb, vb = unpack(k).float(), unpack(v).float()
        vb = vb.reshape(b, nkv, n_blk, chunk, d)
        s = torch.einsum("bhgd,bhsd->bhgs", qs, kb) * sm_scale
        s = s * k_scale.float().reshape(b, nkv, 1, s_len)
    else:
        qs = (q.float() * sm_scale).to(bf16).float().reshape(b, nkv, g, d)
        kb = k.to(bf16).float()
        vb = v.to(bf16).float().reshape(b, nkv, n_blk, chunk, d)
        s = torch.einsum("bhgd,bhsd->bhgs", qs, kb)
    cols = torch.arange(s_len, device=q.device)[None, :]
    live = ((cols >= valid_from.long()[:, None])
            & (cols < valid_to.long()[:, None]))[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, MASK_VALUE))
    s = s.reshape(b, nkv, g, n_blk, chunk)
    live = live.reshape(b, 1, 1, n_blk, chunk)
    m = s.amax(dim=-1, keepdim=True)                     # per chunk
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)                                    # [b,h,g,chunk]
    if int4:
        pw = p * v_scale.float().reshape(b, nkv, 1, n_blk, chunk)
        pw = pw.to(q.dtype).float()
    else:
        pw = p.to(bf16).float()
    acc = torch.einsum("bhgjc,bhjcd->bhgjd", pw, vb)
    m = m[..., 0]
    # Chunks with no live key have m = MASK_VALUE and l = 0, so their
    # weight is 0 beside any live chunk, and a row with none gives 0.
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
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, vf, vt, ks, vs, *, layer_idx, sm_scale):
    int4 = ks is not None
    b, nq, _, d = q.shape
    n_layers = k.shape[0] if k.dim() == 5 else 1
    nkv, s_len = k.shape[-3], k.shape[-2]
    dev = q.device
    if q.dtype not in _Q_CODE:
        raise ValueError(f"decode_attention_batched takes f32 or bf16 q, got "
                         f"{q.dtype}")
    kv_dtypes = [torch.uint8] if int4 else list(_KV_CODE)
    if k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise ValueError(f"decode_attention_batched takes one cache dtype "
                         f"of {kv_dtypes}, got {k.dtype}/{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention_batched needs contiguous q, k "
                         "and v")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the cache must be 16-byte aligned")
    if int4:
        if q.dtype != torch.bfloat16:
            raise ValueError(f"the int4 route takes bf16 q, got {q.dtype}")
        want = k.shape[:-1] + (1,)
        if (vs is None or ks.dtype != torch.bfloat16
                or vs.dtype != torch.bfloat16 or ks.shape != want
                or vs.shape != want or not ks.is_contiguous()
                or not vs.is_contiguous() or ks.device != dev
                or vs.device != dev):
            raise ValueError(f"an int4 cache needs contiguous bf16 scale "
                             f"planes {tuple(want)} on {dev}")
    if v.shape != k.shape or k.shape[-4] != b or k.dim() not in (4, 5):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    group = nq // nkv
    if group > _MAX_GROUP:
        raise ValueError(f"query group {group} exceeds {_MAX_GROUP}")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {n_layers})")
    for x, name in ((vf, "kv_valid_from"), (vt, "kv_valid_to")):
        if (x.dtype != torch.int32 or x.shape != (b,) or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor "
                             f"on {dev}")
    plan = batch_plan(s_len, b, nkv, _plan_itemsize(k, int4))
    smem_itemsize = INT4_SMEM_ITEMSIZE if int4 else k.element_size()
    tickets = ticket_buffer(dev, b * nkv)
    out = torch.empty_like(q)
    part = torch.empty(b * nkv * plan.n_split * group * _RECORD,
                       dtype=torch.float32, device=dev)
    err = _library().decode_attention_batch_fwd(
        _Q_CODE[q.dtype], _INT4_CODE if int4 else _KV_CODE[k.dtype],
        q.data_ptr(), k.data_ptr(),
        v.data_ptr(), ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if int4 else None, out.data_ptr(),
        vf.data_ptr(), vt.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), layer_idx, b, nq, nkv, s_len, d,
        plan.chunk, float(sm_scale),
        plan.smem_bytes(smem_itemsize, group),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_batched kernel launch failed: "
                           f"CUDA error {err}")
    if int4:
        decode_attention_batched.launches_int4 += 1
    else:
        decode_attention_batched.launches += 1
    return out


def decode_attention_batched(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, layer_idx: int = 0,
                             kv_valid_from: Optional[torch.Tensor] = None,
                             kv_valid_to: Optional[torch.Tensor] = None,
                             sm_scale: Optional[float] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """q: [B, Nq, 1, 128] f32/bf16 → [B, Nq, 1, 128] of q's dtype.

    k/v: one layer's cache [B, Nkv, S, 128] (``layer_idx`` ignored) or the
    stacked cache [L, B, Nkv, S, 128], fp8/bf16/f32, S a multiple of 128;
    or a packed int4 cache (uint8, last dim 64) with its bf16 scale planes
    ``k_scale``/``v_scale`` of the same leading shape and last dim 1: the
    scale planes, and nothing else, say that the cache is int4.
    A CUDA tensor launches the kernel or raises; only a CPU tensor takes
    the plain version."""
    refuse_grad("decode_attention_batched", q, k, v, k_scale, v_scale)
    b, nq, t, d = q.shape
    if t != 1:
        raise ValueError("decode_attention_batched is for single-token "
                         "queries")
    nkv, s_len = k.shape[-3], k.shape[-2]
    int4 = k_scale is not None
    if int4 != (v_scale is not None):
        raise ValueError("an int4 cache needs both k_scale and v_scale")
    row = HEAD_DIM // 2 if int4 else HEAD_DIM
    if d != HEAD_DIM or k.shape[-1] != row:
        raise ValueError(f"decode_attention_batched needs head_dim "
                         f"{HEAD_DIM}, got {d}")
    if s_len % CACHE_TILE:
        raise ValueError(f"cache length {s_len} is not a multiple of "
                         f"{CACHE_TILE}")
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
                                              sm_scale=float(sm_scale),
                                              k_scale=k_scale,
                                              v_scale=v_scale)
    return _launch(q, k, v, vf.contiguous(), vt.contiguous(), k_scale,
                   v_scale, layer_idx=layer_idx, sm_scale=float(sm_scale))


# Launches of the bf16/fp8/f32 routes, and of the int4 route.
decode_attention_batched.launches = 0
decode_attention_batched.launches_int4 = 0
