"""QK-norm, RoPE and the KV-cache write of one decoder layer: a CUDA kernel
written by hand for Hopper (``csrc/qk_rope_kv.cu``), its plain PyTorch
version and the wrapper.

No TPU kernel: the JAX decoder's ``rms_norm`` on q and k, ``apply_rope``,
and the cache update (``astype`` or ``_kv_quantize``, then
``dynamic_update_slice``; ``qwen3_asr_tpu/models/decoder.py:132-170,
240-261``) are fused by XLA into the step program.

What it computes, per layer: q, k and v as the layer's projections leave
them (``[B, T, heads * D]``); q and k RMS-normalised per head (f32, then
rounded to the input dtype) and rotated by ``cos``/``sin`` (f32 on the
rounded value, rounded again): JAX's rounding points. q comes back as
``[B, nq, T, D]``, contiguous; K and V are stored IN PLACE into layer
``layer`` of the stacked cache at keys ``write_pos .. write_pos + T - 1``:
as they are (a working-dtype cache), cast to fp8, or quantized to int4
with their bf16 scales (``ops/kv_int4.py``'s layout and arithmetic).

What bounds it on the H100: a decode step moves a few KB a layer, so the
time is launch and latency; the plain chain runs ~38 small kernels a
layer. The kernel is ONE launch a layer, prefill and decode step alike,
a warp a row, every row in registers, the sum of squares in the order of
torch's own CUDA reduction (``csrc/qk_rope_kv.cu`` describes the design).
The position is a host int (the prefill), a 0-d int64 device tensor (a
decode step, which a CUDA graph replays at a new position), or a ``[B]``
int64 device tensor, one position a row (the resume loop's continuation,
each row at its own frontier; still one launch a layer); a key at or past
the cache's end is not written.

Training takes ``qk_rope`` instead, a ``torch.autograd.Function`` that
returns the q, k and v heads with no cache: its forward is kernel B
writing into a fresh one-layer cache of length T at position 0 (which is
then exactly k and v, as JAX's ``asr_loss`` writes all T keys into a
fresh cache, ``qwen3_asr_tpu/runtime/train.py:51-55``), its backward the
hand-written ``csrc/qk_rope_bwd.cu`` (``qk_rope_bwd``; its plain version
``qk_rope_bwd_plain``): RoPE's transpose, then RMSNorm's backward, for q
and k, with the ``q_norm``/``k_norm`` weight gradients; v's cotangent
passes through. The in-place ``qk_rope_kv_write`` has no backward and
raises when autograd would need one.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ._build import load
from .autograd import refuse_grad
from .kv_int4 import HEAD_DIM as INT4_HEAD_DIM
from .kv_int4 import kv_int4_write_plain, write_kv

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
STORE_SAME, STORE_FP8, STORE_INT4 = 0, 1, 2     # enum Store in the source
MAX_HEAD_DIM = 128                               # 32 lanes x kSlots


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, N, T, D]; cos/sin: [B, T, D] (half-split rotation)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    out = xf * cos[:, None] + rotated * sin[:, None]
    return out.to(x.dtype)


def _heads(x: torch.Tensor, d: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, -1, d).transpose(1, 2)


def qk_rope_kv_write_plain(q, k, v, q_norm, k_norm, cos, sin, eps: float,
                           cache, layer: int,
                           write_pos: Union[int, torch.Tensor]
                           ) -> torch.Tensor:
    """The chain the kernel replaces: ``rms_norm`` -> ``apply_rope`` on q
    and k, then the cache's write (``kv_int4_write_plain`` or
    ``write_kv``). Returns q [B, nq, T, D], contiguous."""
    d = q_norm.shape[-1]
    q, k, v = _heads(q, d), _heads(k, d), _heads(v, d)
    q = apply_rope(rms_norm(q, q_norm, eps), cos, sin).contiguous()
    k = apply_rope(rms_norm(k, k_norm, eps), cos, sin)
    if cache.int4:
        kv_int4_write_plain(cache, layer, k, v, write_pos)
    else:
        write_kv(cache.k[layer], k, write_pos)
        write_kv(cache.v[layer], v, write_pos)
    return q


def _rope_transpose(u: torch.Tensor) -> torch.Tensor:
    """Rᵀu for apply_rope's rotation R[u1; u2] = [-u2; u1]: [u2; -u1]."""
    half = u.shape[-1] // 2
    return torch.cat([u[..., half:], -u[..., :half]], dim=-1)


def qk_rope_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor, eps: float,
                      g: torch.Tensor):
    """The backward kernel's function on one of q or k, restated: x the
    forward's input heads [B, N, T, D], g the cotangent of
    ``apply_rope(rms_norm(x, weight, eps), cos, sin)``. RoPE's transpose
    rounded to x's dtype (the gradient of the norm output's ``astype``),
    then RMSNorm's backward in f32 from x. Returns (dx in x's dtype, the
    weight's gradient summed over every row, in its dtype)."""
    gf = g.float()
    dy = (gf * cos[:, None] + _rope_transpose(gf * sin[:, None])
          ).to(x.dtype).float()
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    n = xf * r
    dn = dy * weight.float()
    dx = r * (dn - n * (dn * n).mean(dim=-1, keepdim=True))
    dw = (dy * n).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def _bwd_library() -> ctypes.CDLL:
    lib = load("qk_rope_bwd")
    fn = lib.qk_rope_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 15 + [ctypes.c_float] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib


_BWD_MAX_BLOCKS = 528       # 4 a streaming multiprocessor on the H100


def qk_rope_bwd(q, k, q_norm, k_norm, cos, sin, eps: float, gq, gk, gv):
    """Gradients of ``qk_rope``'s outputs' cotangents gq [B, nq, T, D] and
    gk, gv [B, nkv, T, D], from its inputs q [B, T, nq*D] and k: returns
    (dq, dk, dv) in the inputs' [B, T, heads*D] layout and the
    ``q_norm``/``k_norm`` gradients. A CUDA tensor launches
    ``csrc/qk_rope_bwd.cu`` or raises; only a CPU tensor takes
    ``qk_rope_bwd_plain``."""
    d = q_norm.shape[-1]
    b, t, _ = q.shape
    if q.device.type == "cpu":
        dq, dwq = qk_rope_bwd_plain(_heads(q, d), q_norm, cos, sin, eps, gq)
        dk, dwk = qk_rope_bwd_plain(_heads(k, d), k_norm, cos, sin, eps, gk)
        flat = lambda x: x.transpose(1, 2).reshape(b, t, -1)  # noqa: E731
        return flat(dq), flat(dk), flat(gv), dwq, dwk
    dev, dt = q.device, q.dtype
    check_head_dim(d)
    nq, nkv = q.shape[2] // d, k.shape[2] // d
    if dt not in _X_CODE or any(x.dtype != dt for x in
                                (k, q_norm, k_norm, gq, gk, gv)):
        raise ValueError("qk_rope_bwd takes f32 or bf16 inputs, norms and "
                         "cotangents of one dtype")
    if (gq.shape != (b, nq, t, d) or gk.shape != (b, nkv, t, d)
            or gv.shape != gk.shape or k.shape != (b, t, nkv * d)
            or cos.shape != (b, t, d) or sin.shape != cos.shape
            or cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise ValueError(f"qk_rope_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, cotangents {tuple(gq.shape)}, "
                         f"{tuple(gk.shape)}, {tuple(gv.shape)} and cos "
                         f"{tuple(cos.shape)} disagree")
    tensors = (q, k, q_norm, k_norm, cos, sin, gq, gk, gv)
    if any(x.device != dev or not x.is_contiguous() for x in tensors):
        raise ValueError("qk_rope_bwd: every tensor contiguous on q's device")
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dv = torch.empty_like(k)
    dwq, dwk = torch.empty_like(q_norm), torch.empty_like(k_norm)
    rows = b * t * (nq + 2 * nkv)
    blocks = max(1, min(_BWD_MAX_BLOCKS, -(-rows // 8)))
    partial = torch.empty((blocks, 2, d), dtype=torch.float32, device=dev)
    err = _bwd_library().qk_rope_bwd(
        _X_CODE[dt], q.data_ptr(), k.data_ptr(), q_norm.data_ptr(),
        k_norm.data_ptr(), cos.data_ptr(), sin.data_ptr(), gq.data_ptr(),
        gk.data_ptr(), gv.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), partial.data_ptr(), dwq.data_ptr(), dwk.data_ptr(),
        float(eps), b, t, nq, nkv, d, blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qk_rope_bwd kernel launch failed: CUDA error "
                           f"{err}")
    qk_rope_bwd.launches += 1
    return dq, dk, dv, dwq, dwk


qk_rope_bwd.launches = 0


class QkRopeFunction(torch.autograd.Function):
    """QK-norm + RoPE on q and k, v's heads as they are: see ``qk_rope``."""

    @staticmethod
    def forward(ctx, q, k, v, q_norm, k_norm, cos, sin, eps):
        d = q_norm.shape[-1]
        if q.device.type == "cpu":
            qh = apply_rope(rms_norm(_heads(q, d), q_norm, eps), cos, sin)
            kh = apply_rope(rms_norm(_heads(k, d), k_norm, eps), cos, sin)
            out = (qh.contiguous(), kh.contiguous(),
                   _heads(v, d).contiguous())
        else:
            from ..models.decoder import KVCache
            b, t, _ = k.shape
            shape = (1, b, k.shape[2] // d, t, d)
            cache = KVCache(torch.empty(shape, dtype=q.dtype, device=q.device),
                            torch.empty(shape, dtype=q.dtype, device=q.device))
            qh = _launch(q, k, v, q_norm, k_norm, cos, sin, eps, cache, 0, 0)
            out = (qh, cache.k[0], cache.v[0])
        ctx.save_for_backward(q, k, q_norm, k_norm, cos, sin)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, gq, gk, gv):
        q, k, q_norm, k_norm, cos, sin = ctx.saved_tensors
        dq, dk, dv, dwq, dwk = qk_rope_bwd(
            q.contiguous(), k.contiguous(), q_norm, k_norm, cos, sin,
            ctx.eps, gq.contiguous(), gk.contiguous(), gv.contiguous())
        return dq, dk, dv, dwq, dwk, None, None, None


def qk_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_norm: torch.Tensor, k_norm: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor, eps: float):
    """Training's QK-norm + RoPE: q, k, v ``[B, T, heads * D]`` → the q, k
    and v heads ``[B, heads, T, D]``, contiguous, q and k normalised and
    rotated at JAX's rounding points, differentiable in q, k, v and the
    norm weights. On the card the forward is kernel B into a fresh
    one-layer cache and the backward ``csrc/qk_rope_bwd.cu``; on the CPU
    the plain chain and ``qk_rope_bwd_plain``."""
    return QkRopeFunction.apply(q, k, v, q_norm, k_norm, cos, sin, eps)


def check_head_dim(head_dim: int) -> None:
    """The kernel holds a row in one warp, up to 4 elements a lane: an even
    head_dim up to 128. Raises for any other."""
    if head_dim <= 0 or head_dim % 2 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"qk_rope_kv takes an even head_dim up to "
                         f"{MAX_HEAD_DIM}, got {head_dim}")


def _token_stride(x: torch.Tensor, name: str) -> int:
    """Elements between consecutive (b, t) tokens of [B, T, n] rows whose
    last dimension is contiguous; raises if the tokens are not evenly
    spaced."""
    b, t, _ = x.shape
    ts = x.stride(1) if t > 1 else x.stride(0)
    if x.stride(2) != 1 or (b > 1 and x.stride(0) != t * ts):
        raise ValueError(f"qk_rope_kv: {name} must be [B, T, n] rows with "
                         f"a contiguous last dimension and evenly spaced "
                         f"tokens, got strides {x.stride()}")
    return ts


def _library() -> ctypes.CDLL:
    lib = load("qk_rope_kv")
    fn = lib.qk_rope_kv_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, p, ll, ll, ll, p, p, p, p, p, p, p, p, p,
                       p, ll, i, ctypes.c_float, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, q_norm, k_norm, cos, sin, eps, cache, layer,
            write_pos) -> torch.Tensor:
    dev, dt = q.device, q.dtype
    if dt not in _X_CODE or any(x.dtype != dt
                                for x in (k, v, q_norm, k_norm)):
        raise ValueError(f"qk_rope_kv takes f32 or bf16 q, k, v and norms "
                         f"of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {q_norm.dtype}, {k_norm.dtype}")
    d = q_norm.shape[-1]
    check_head_dim(d)
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"qk_rope_kv takes [B, T, heads * D] q, k and v, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, qw = q.shape
    if (k.shape[:2] != (b, t) or qw % d or k.shape[2] % d
            or q_norm.shape != (d,) or k_norm.shape != (d,)):
        raise ValueError(f"qk_rope_kv: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and norms {tuple(q_norm.shape)}"
                         f", {tuple(k_norm.shape)} disagree on B, T or D")
    nq, nkv = qw // d, k.shape[2] // d
    ts = [_token_stride(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    for x, n in ((cos, "cos"), (sin, "sin")):
        if (x.dtype != torch.float32 or x.shape != (b, t, d)
                or not x.is_contiguous()):
            raise ValueError(f"qk_rope_kv: {n} must be contiguous f32 "
                             f"{(b, t, d)}, got {x.dtype} {tuple(x.shape)}")
    n_layers, s_len = cache.k.shape[0], cache.k.shape[3]
    if cache.int4:
        store = STORE_INT4
        width = d // 2
        if d != INT4_HEAD_DIM:
            raise ValueError(f"qk_rope_kv into an int4 cache needs head_dim "
                             f"{INT4_HEAD_DIM}, got {d}")
        planes = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        if (cache.k.dtype != torch.uint8 or cache.v.dtype != torch.uint8
                or cache.k_scale.dtype != torch.bfloat16
                or cache.v_scale.dtype != torch.bfloat16
                or cache.k_scale.shape != (n_layers, b, nkv, s_len, 1)
                or cache.v_scale.shape != cache.k_scale.shape):
            raise ValueError("qk_rope_kv: the cache is not an int4 cache for "
                             "these rows")
    else:
        store = STORE_FP8 if cache.k.dtype == torch.float8_e4m3fn else \
            STORE_SAME
        width = d
        planes = (cache.k, cache.v)
        if cache.k.dtype not in (dt, torch.float8_e4m3fn) or \
                cache.v.dtype != cache.k.dtype:
            raise ValueError(f"qk_rope_kv: a {cache.k.dtype} cache is "
                             f"neither the working dtype {dt} nor fp8")
    if (cache.k.shape != (n_layers, b, nkv, s_len, width)
            or cache.v.shape != cache.k.shape):
        raise ValueError(f"qk_rope_kv: cache {tuple(cache.k.shape)} does not "
                         f"take B={b}, nkv={nkv}, D={d}")
    tensors = (q, k, v, q_norm, k_norm, cos, sin) + planes
    if any(x.device != dev for x in tensors) or any(
            not x.is_contiguous() for x in planes + (q_norm, k_norm)):
        raise ValueError("qk_rope_kv: every tensor on q's device, the cache "
                         "planes and norms contiguous")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    per_row = 0
    if torch.is_tensor(write_pos):
        per_row = int(write_pos.dim() == 1 and write_pos.numel() == b
                      and b > 1)
        if (write_pos.dtype != torch.int64 or write_pos.device != dev
                or not write_pos.is_contiguous()
                or (write_pos.numel() != 1 and not per_row)):
            raise ValueError(f"a device write position is one int64, or "
                             f"one a row ([{b}]), contiguous on q's device; "
                             f"got {write_pos.dtype} "
                             f"{tuple(write_pos.shape)} on "
                             f"{write_pos.device}")
        pos_ptr, pos_add = write_pos.data_ptr(), 0
    else:
        pos_ptr, pos_add = None, int(write_pos)
    q_out = torch.empty((b, nq, t, d), dtype=dt, device=dev)
    int4 = store == STORE_INT4
    err = _library().qk_rope_kv_fwd(
        _X_CODE[dt], store, q.data_ptr(), k.data_ptr(), v.data_ptr(), *ts,
        q_norm.data_ptr(), k_norm.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        q_out.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        cache.k_scale.data_ptr() if int4 else None,
        cache.v_scale.data_ptr() if int4 else None, pos_ptr, pos_add,
        per_row, float(eps), layer, b, t, nq, nkv, s_len, d,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qk_rope_kv kernel launch failed: CUDA error "
                           f"{err}")
    qk_rope_kv_write.launches += 1
    qk_rope_kv_write.launches_per_row += per_row
    return q_out


def qk_rope_kv_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_norm: torch.Tensor, k_norm: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor, eps: float,
                     cache, layer: int,
                     write_pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """QK-norm and RoPE on q and k ``[B, T, heads * D]``, K and V written
    into layer ``layer`` of ``cache`` (a ``models.decoder.KVCache``) at
    ``write_pos`` (a host int, a 0-d int64 tensor, or ``[B]`` int64: row
    b's keys ``write_pos[b] ..  + T - 1``), IN PLACE; returns q
    ``[B, nq, T, D]``. A CUDA tensor
    launches the kernel or raises; only a CPU tensor takes the plain
    version. No backward: training takes ``qk_rope``."""
    refuse_grad("qk_rope_kv_write", q, k, v, q_norm, k_norm)
    if q.device.type == "cpu":
        return qk_rope_kv_write_plain(q, k, v, q_norm, k_norm, cos, sin, eps,
                                      cache, layer, write_pos)
    return _launch(q, k, v, q_norm, k_norm, cos, sin, eps, cache, layer,
                   write_pos)


qk_rope_kv_write.launches = 0
qk_rope_kv_write.launches_per_row = 0   # of them, with a [B] position
