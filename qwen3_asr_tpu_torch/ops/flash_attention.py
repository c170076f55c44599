"""Flash attention for the encoder's window attention and the decoder's
causal prefill: a CUDA kernel written by hand for Hopper
(``csrc/flash_attention.cu``), its plain PyTorch version, and the wrapper.

Replaces the TPU kernel ``qwen3_asr_tpu/ops/flash_attention.py``
``_kernel`` (launched by ``_flash_pallas``, public ``flash_attention``).

What it computes: GQA attention ``q [B,Nq,T,D]`` against ``k/v
[B,Nkv,S,D]``, each KV head serving its group of G = Nq/Nkv query heads,
with an index-built mask (causal with a per-row ``q_offset``, block-diagonal
``window_block``, per-row ``[valid_from, valid_to)``, the S tail). Masked
scores are ``MASK_VALUE`` and their p is zeroed; fully masked rows divide
safely and give 0. It also returns the f32 softmax residuals m and l
``[B,Nq,T]``.

Two routes, chosen by dtype, both counted in ``flash_attention.launches``:
bf16, the working dtype on the card, runs both products on the tensor
cores (``wgmma``: Q in registers, P rounded to bf16 in registers as the TPU
kernel rounds it, V read MN-major through the transpose bit) with K/V
tiles of 64 keys loaded by TMA into a 4-stage ring, two warpgroups taking
alternate tiles; f32, the parity dtype, runs on the CUDA cores (no tensor
core computes f32 to 2e-5).

What bounds it on the H100: at the main path's shapes the work is small
(encoder windows of 50 tokens, a prefill of a few hundred), a bound of 1-2
microseconds, so the cost is the chain of tiles each block walks and their
load latency. One block per (batch row, KV head, tile of query rows)
computes the tile for all G heads so K/V are read once per group; KV tiles
that the mask kills entirely are skipped before they are loaded, so
encoder work follows the window and not T²; the [T,S] scores never reach
device memory.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import load
from .attention import MASK_VALUE

# the route: 0 = f32 on the CUDA cores, 1 = bf16 on wgmma + TMA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 64     # kRows in csrc/flash_attention.cu
_MAX_D = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_from: torch.Tensor, valid_to: torch.Tensor,
                          q_offset: torch.Tensor, *, causal: bool,
                          window_block: int, sm_scale: float):
    """Dense restatement of the kernel's function in f32: MASK_VALUE
    scores, p zeroed where masked, safe divide. Like the TPU kernel, p is
    rounded to q's dtype before P·V (a no-op in f32) while l sums the f32
    p. Returns (out, m, l)."""
    b, nq, t, d = q.shape
    _, nkv, s_len, _ = k.shape
    g = nq // nkv
    qg = q.reshape(b, nkv, g, t, d).float()
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * sm_scale
    rows = (torch.arange(t, device=q.device)[None, :, None]
            + q_offset.long()[:, None, None])
    cols = torch.arange(s_len, device=q.device)[None, None, :]
    mask = ((cols >= valid_from.long()[:, None, None])
            & (cols < valid_to.long()[:, None, None]))
    if causal:
        mask = mask & (cols <= rows)
    if window_block > 0:
        mask = mask & ((rows // window_block) == (cols // window_block))
    mask = mask[:, None, None]                               # [B,1,1,T,S]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    p_v = p.to(q.dtype).float()
    out = (torch.einsum("bhgts,bhsd->bhgtd", p_v, v.float())
           / l_safe[..., None])
    return (out.reshape(b, nq, t, d).to(q.dtype), m.reshape(b, nq, t),
            l.reshape(b, nq, t))


def _library() -> ctypes.CDLL:
    lib = load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check_int_vec(x: torch.Tensor, b: int, dev: torch.device, name: str):
    if (x.dtype != torch.int32 or x.shape != (b,) or x.device != dev
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor on "
                         f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch(q, k, v, vf, vt, q_off, *, causal, window_block, sm_scale):
    b, nq, t, d = q.shape
    _, nkv, s_len, _ = k.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if d % 8 or d > _MAX_D:
        raise ValueError(f"head_dim {d} is not a multiple of 8 up to {_MAX_D}")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if nq // nkv > _ROWS_PER_BLOCK:
        raise ValueError(f"query group {nq // nkv} exceeds {_ROWS_PER_BLOCK}")
    for x, name in ((vf, "kv_valid_from"), (vt, "kv_valid_to"),
                    (q_off, "q_offset")):
        _check_int_vec(x, b, dev, name)
    out = torch.empty_like(q)
    m = torch.empty((b, nq, t), dtype=torch.float32, device=dev)
    l = torch.empty((b, nq, t), dtype=torch.float32, device=dev)
    if t == 0:
        return out, m, l
    err = _library().flash_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), vf.data_ptr(),
        vt.data_ptr(), q_off.data_ptr(), b, nq, nkv, t, s_len, d,
        int(bool(causal)), int(window_block), float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, m, l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, q_offset=0,
                    kv_valid_from: Optional[torch.Tensor] = None,
                    kv_valid_to: Optional[torch.Tensor] = None,
                    window_block: int = 0, sm_scale: Optional[float] = None,
                    return_residuals: bool = False):
    """q: [B, Nq, T, D]; k/v: [B, Nkv, S, D] → [B, Nq, T, D] (and, with
    ``return_residuals``, m and l as [B, Nq, T] f32).

    A CUDA tensor launches the kernel or raises; only a CPU tensor takes
    the plain version."""
    b, nq, t, d = q.shape
    nkv, s_len = k.shape[1], k.shape[2]
    if nq % nkv:
        raise ValueError(f"query heads {nq} not divisible by kv heads {nkv}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    dev = q.device
    vf = (torch.zeros((b,), dtype=torch.int32, device=dev)
          if kv_valid_from is None else kv_valid_from.to(dev, torch.int32))
    vt = (torch.full((b,), s_len, dtype=torch.int32, device=dev)
          if kv_valid_to is None else kv_valid_to.to(dev, torch.int32))
    # A host int becomes a device fill, not a host→device copy (which
    # would synchronize the stream on every call).
    q_off = (q_offset.to(dev, torch.int32).expand(b).contiguous()
             if torch.is_tensor(q_offset)
             else torch.full((b,), int(q_offset), dtype=torch.int32,
                             device=dev))
    if dev.type == "cpu":
        out, m, l = flash_attention_plain(q, k, v, vf, vt, q_off,
                                          causal=causal,
                                          window_block=int(window_block),
                                          sm_scale=float(sm_scale))
    else:
        out, m, l = _launch(q, k, v, vf.contiguous(), vt.contiguous(), q_off,
                            causal=causal, window_block=int(window_block),
                            sm_scale=float(sm_scale))
    return (out, m, l) if return_residuals else out


flash_attention.launches = 0
