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

The function is differentiable: where autograd needs it (grad mode on and
q, k or v requiring grad), ``flash_attention`` goes through
``FlashFunction``, whose backward is ``flash_attention_bwd``: on the card
the hand-written ``csrc/flash_attention_bwd.cu`` (two launches, counted
once in ``flash_attention_bwd.launches`` and once by route in
``route_launches``: bf16 at head dims a multiple of 16 on the tensor
cores, with P and dS split into two bf16 halves rather than rounded; f32
and other head dims on the CUDA cores; ``bwd_route``), on the CPU its
plain version ``flash_attention_bwd_plain``. It is the gradient of JAX's dense
restatement (``_flash_diff_bwd``, ``qwen3_asr_tpu/ops/flash_attention.py:186``),
P recomputed in f32. Cotangents on m and l (which only the context-parallel
combine would consume; ROADMAP item 14) raise NotImplementedError.

For ``torch.export`` the forward is also a registered operator,
``torch.ops.qwen3_asr_torch.flash_attention`` (``registered_op``): its CPU
implementation is ``flash_attention_plain``, its CUDA one ``_launch``, and
its fake one gives the output shapes, so an exported graph holds the
operator rather than the plain version's arithmetic. Only a trace under
``through_registered_op()`` (``tools/export_encoder.py``) takes it; the
served and training paths call the kernel directly, so they pay no
dispatcher hop.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from ._build import load
from .attention import MASK_VALUE

# the route: 0 = f32 on the CUDA cores, 1 = bf16 on wgmma + TMA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 64     # kRows in csrc/flash_attention.cu
_MAX_D = 128


def _scores(q, k, valid_from, valid_to, q_offset, causal, window_block,
            sm_scale):
    """Masked f32 scores [B, Nkv, G, T, S] (MASK_VALUE where masked) and
    the mask [B, 1, 1, T, S]."""
    b, nq, t, d = q.shape
    _, nkv, s_len, _ = k.shape
    qg = q.reshape(b, nkv, nq // nkv, t, d).float()
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
    return torch.where(mask, s, torch.full_like(s, MASK_VALUE)), mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_from: torch.Tensor, valid_to: torch.Tensor,
                          q_offset: torch.Tensor, *, causal: bool,
                          window_block: int, sm_scale: float):
    """Dense restatement of the kernel's function in f32: MASK_VALUE
    scores, p zeroed where masked, safe divide. Like the TPU kernel, p is
    rounded to q's dtype before P·V (a no-op in f32) while l sums the f32
    p. Returns (out, m, l)."""
    b, nq, t, d = q.shape
    s, mask = _scores(q, k, valid_from, valid_to, q_offset, causal,
                      window_block, sm_scale)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    p_v = p.to(q.dtype).float()
    out = (torch.einsum("bhgts,bhsd->bhgtd", p_v, v.float())
           / l_safe[..., None])
    return (out.reshape(b, nq, t, d).to(q.dtype), m.reshape(b, nq, t),
            l.reshape(b, nq, t))


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              m: torch.Tensor, l: torch.Tensor,
                              valid_from: torch.Tensor,
                              valid_to: torch.Tensor, q_offset: torch.Tensor,
                              *, causal: bool, window_block: int,
                              sm_scale: float):
    """The backward kernel's function, restated densely in f32: the
    gradient of JAX's ``_xla_forward`` (P never rounded), from the
    forward's residuals m and l. A = p / l_safe, dP = dO·Vᵀ,
    D = rowsum(A∘dP), dS = A∘(dP − D); dq = scale·dS·K,
    dk = scale·dSᵀ·Q and dv = Aᵀ·dO, dk/dv summed over each KV head's
    query heads. Returns (dq, dk, dv) in q's dtype."""
    b, nq, t, d = q.shape
    _, nkv, s_len, _ = k.shape
    g = nq // nkv
    s, mask = _scores(q, k, valid_from, valid_to, q_offset, causal,
                      window_block, sm_scale)
    m = m.reshape(b, nkv, g, t).float()
    l = l.reshape(b, nkv, g, t).float()
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    a = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros_like(s)) / l_safe[..., None]
    do = dout.reshape(b, nkv, g, t, d).float()
    dp = torch.einsum("bhgtd,bhsd->bhgts", do, v.float())
    ds = a * (dp - (a * dp).sum(dim=-1, keepdim=True))
    qg = q.reshape(b, nkv, g, t, d).float()
    dq = torch.einsum("bhgts,bhsd->bhgtd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhgts,bhgtd->bhsd", ds, qg) * sm_scale
    dv = torch.einsum("bhgts,bhgtd->bhsd", a, do)
    return (dq.reshape(b, nq, t, d).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


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


def _bwd_library() -> ctypes.CDLL:
    lib = load("flash_attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd.argtypes = (
            [i] + [p] * 13 + [i] * 8 + [ctypes.c_float, p])
        lib.flash_attention_bwd_tc.argtypes = (
            [p] * 13 + [i] * 8 + [ctypes.c_float, p])
        for fn in (lib.flash_attention_bwd, lib.flash_attention_bwd_tc):
            fn.restype = ctypes.c_int
    return lib


# kernel (i)'s tiles (csrc/flash_attention_bwd.cu, namespace tc): pass 1
# takes 64 query rows a block (all G heads) and walks key tiles of 32;
# pass 2 takes 64 keys a block and walks tiles of 32 query rows a head
BWD_ROWS, BWD_BLOCK_K, BWD_KEYS, BWD_BLOCK_Q = 64, 32, 64, 32


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Kernel (i)'s route: ``"tensor_cores"`` for bf16 at a head dim that
    is a multiple of 16 (mma.sync's k step), ``"cuda_cores"`` for f32 (the
    parity dtype: no tensor-core product keeps f32 to 2e-5) and for other
    head dims (trained_draft's 24)."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "tensor_cores"
    return "cuda_cores"


def bwd_plan(b, nq, nkv, t_len, s_len, *, causal, window, valid_from,
             valid_to, q_offset):
    """The tensor-core route's two grids as the kernel walks them, block by
    block in launch order: pass 1 as ``(batch row, KV head, first query
    position, block_q, [key tile starts])`` and pass 2 as ``(batch row, KV
    head, first key, [(query head of the group, first query position)])``
    (``valid_from``, ``valid_to``, ``q_offset``: a value a batch row).

    The block index counts (batch row, KV head) fastest and the tile
    slowest, by descending work under the causal mask (pass 1's last query
    tile first, pass 2's first key block first), so the longest walks
    launch first and the short ones fill in behind them. A pass-2 block's
    two streams of warps take its walk's even and odd tiles."""
    group = nq // nkv
    block_q = BWD_ROWS // group
    tiles_q = -(-t_len // block_q)
    blocks_k = -(-s_len // BWD_KEYS)
    pass1, pass2 = [], []
    for rank in range(tiles_q):
        t0 = (tiles_q - 1 - rank if causal else rank) * block_q
        for bh in range(b * nkv):
            bi, h = divmod(bh, nkv)
            # the forward's live keys of query positions [pos_lo, pos_hi]
            pos_lo = t0 + q_offset[bi]
            pos_hi = min(t0 + block_q, t_len) - 1 + q_offset[bi]
            lo, hi = max(valid_from[bi], 0), min(valid_to[bi], s_len)
            if causal:
                hi = min(hi, pos_hi + 1)
            if window > 0:
                lo = max(lo, (pos_lo // window) * window)
                hi = min(hi, (pos_hi // window + 1) * window)
            first = (lo // BWD_BLOCK_K) * BWD_BLOCK_K
            pass1.append((bi, h, t0, block_q,
                          list(range(first, hi, BWD_BLOCK_K))
                          if lo < hi else []))
    for rank in range(blocks_k):
        c0 = rank * BWD_KEYS
        for bh in range(b * nkv):
            bi, h = divmod(bh, nkv)
            klo = max(c0, valid_from[bi])
            khi = min(c0 + BWD_KEYS, s_len, valid_to[bi])
            pos_lo, pos_hi = -(1 << 40), 1 << 40
            if causal:
                pos_lo = klo
            if window > 0:
                pos_lo = max(pos_lo, (klo // window) * window)
                pos_hi = ((khi - 1) // window + 1) * window
            t_lo = min(max(pos_lo - q_offset[bi], 0), t_len)
            t_hi = min(max(pos_hi - q_offset[bi], 0), t_len)
            walk = ([(g, t) for g in range(group)
                     for t in range(t_lo, t_hi, BWD_BLOCK_Q)]
                    if klo < khi else [])
            pass2.append((bi, h, c0, walk))
    return pass1, pass2


def flash_attention_bwd(q, k, v, dout, m, l, valid_from, valid_to, q_offset,
                        *, causal: bool, window_block: int, sm_scale: float):
    """(dq, dk, dv) of ``flash_attention``'s output against ``dout``, from
    the forward's residuals m and l (the mask arguments as the forward
    took them: int32 [B] on q's device). A CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` or raises; only a CPU tensor takes
    ``flash_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, dout, m, l, valid_from, valid_to, q_offset,
            causal=causal, window_block=window_block, sm_scale=sm_scale)
    b, nq, t, d = q.shape
    nkv, s_len = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype
                                         for x in (k, v, dout)):
        raise ValueError(f"flash_attention_bwd takes f32 or bf16 q/k/v/dout "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}/"
                         f"{dout.dtype}")
    if dout.shape != q.shape or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}, dout "
                         f"{tuple(dout.shape)} disagree")
    if d % 4 or d > _MAX_D or nq % nkv or nq // nkv > _ROWS_PER_BLOCK:
        raise ValueError(f"flash_attention_bwd: head_dim {d} (a multiple of "
                         f"4 up to {_MAX_D}) or query group {nq}/{nkv} not "
                         f"taken")
    for x in (m, l):
        if x.dtype != torch.float32 or x.shape != (b, nq, t):
            raise ValueError(f"m and l must be f32 [{b}, {nq}, {t}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    tensors = (q, k, v, dout, m, l)
    if any(x.device != dev or not x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention_bwd needs contiguous q, k, v, "
                         "dout, m and l on one device")
    for x, name in ((valid_from, "kv_valid_from"), (valid_to, "kv_valid_to"),
                    (q_offset, "q_offset")):
        _check_int_vec(x, b, dev, name)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    route = bwd_route(q.dtype, d)
    # pass 1 leaves D for pass 2; the tensor-core route m log2e + log2 l too
    delta = torch.empty((b, nq, t, 2) if route == "tensor_cores"
                        else (b, nq, t), dtype=torch.float32, device=dev)
    if t == 0:
        return dq, dk.zero_(), dv.zero_()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), valid_from.data_ptr(),
            valid_to.data_ptr(), q_offset.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr())
    rest = (b, nq, nkv, t, s_len, d, int(bool(causal)), int(window_block),
            float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    lib = _bwd_library()
    if route == "tensor_cores":
        if any(p % 16 for p in ptrs[:4] + ptrs[9:12]):
            raise ValueError("flash_attention_bwd's tensor-core route needs "
                             "16-byte aligned q, k, v, dout and gradients")
        err = lib.flash_attention_bwd_tc(*ptrs, *rest)
    else:
        err = lib.flash_attention_bwd(_DTYPE_CODE[q.dtype], *ptrs, *rest)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed "
                           f"({route}): CUDA error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
# launches by route (bwd_route), each also counted in ``launches``
flash_attention_bwd.route_launches = {"tensor_cores": 0, "cuda_cores": 0}


class FlashFunction(torch.autograd.Function):
    """``flash_attention`` as an autograd function: the forward kernel (or
    its plain version on the CPU), and ``flash_attention_bwd`` as its
    backward. Saves q, k, v and the f32 residuals m and l (not the output:
    the backward takes D = rowsum(A∘dP) from the recomputed A)."""

    @staticmethod
    def forward(ctx, q, k, v, vf, vt, q_off, causal, window_block, sm_scale):
        ctx.set_materialize_grads(False)
        if q.device.type == "cpu":
            out, m, l = flash_attention_plain(
                q, k, v, vf, vt, q_off, causal=causal,
                window_block=window_block, sm_scale=sm_scale)
        else:
            out, m, l = _launch(q, k, v, vf, vt, q_off, causal=causal,
                                window_block=window_block, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, m, l, vf, vt, q_off)
        ctx.mask = (causal, window_block, sm_scale)
        return out, m, l

    @staticmethod
    def backward(ctx, dout, dm, dl):
        if dm is not None or dl is not None:
            raise NotImplementedError(
                "a cotangent on flash attention's m or l (the context-"
                "parallel combine's inputs) has no backward in the port yet "
                "(ROADMAP item 14)")
        if dout is None:
            return (None,) * 9
        q, k, v, m, l, vf, vt, q_off = ctx.saved_tensors
        causal, window_block, sm_scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, dout.contiguous(), m, l, vf, vt, q_off, causal=causal,
            window_block=window_block, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None, None, None, None


_OP_NAME = "qwen3_asr_torch::flash_attention"
_op = None
_via_op = False


def registered_op():
    """The forward as a ``torch.library`` operator, registered on first
    use (a second copy of the package in one process reuses the first's
    registration)."""
    global _op
    if _op is not None:
        return _op
    ns, name = _OP_NAME.split("::")
    try:
        _op = getattr(getattr(torch.ops, ns), name).default
        return _op
    except AttributeError:
        pass

    @torch.library.custom_op(_OP_NAME, mutates_args=(), device_types="cpu")
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_from: torch.Tensor, valid_to: torch.Tensor,
           q_offset: torch.Tensor, causal: bool, window_block: int,
           sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        return flash_attention_plain(
            q, k, v, valid_from, valid_to, q_offset, causal=causal,
            window_block=window_block, sm_scale=sm_scale)

    @op.register_kernel("cuda")
    def _(q, k, v, valid_from, valid_to, q_offset, causal, window_block,
          sm_scale):
        return _launch(q, k, v, valid_from, valid_to, q_offset,
                       causal=causal, window_block=window_block,
                       sm_scale=sm_scale)

    @op.register_fake
    def _(q, k, v, valid_from, valid_to, q_offset, causal, window_block,
          sm_scale):
        b, nq, t, _ = q.shape
        return (torch.empty_like(q),
                q.new_empty((b, nq, t), dtype=torch.float32),
                q.new_empty((b, nq, t), dtype=torch.float32))

    _op = torch.ops.qwen3_asr_torch.flash_attention.default
    return _op


@contextlib.contextmanager
def through_registered_op():
    """Within this block ``flash_attention`` calls ``registered_op()``
    (for a ``torch.export`` trace; not for autograd)."""
    global _via_op
    registered_op()
    prev, _via_op = _via_op, True
    try:
        yield
    finally:
        _via_op = prev


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, q_offset=0,
                    kv_valid_from: Optional[torch.Tensor] = None,
                    kv_valid_to: Optional[torch.Tensor] = None,
                    window_block: int = 0, sm_scale: Optional[float] = None,
                    return_residuals: bool = False):
    """q: [B, Nq, T, D]; k/v: [B, Nkv, S, D] → [B, Nq, T, D] (and, with
    ``return_residuals``, m and l as [B, Nq, T] f32).

    A CUDA tensor launches the kernel or raises; only a CPU tensor takes
    the plain version. Differentiable in q, k and v (``FlashFunction``)."""
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
    if _via_op:
        out, m, l = registered_op()(
            q.contiguous(), k.contiguous(), v.contiguous(), vf.contiguous(),
            vt.contiguous(), q_off, bool(causal), int(window_block),
            float(sm_scale))
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out, m, l = FlashFunction.apply(
            q, k, v, vf.contiguous(), vt.contiguous(), q_off, causal,
            int(window_block), float(sm_scale))
    elif dev.type == "cpu":
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
