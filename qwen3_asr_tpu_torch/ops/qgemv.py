"""The weight-only quantized product of decode rows: a CUDA kernel written by
hand for Hopper (``csrc/qgemv.cu``), its plain PyTorch version, and the
wrapper.

No TPU kernel: JAX's ``qdot`` (``qwen3_asr_tpu/ops/quant.py:134-182``) runs
in XLA, which fuses the payload's widening and the scale into the dot. On
the card the decode step's products must read the int8/fp8 payload itself:
a bf16 copy widened every step would read more bytes than bf16 weights do.

What it computes: ``out[m, n] = (sum_k x[m, k] * q[n, k]) * s[n]``, the
payload widened exactly, the sum in f32, rounded once to ``out_dtype``
(x's dtype for a layer, f32 for the logits): JAX's rounding points. ``x``
is ``[M, K]`` bf16 with M <= ``GEMV_MAX_ROWS``; ``q`` is ``[N, K]`` int8 or
``float8_e4m3fn`` (the contraction dim contiguous, ``ops/quant.py``'s
layout); ``s`` holds N scales, f32 or bf16.

What bounds it on the H100: the payload's bytes, N*K once. The design: x
staged in shared memory once per block; each warp takes a few output
columns (``plan``), each lane loads 16 payload bytes at a time (a warp
reads 512 contiguous bytes), widens them and multiplies them into one f32
accumulator per row, and a warp reduction ends the column.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._build import load

GEMV_MAX_ROWS = 16           # kMaxRows in csrc/qgemv.cu
_MAX_SMEM = 232448           # kMaxSmem: staged x, M rows padded to 2^k
_WARPS = 8                   # kWarps
_SMS = 132
_W_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
_S_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def qgemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] float, q [N, K], s [N] → [M, N] in ``out_dtype``: the
    payload widened to x's dtype, the product with an f32 result, then the
    scale, rounded once. (``qdot``'s plain route, for any number of rows.)
    A bf16 CUDA product takes cuBLAS with an f32 output; elsewhere both
    operands widen to f32, which is exact for bf16 values."""
    w = q.to(x.dtype)
    if x.is_cuda and x.dtype == torch.bfloat16:
        acc = torch.mm(x, w.t(), out_dtype=torch.float32)
    else:
        acc = x.float() @ w.float().t()
    return (acc * s.reshape(1, -1).float()).to(out_dtype)


def plan(m: int, n: int) -> Tuple[int, int]:
    """The kernel's (rows, cols) for an [m, K] x [n, K] product: rows the
    next power of two of m; cols the output columns a warp takes, up to 16,
    while the grid keeps about two blocks of 8 warps an SM."""
    rows = 1
    while rows < m:
        rows *= 2
    return rows, max(1, min(16, n // (_WARPS * 2 * _SMS)))


def _library() -> ctypes.CDLL:
    lib = load("qgemv")
    fn = lib.qgemv_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, q, s, out_dtype):
    m, k = x.shape
    n = q.shape[0]
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise ValueError(f"qgemv takes bf16 activations, got {x.dtype}")
    if q.dtype not in _W_CODE or s.dtype not in _S_CODE \
            or out_dtype not in _OUT_CODE:
        raise ValueError(f"qgemv takes int8/fp8 payloads, f32/bf16 scales "
                         f"and an f32/bf16 output, got {q.dtype}, "
                         f"{s.dtype}, {out_dtype}")
    if q.device != dev or s.device != dev:
        raise ValueError("x, q and s must be on one device")
    if q.dim() != 2 or q.shape[1] != k or s.numel() != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not match")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("qgemv needs contiguous x, q and s")
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    if k % 16 or x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"qgemv needs K a multiple of 16 and 16-byte "
                         f"aligned x and q, got K={k}")
    rows, cols = plan(m, n)
    smem = rows * k * 2
    if smem > _MAX_SMEM:
        raise ValueError(f"{rows} rows of K={k} exceed the kernel's shared "
                         f"memory")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = _library().qgemv_fwd(
        _W_CODE[q.dtype], _S_CODE[s.dtype], _OUT_CODE[out_dtype],
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k,
        rows, cols, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qgemv kernel launch failed: CUDA error {err}")
    qgemv.launches += 1
    return out


def qgemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
          out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ q[N, K].T * s[N] → [M, N] in ``out_dtype``. A CUDA tensor
    launches the kernel or raises; only a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return qgemv_plain(x, q, s, out_dtype=out_dtype)
    return _launch(x, q, s.reshape(-1), out_dtype)


qgemv.launches = 0
