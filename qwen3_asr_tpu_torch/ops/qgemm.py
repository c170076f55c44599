"""The weight-only quantized product of more than 16 rows (kernel C): a CUDA
kernel written by hand for Hopper (``csrc/qgemm.cu``), its plain PyTorch
versions and the wrapper.

No TPU kernel: JAX's ``qdot`` (``qwen3_asr_tpu/ops/quant.py:134-182``) runs
in XLA, which fuses the payload's widening and the scales into the dot. On
the card the prefill's and the encoder's products (hundreds of rows, and
decode steps of more than 16 rows) take this kernel where W8A8 does not
take them; it stands in for ``widened_product``, which wrote a bf16 copy
of the whole layer payload every call and ran cuBLAS on it, and which
cannot state int4's group scales without rounding ``q * s`` to bf16 or
materialising a partial product per group.

What it computes: ``out[m, n] = (sum_k x[m, k] * q[n, k]) * s[n]`` for an
int8 or ``float8_e4m3fn`` payload ``[N, K]`` (widened exactly) with N
scales, and ``out[m, n] = sum_g (sum_{k in g} x[m, k] * q[n, k]) * s[n, g]``
for int4 pairs ``[N, K/2]`` with ``[N, G]`` scales (``ops/qgemv.py``'s
layouts and rule for G); f32 sums, one rounding to ``out_dtype``: JAX's
rounding points. x is ``[M, K]`` bf16. ``qgemm_group`` takes up to three
payloads of one K that share x (q, k and v; gate and up) in one launch,
which also gives the card's SMs more blocks at the prompt's few hundred
rows.

What bounds it on the H100: at hundreds of rows, the tensor cores (w_down
at the 30 s prefill's 453 rows: 11.4 GFLOP against 12.6 MB of int8
payload); today the K loop's other work sets its pace (``PERF.md``). The
design (``csrc/qgemm.cu``): ``wgmma`` with the payload widened in
registers as its A operand (``csrc/widen.cuh``, kernel A's k
permutation) and x from shared memory as B, stored with the same
permutation in one of three buffers (wgmma reads it asynchronously);
blocks of 128 columns x 64 or 128 rows, stretches of 64 payload bytes
through a ring of 3 or 4 cp.async stages; int4 group scales applied to
each half-stretch's sum; one launch a call (a group's payloads share its
grid), no scratch, no atomics.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ._build import load
from .qgemv import (_OUT_CODE, _S_CODE, _W_CODE, MAX_GROUP, check_operands,
                    int4_product)


def widened_product(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel C's plain version for int8/fp8, and the CPU's route for
    them: x2 [M, K] float, q [N, K], s [N] → [M, N] in ``out_dtype``. The
    payload widened to x2's dtype (exact), the product with an f32 result,
    then the scale, rounded once (JAX's ``quant.py:180-182``). A bf16 CUDA
    product takes cuBLAS with an f32 output; elsewhere both operands widen
    to f32, which is exact for bf16 values. ``cuda_calls`` counts its
    calls on a CUDA tensor, which the serving path never makes."""
    if x2.is_cuda:
        widened_product.cuda_calls += 1
    w = q.to(x2.dtype)
    if x2.is_cuda and x2.dtype == torch.bfloat16:
        acc = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        acc = x2.float() @ w.float().t()
    return (acc * s.reshape(1, -1).float()).to(out_dtype)


widened_product.cuda_calls = 0


def qgemm_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``widened_product`` for
    int8/fp8, ``ops/qgemv.py`` ``int4_product`` (JAX's grouped product
    restated in f32) for int4 pairs."""
    if q.dtype == torch.uint8:
        return int4_product(x, q, s, out_dtype=out_dtype)
    return widened_product(x, q, s, out_dtype)


def _library() -> ctypes.CDLL:
    lib = load("qgemm")
    fn = lib.qgemm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, pairs, out_dtype) -> List[torch.Tensor]:
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"qgemm takes 1..{MAX_GROUP} payloads, got "
                         f"{len(pairs)}")
    ngroups = check_operands("qgemm", x, pairs, out_dtype)
    m, k = x.shape
    outs = [torch.empty((m, q.shape[0]), dtype=out_dtype, device=x.device)
            for q, _ in pairs]
    count = len(pairs)
    ptrs = ctypes.c_void_p * count
    qs = ptrs(*(q.data_ptr() for q, _ in pairs))
    ss = ptrs(*(s.data_ptr() for _, s in pairs))
    os_ = ptrs(*(o.data_ptr() for o in outs))
    ns = (ctypes.c_int * count)(*(q.shape[0] for q, _ in pairs))
    err = _library().qgemm_fwd(
        _W_CODE[pairs[0][0].dtype], _S_CODE[pairs[0][1].dtype],
        _OUT_CODE[out_dtype], count, x.data_ptr(), ctypes.addressof(qs),
        ctypes.addressof(ss), ctypes.addressof(os_), ctypes.addressof(ns),
        m, k, ngroups, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qgemm kernel launch failed: CUDA error {err}")
    qgemm.launches += 1
    return outs


def qgemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
          out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ q[N, K].T * s[N] → [M, N] in ``out_dtype`` (int4: q
    [N, K/2] pairs, s [N, G]). A CUDA tensor launches the kernel or raises
    (``ops/qgemv.py`` ``check_operands``: bf16 x, the payload dtypes and
    int4 layouts the kernels take, contiguous operands); only a CPU
    tensor takes the plain version."""
    if x.device.type == "cpu":
        return qgemm_plain(x, q, s, out_dtype=out_dtype)
    return _launch(x, [(q, s)], out_dtype)[0]


def qgemm_group(x: torch.Tensor,
                pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[qgemm(x, q, s) for q, s in pairs]`` in ONE launch on the card
    (1..3 payloads of one K, one payload dtype, scale dtype and group
    layout: q, k and v; gate and up); one plain version per payload on
    the CPU."""
    if x.device.type == "cpu":
        return [qgemm_plain(x, q, s, out_dtype=out_dtype) for q, s in pairs]
    return _launch(x, list(pairs), out_dtype)


qgemm.launches = 0
