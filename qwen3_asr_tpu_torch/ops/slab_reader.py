"""The KV slab-read probe: a CUDA kernel written by hand for Hopper
(``csrc/slab_reader.cu``), its plain PyTorch version, and the wrapper.

Replaces the TPU kernel ``tools_perf/attn_phase.py`` ``_slab_kernel``
(built by ``make_slab_reader``). It reads one layer of the stacked cache
``[L, B, Nkv, S, D]``, every byte of it, in batch-major slabs of ``bs``
positions, and returns that kernel's ``[B, D]`` f32 output::

    o[b, :] = sum over j of (k[b, 0, j*bs, :] + v[b, 0, j*bs, :] + seed)

It does no work worth counting besides the read, so its time is the read
rate of the cache on this card: the realistic ceiling for the decode
attention kernels (``tools_perf/attn_phase.py`` measures it).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load

_DTYPE_CODE = {torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# Compared at run time with each thread's XOR of the words it loaded, so
# the compiler must keep every load (csrc/slab_reader.cu).
SENTINEL = 0x9E3779B9


def slab_read_plain(k: torch.Tensor, v: torch.Tensor, *, layer_idx: int,
                    seed: int, block_s: int) -> torch.Tensor:
    """The probe's output without the read: the sliver terms summed."""
    if k.dim() == 5:
        k, v = k[layer_idx], v[layer_idx]
    terms = (k[:, 0, ::block_s].float() + v[:, 0, ::block_s].float()
             ) + float(seed)
    return terms.sum(dim=1)


def _library() -> ctypes.CDLL:
    lib = load("slab_reader")
    fn = lib.slab_read_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, ctypes.c_uint, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(k, v, *, layer_idx, seed, block_s):
    n_layers = k.shape[0] if k.dim() == 5 else 1
    b, nkv, s_len, d = k.shape[-4:]
    dev = k.device
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"slab_read takes one cache dtype of "
                         f"{list(_DTYPE_CODE)}, got {k.dtype}/{v.dtype}")
    if v.shape != k.shape or v.device != dev or k.dim() not in (4, 5):
        raise ValueError(f"k/v must be one [L,B,Nkv,S,D] shape on one "
                         f"device, got {tuple(k.shape)}/{tuple(v.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("slab_read needs a contiguous cache")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the cache must be 16-byte aligned")
    if (block_s * d * k.element_size()) % 16:
        raise ValueError(f"a slab row run of {block_s}x{d} is not a whole "
                         f"number of 16-byte loads")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {n_layers})")
    terms = torch.empty((b, s_len // block_s, d), dtype=torch.float32,
                        device=dev)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    sink = torch.empty((1,), dtype=torch.int32, device=dev)
    err = _library().slab_read_fwd(
        _DTYPE_CODE[k.dtype], k.data_ptr(), v.data_ptr(), terms.data_ptr(),
        out.data_ptr(), sink.data_ptr(), SENTINEL, layer_idx, b, nkv, s_len,
        d, block_s, float(seed), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slab_read kernel launch failed: CUDA error {err}")
    slab_read.launches += 1
    return out


def slab_read(k: torch.Tensor, v: torch.Tensor, *, layer_idx: int = 0,
              seed: int = 0, block_s: int = 128) -> torch.Tensor:
    """k/v: the stacked cache [L, B, Nkv, S, D] (or one layer [B, Nkv, S,
    D]), bf16 or fp8, S a multiple of ``block_s`` → [B, D] f32.

    A CUDA tensor launches the kernel or raises; only a CPU tensor takes
    the plain version."""
    if k.shape[-2] % block_s:
        raise ValueError(f"cache length {k.shape[-2]} is not a multiple of "
                         f"block_s {block_s}")
    layer_idx = int(layer_idx) if k.dim() == 5 else 0
    if k.device.type == "cpu":
        return slab_read_plain(k, v, layer_idx=layer_idx, seed=int(seed),
                               block_s=int(block_s))
    return _launch(k, v, layer_idx=layer_idx, seed=int(seed),
                   block_s=int(block_s))


slab_read.launches = 0
