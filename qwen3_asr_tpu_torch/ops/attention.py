"""The attention entry point of the port: ``attend(q, k, v, spec)``.

Counterpart of ``qwen3_asr_tpu/ops/attention.py``. Three routes and no
fourth: a decode step (one query token, no causal or window mask) goes to
``ops.decode_attention_batch`` or ``ops.decode_attention`` by the rule in
``decode_kernel`` (an int4 cache, with its scale planes, always to the
former); every other shape goes to ``ops.flash_attention``. Each
launches a hand-written CUDA kernel on a CUDA tensor and takes its plain
PyTorch version only on a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

# Masked-score sentinel shared by every attention path. Finite on purpose:
# -inf breaks the exp/alpha arithmetic of fully masked rows, and the
# online-softmax residuals (m, l) of different kernels must agree.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


class AttnSpec(NamedTuple):
    """Structured attention-mask descriptor (never a dense [B, T, S] bool
    on the kernel path).

      causal       — col ≤ row + q_offset
      q_offset     — global position of q row 0 (int or [B] int32)
      valid_from   — [B] first attendable key (left-padded prompt)
      valid_to     — [B] one-past-last attendable key (right padding)
      window_block — block-diagonal width (encoder windows), 0 = off
    """
    causal: bool = False
    q_offset: Union[int, torch.Tensor] = 0
    valid_from: Optional[torch.Tensor] = None
    valid_to: Optional[torch.Tensor] = None
    window_block: int = 0

    def dense_mask(self, b: int, t: int, s: int,
                   device: Union[str, torch.device]) -> torch.Tensor:
        """Expand to a [B, T, S] boolean mask (True = attend)."""
        q_off = torch.as_tensor(self.q_offset, dtype=torch.int64,
                                device=device).expand(b)
        rows = (torch.arange(t, device=device)[None, :, None]
                + q_off[:, None, None])
        cols = torch.arange(s, device=device)[None, None, :]
        mask = torch.ones((b, t, s), dtype=torch.bool, device=device)
        if self.causal:
            mask &= cols <= rows
        if self.window_block > 0:
            w = self.window_block
            mask &= (rows // w) == (cols // w)
        if self.valid_from is not None:
            mask &= cols >= self.valid_from.to(device)[:, None, None]
        if self.valid_to is not None:
            mask &= cols < self.valid_to.to(device)[:, None, None]
        return mask


def is_decode_step(q: torch.Tensor, spec: AttnSpec) -> bool:
    return q.shape[-2] == 1 and not spec.causal and spec.window_block == 0


def decode_kernel(batch: int, head_dim: int, cache_len: int,
                  cache_dtype: torch.dtype) -> str:
    """Which kernel takes a decode step, by one rule:

    - ``"batched"`` (``ops.decode_attention_batch``, the TPU's batch-major
      kernel) takes every step whose cache is fp8 or int4 (``torch.int4``
      names the packed int4 cache with scales), and every bf16 step at
      B >= 2. All need head_dim 128 and a cache length that is a multiple
      of 128, as the TPU kernel does (``cache_length`` rounds it to 128).
    - ``"single"`` (``ops.decode_attention``) keeps f32 caches, and bf16
      at B = 1 or head_dim != 128.

    An fp8 or int4 cache with head_dim != 128 has no kernel and raises
    ValueError; the engine asks at construction, so a request never meets
    it."""
    fits = head_dim == 128 and cache_len % 128 == 0
    if cache_dtype in (torch.float8_e4m3fn, torch.int4):
        if not fits:
            name = "fp8" if cache_dtype == torch.float8_e4m3fn else "int4"
            raise ValueError(f"an {name} KV cache needs head_dim 128 "
                             f"and a cache length that is a multiple of "
                             f"128, got {head_dim} and {cache_len}")
        return "batched"
    if cache_dtype == torch.bfloat16 and batch >= 2 and fits:
        return "batched"
    return "single"


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           spec: AttnSpec, *, scale: Optional[float] = None,
           layer_idx: int = 0, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Nq, T, D]; k/v: [B, Nkv, S, D], or the stacked cache
    [L, B, Nkv, S, D] with ``layer_idx`` for a decode step; or, for a
    decode step only, the packed int4 cache with its scale planes
    ``k_scale``/``v_scale`` (a prefill reads a dequantized layer)."""
    if is_decode_step(q, spec):
        cache_dtype = torch.int4 if k_scale is not None else k.dtype
        if decode_kernel(q.shape[0], q.shape[-1], k.shape[-2],
                         cache_dtype) == "batched":
            from .decode_attention_batch import decode_attention_batched
            return decode_attention_batched(
                q, k, v, layer_idx=layer_idx, kv_valid_from=spec.valid_from,
                kv_valid_to=spec.valid_to, sm_scale=scale, k_scale=k_scale,
                v_scale=v_scale)
        from .decode_attention import decode_attention
        return decode_attention(q, k, v, layer_idx=layer_idx,
                                kv_valid_from=spec.valid_from,
                                kv_valid_to=spec.valid_to, sm_scale=scale)
    if k_scale is not None:
        raise ValueError("only a decode step reads the int4 cache as it is")
    if k.dim() == 5:
        k, v = k[layer_idx], v[layer_idx]   # contiguous views, no copy
    from .flash_attention import flash_attention
    return flash_attention(q, k, v, causal=spec.causal,
                           q_offset=spec.q_offset,
                           kv_valid_from=spec.valid_from,
                           kv_valid_to=spec.valid_to,
                           window_block=spec.window_block, sm_scale=scale)
