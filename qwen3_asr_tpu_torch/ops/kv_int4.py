"""The int4 KV cache: its layout, and the plain quantize, pack, unpack and
write of a layer's new K and V (with ``write_kv``, the indexed write every
cache dtype's plain version uses). On the card the write is part of
``ops/qk_rope_kv.py``'s kernel, which these plain versions stand behind.

No TPU kernel: JAX's ``_kv_quantize`` and its ``dynamic_update_slice``
(``qwen3_asr_tpu/models/decoder.py:132-143,240-261``) run in XLA. JAX
stores ``jnp.int4`` values [L, B, n_kv, S, D] and bf16 scales
[L, B, n_kv, S, 1]. The port stores the same values packed two a byte,
``[L, B, n_kv, S, D/2]`` uint8: byte j of a row holds dims 2j (low nibble)
and 2j + 1 (high nibble), each as value + 8; the scales are the same bf16
planes.

What it computes per (token, head) row of x: ``scale = max(absmax/7,
1e-8)`` in f32, ``q = clip(round(x / scale), -8, 7)`` with the f32 scale
(round half to even), the scale stored rounded to bf16: JAX's bytes.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from .quant import div

HEAD_DIM = 128            # the head_dim the card's int4 routes take


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float → (int8 values in [-8, 7], f32 scale [..., 1])."""
    xf = x.float()
    scale = torch.clamp_min(div(xf.abs().amax(dim=-1, keepdim=True), 7.0),
                            1e-8)
    return torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int8), scale


def pack(q: torch.Tensor) -> torch.Tensor:
    """int8 values [..., D] → uint8 [..., D/2] (dims 2j low, 2j + 1 high)."""
    u = (q + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D/2] → int8 values [..., D]."""
    lo = (p & 15).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def dequantize_layer(payload: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """One layer [B, n_kv, S, D/2] + [B, n_kv, S, 1] → [B, n_kv, S, D] in
    ``dtype``: the values times the scale, both in ``dtype``, as JAX folds
    the scales for a prefill (``qwen3_asr_tpu/ops/attention.py:127-135``)."""
    return unpack(payload).to(dtype) * scale.to(dtype)


def write_kv(layer: torch.Tensor, new: torch.Tensor,
             write_pos: Union[int, torch.Tensor]) -> None:
    """layer [B, n_kv, S, ...] <- new [B, n_kv, T, ...] (cast to the
    layer's dtype) at keys ``write_pos .. write_pos + T - 1``, IN PLACE: the
    plain write of every cache plane. A host int slices; a 0-d int64 tensor
    indexes on the tensor's device; a ``[B]`` int64 tensor gives row b its
    own keys ``write_pos[b] ..``, JAX's per-row scatter
    (``qwen3_asr_tpu/models/decoder.py:249-257``), whose keys at or past S
    are dropped."""
    new = new.to(layer.dtype)
    if torch.is_tensor(write_pos) and write_pos.dim() == 1 \
            and write_pos.numel() == new.shape[0] > 1:
        _write_rows(layer, new, write_pos)
        return
    if not torch.is_tensor(write_pos):
        layer[:, :, write_pos:write_pos + new.shape[2]] = new
        return
    idx = write_pos.reshape(1) + torch.arange(new.shape[2],
                                              device=layer.device)
    if layer.dtype == torch.float8_e4m3fn:
        # index_copy_ has no fp8 kernel: the same bytes through uint8 views
        layer, new = layer.view(torch.uint8), new.view(torch.uint8)
    layer.index_copy_(2, idx, new)


def _write_rows(layer: torch.Tensor, new: torch.Tensor,
                write_pos: torch.Tensor) -> None:
    """Row b's T keys at ``write_pos[b] + t``, keys at or past S dropped,
    with no host read (a CUDA graph may capture it): a dropped key is sent
    to S - 1 carrying what S - 1 gets anyway (the row's key there, or its
    old value), so every write to one slot writes the same bytes."""
    b, t, s_len = new.shape[0], new.shape[2], layer.shape[2]
    if layer.dtype == torch.float8_e4m3fn:
        # index_put_ has no fp8 kernel: the same bytes through uint8 views
        layer, new = layer.view(torch.uint8), new.view(torch.uint8)
    rows = torch.arange(b, device=layer.device)[:, None]
    want = write_pos[:, None] + torch.arange(t, device=layer.device)
    idx = want.clamp(0, s_len - 1)                           # [B, T]
    # the token that lands on S - 1 (if any) supplies the dropped keys
    src = torch.minimum(torch.arange(t, device=layer.device)[None, :],
                        (s_len - 1 - write_pos)[:, None]).clamp(min=0)
    live = (write_pos[:, None] + src) < s_len
    moved = new.transpose(1, 2)                              # [B, T, n_kv, ...]
    picked = moved[rows, src]
    old = layer[rows, :, idx]                                # [B, T, n_kv, ...]
    mask = live.reshape(live.shape + (1,) * (old.dim() - 2))
    layer[rows, :, idx] = torch.where(mask, picked, old)


def kv_int4_write_plain(cache, layer: int, k_new: torch.Tensor,
                        v_new: torch.Tensor,
                        write_pos: Union[int, torch.Tensor]) -> None:
    """Quantize k_new / v_new [B, n_kv, T, D] and write them, with their
    scales, into layer ``layer`` of ``cache`` at keys write_pos .. + T - 1."""
    for new, payload, scales in ((k_new, cache.k, cache.k_scale),
                                 (v_new, cache.v, cache.v_scale)):
        q, scale = quantize_kv(new)
        write_kv(payload[layer], pack(q), write_pos)
        write_kv(scales[layer], scale.to(torch.bfloat16), write_pos)
