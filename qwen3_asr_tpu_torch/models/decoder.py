"""Qwen3 text decoder in PyTorch: GQA + QK-norm + RoPE + SwiGLU.

Counterpart of ``qwen3_asr_tpu/models/decoder.py`` for bf16/f32 weights,
with a KV cache in the working dtype or in fp8 (no quantized weights, and
no int4 KV, in the port yet). Parameters are the JAX package's stacked
layout (``[L, ...]`` per-layer tensors, matrices as ``[in, out]``); the
layer loop is a Python loop. The KV cache is the stacked
``[L, B, n_kv, S, D]`` pair; prefill attention goes through the flash kernel
and each decode step through a decode kernel (``ops.attention.attend``
picks which), which reads the stacked cache at the layer index without a
copy.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.attention import AttnSpec, attend, is_decode_step
from .config import DecoderConfig


class KVCache(NamedTuple):
    """[L, B, n_kv, S, D] stacked cache (k, v)."""
    k: torch.Tensor
    v: torch.Tensor


KV_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> KVCache:
    """Zeros in ``dtype``: f32, bf16, or fp8 (``float8_e4m3fn``, the JAX
    package's plain ``astype`` cache, with no scales)."""
    if dtype not in KV_DTYPES:
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported: quantized caches with "
            f"scales (int4) wait on ROADMAP §1 item 6")
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
             max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: [B, T] integer → cos/sin [B, T, head_dim] (f32)."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=positions.device) / half))
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, N, T, D]; cos/sin: [B, T, D] (half-split rotation)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    out = xf * cos[:, None] + rotated * sin[:, None]
    return out.to(x.dtype)


def init_decoder_params(cfg: DecoderConfig, generator: torch.Generator,
                        device, dtype: torch.dtype = torch.float32
                        ) -> dict:
    """Random weights at scale 0.02 (norms 1), drawn with ``generator`` on
    ``device``; the JAX package's stacked layout."""
    l, h, i = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nq, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def rnd(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    params = {
        "embed": rnd(cfg.vocab_size, h),
        "layers": {
            "ln1": ones(l, h), "ln2": ones(l, h),
            "wq": rnd(l, h, nq * d), "wk": rnd(l, h, nkv * d),
            "wv": rnd(l, h, nkv * d), "wo": rnd(l, nq * d, h),
            "q_norm": ones(l, d), "k_norm": ones(l, d),
            "w_gate": rnd(l, h, i), "w_up": rnd(l, h, i),
            "w_down": rnd(l, i, h),
        },
        "final_norm": ones(h),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rnd(h, cfg.vocab_size)
    return params


def _write_kv(layer: torch.Tensor, new: torch.Tensor,
              write_pos: Union[int, torch.Tensor]) -> None:
    """layer [B, n_kv, S, D] <- new [B, n_kv, T, D] (cast to the cache
    dtype) at keys ``write_pos .. write_pos + T - 1``, IN PLACE. A host int
    slices; a 0-d int64 device tensor (the decode step, which a CUDA graph
    replays at a new position each time) indexes on the device."""
    new = new.to(layer.dtype)
    if not torch.is_tensor(write_pos):
        layer[:, :, write_pos:write_pos + new.shape[2]] = new
        return
    idx = write_pos.reshape(1) + torch.arange(new.shape[2],
                                              device=layer.device)
    if layer.dtype == torch.float8_e4m3fn:
        # index_copy_ has no fp8 kernel: the same bytes through uint8 views
        layer, new = layer.view(torch.uint8), new.view(torch.uint8)
    layer.index_copy_(2, idx, new)


def _layer(cfg: DecoderConfig, hidden: torch.Tensor, params: dict, i: int,
           cos: torch.Tensor, sin: torch.Tensor, cache: KVCache,
           write_pos: Union[int, torch.Tensor], spec: AttnSpec
           ) -> torch.Tensor:
    lp = {k: w[i] for k, w in params["layers"].items()}
    b, t, _ = hidden.shape
    nq, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps

    x = rms_norm(hidden, lp["ln1"], eps)
    q = (x @ lp["wq"]).reshape(b, t, nq, d).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(b, t, nkv, d).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(b, t, nkv, d).transpose(1, 2)
    q = apply_rope(rms_norm(q, lp["q_norm"], eps), cos, sin).contiguous()
    k = apply_rope(rms_norm(k, lp["k_norm"], eps), cos, sin)

    # Written IN PLACE at (layer i, write_pos): only the T new tokens are
    # stored. (The JAX package's dynamic_update_slice is functional and
    # relies on XLA aliasing for the same effect.)
    _write_kv(cache.k[i], k, write_pos)
    _write_kv(cache.v[i], v, write_pos)

    if is_decode_step(q, spec):
        attn = attend(q, cache.k, cache.v, spec, scale=d ** -0.5, layer_idx=i)
    else:
        # The flash kernel takes K/V in q's dtype, so a prefill over an fp8
        # cache widens this layer first, as the JAX decoder's
        # ``k_layer.astype(q.dtype)`` does: a copy of one layer, once per
        # request and layer.
        attn = attend(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype),
                      spec, scale=d ** -0.5)
    attn = attn.transpose(1, 2).reshape(b, t, nq * d)
    hidden = hidden + attn @ lp["wo"]

    x = rms_norm(hidden, lp["ln2"], eps)
    gated = F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return hidden + gated @ lp["w_down"]


def decoder_forward(params: dict, cfg: DecoderConfig,
                    inputs_embeds: torch.Tensor, positions: torch.Tensor,
                    cache: KVCache, write_pos: Union[int, torch.Tensor],
                    spec: AttnSpec) -> Tuple[torch.Tensor, KVCache]:
    """Run all layers. inputs_embeds: [B,T,H]; positions: [B,T]; cache:
    the stacked cache, updated in place at ``write_pos``: a host int (the
    prefill), or a 0-d int64 tensor on the cache's device (a decode step,
    which then holds no host integer).

    Returns (final_hidden [B,T,H], cache)."""
    if cache.k.dtype not in (inputs_embeds.dtype, torch.float8_e4m3fn):
        raise ValueError(f"cache dtype {cache.k.dtype} is neither the "
                         f"working dtype {inputs_embeds.dtype} nor fp8")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    hidden = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        hidden = _layer(cfg, hidden, params, i, cos, sin, cache, write_pos,
                        spec)
    return rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps), cache


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, params["embed"])


def lm_logits(params: dict, cfg: DecoderConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """hidden: [..., H] → logits [..., V] in f32. In bf16 the product is
    taken in bf16 (f32 accumulation) and widened; in f32 it is exact f32."""
    w = params["embed"] if cfg.tie_word_embeddings else params["lm_head"].T
    return F.linear(hidden, w).float()
