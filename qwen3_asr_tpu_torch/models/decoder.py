"""Qwen3 text decoder in PyTorch: GQA + QK-norm + RoPE + SwiGLU.

Counterpart of ``qwen3_asr_tpu/models/decoder.py``. Weights are bf16/f32,
or int8/fp8/int4 leaves of ``ops.quant`` (every projection through
``qdot``, q/k/v and gate/up as one ``qdot_group`` each; the embedding and
lm_head per vocab row, int4 packed along H). The KV cache is in the working dtype, in fp8, or int4
with per-(token, head) scales (``torch.int4`` names it;
``ops/kv_int4.py`` holds its layout). Parameters are the JAX package's
stacked layout (``[L, ...]`` per-layer tensors, matrices as ``[in, out]``;
quantized payloads ``[..., out, in]``); the layer loop is a Python loop.
The KV cache is the stacked ``[L, B, n_kv, S, D]`` pair (plus the scale
planes), written a layer at a time with QK-norm and RoPE in one op
(``ops/qk_rope_kv.py``); prefill attention goes through the flash kernel
and each decode step through a decode kernel (``ops.attention.attend``
picks which), which reads the stacked cache at the layer index without a
copy. Training runs ``decoder_forward`` with ``cache=None``: each layer's
keys and values are its own T tokens' (what JAX's ``asr_loss`` reads back
from a fresh cache of length T written at 0), through the differentiable
``qk_rope`` and flash attention.

A tensor-parallel shard (``parallel/mesh.py`` ``shard_model``) runs the
same code on its heads and FFN columns: its config holds the local counts
and a ``TPShard``, and the layer calls the collectives
(``parallel/collectives.py``) after wo and w_down, after the
vocab-sharded lookup, and on the logits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.attention import AttnSpec, attend, is_decode_step
from ..ops.kv_int4 import dequantize_layer
from ..ops.qk_rope_kv import qk_rope, qk_rope_kv_write, rms_norm
from ..ops.quant import (is_packed_int4, is_quantized, layer_slice, qdot,
                         qdot_group, qlogits, unpack_int4)
from ..parallel.collectives import (copy_to_tp, gather_from_tp,
                                    reduce_from_tp, tp_of)
from .config import DecoderConfig


class KVCache(NamedTuple):
    """[L, B, n_kv, S, D] stacked cache (k, v). An int4 cache holds the
    values packed two a byte, [L, B, n_kv, S, D/2] uint8, and its bf16
    scale planes ``k_scale``/``v_scale`` [L, B, n_kv, S, 1]."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def int4(self) -> bool:
        return self.k_scale is not None


KV_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn, torch.int4)


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device) -> KVCache:
    """Zeros in ``dtype``: f32, bf16, fp8 (``float8_e4m3fn``, the JAX
    package's plain ``astype`` cache, with no scales), or ``torch.int4``
    (packed values and bf16 scales, the JAX package's int4 cache)."""
    if dtype not in KV_DTYPES:
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported: the port takes "
            f"{KV_DTYPES} (ROADMAP §1 item 6)")
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
             max_len, cfg.head_dim)
    if dtype == torch.int4:
        packed = shape[:-1] + (cfg.head_dim // 2,)
        scales = shape[:-1] + (1,)
        return KVCache(
            torch.zeros(packed, dtype=torch.uint8, device=device),
            torch.zeros(packed, dtype=torch.uint8, device=device),
            torch.zeros(scales, dtype=torch.bfloat16, device=device),
            torch.zeros(scales, dtype=torch.bfloat16, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: [B, T] integer → cos/sin [B, T, head_dim] (f32)."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=positions.device) / half))
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


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


def _layer(cfg: DecoderConfig, hidden: torch.Tensor, params: dict, i: int,
           cos: torch.Tensor, sin: torch.Tensor, cache: Optional[KVCache],
           write_pos: Union[int, torch.Tensor], spec: AttnSpec
           ) -> torch.Tensor:
    lp = layer_slice(params["layers"], i)
    d, eps = cfg.head_dim, cfg.rms_norm_eps

    x = copy_to_tp(rms_norm(hidden, lp["ln1"], eps), tp_of(cfg))
    # q, k and v read one x: one launch of the quantized GEMV on the card
    q, k, v = qdot_group(x, [lp["wq"], lp["wk"], lp["wv"]])
    if cache is None:
        # training: attend to this layer's own keys, differentiably
        # the norms' weights serve every head: under tp their gradient is
        # the sum over the ranks' heads
        tp = tp_of(cfg)
        q, k, v = qk_rope(q, k, v, copy_to_tp(lp["q_norm"], tp),
                          copy_to_tp(lp["k_norm"], tp), cos, sin, eps)
        attn = attend(q, k, v, spec, scale=d ** -0.5)
        return _layer_tail(cfg, hidden, lp, attn)
    # QK-norm and RoPE on q and k, and K and V written IN PLACE at (layer
    # i, write_pos): only the T new tokens are stored, in the cache's
    # format (an int4 cache quantizes them on the way). One launch on the
    # card. (The JAX package's dynamic_update_slice is functional and
    # relies on XLA aliasing for the same effect.) q comes back
    # [B, nq, T, D], contiguous.
    q = qk_rope_kv_write(q, k, v, lp["q_norm"], lp["k_norm"], cos, sin, eps,
                         cache, i, write_pos)

    if is_decode_step(q, spec):
        attn = attend(q, cache.k, cache.v, spec, scale=d ** -0.5, layer_idx=i,
                      k_scale=cache.k_scale, v_scale=cache.v_scale)
    elif cache.int4:
        # A prefill folds the scales into a widened copy of this layer, as
        # the JAX package's TPU route does before flash: once per request
        # and layer.
        attn = attend(q, dequantize_layer(cache.k[i], cache.k_scale[i],
                                          q.dtype),
                      dequantize_layer(cache.v[i], cache.v_scale[i], q.dtype),
                      spec, scale=d ** -0.5)
    else:
        # The flash kernel takes K/V in q's dtype, so a prefill over an fp8
        # cache widens this layer first, as the JAX decoder's
        # ``k_layer.astype(q.dtype)`` does: a copy of one layer, once per
        # request and layer.
        attn = attend(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype),
                      spec, scale=d ** -0.5)
    return _layer_tail(cfg, hidden, lp, attn)


def _layer_tail(cfg: DecoderConfig, hidden: torch.Tensor, lp: dict,
                attn: torch.Tensor) -> torch.Tensor:
    """wo and the residual, then the SwiGLU block: attn [B, nq, T, D]."""
    b, t, _ = hidden.shape
    eps, tp = cfg.rms_norm_eps, tp_of(cfg)
    attn = attn.transpose(1, 2).reshape(b, t, -1)
    hidden = hidden + reduce_from_tp(qdot(attn, lp["wo"]), tp)

    x = copy_to_tp(rms_norm(hidden, lp["ln2"], eps), tp)
    gate, up = qdot_group(x, [lp["w_gate"], lp["w_up"]])
    gated = F.silu(gate) * up
    return hidden + reduce_from_tp(qdot(gated, lp["w_down"]), tp)


def decoder_forward(params: dict, cfg: DecoderConfig,
                    inputs_embeds: torch.Tensor, positions: torch.Tensor,
                    cache: Optional[KVCache],
                    write_pos: Union[int, torch.Tensor],
                    spec: AttnSpec) -> Tuple[torch.Tensor,
                                             Optional[KVCache]]:
    """Run all layers. inputs_embeds: [B,T,H]; positions: [B,T]; cache:
    the stacked cache, updated in place at ``write_pos``: a host int (the
    prefill), a 0-d int64 tensor on the cache's device (a decode step,
    which then holds no host integer), or a ``[B]`` int64 tensor there,
    row b writing its T keys from ``write_pos[b]`` (the resume loop's rows,
    each at its own frontier). ``cache=None`` is training's forward: no
    cache, differentiable (``write_pos`` unused).

    Returns (final_hidden [B,T,H], cache)."""
    if cache is not None and not cache.int4 and cache.k.dtype not in (
            inputs_embeds.dtype, torch.float8_e4m3fn):
        raise ValueError(f"cache dtype {cache.k.dtype} is neither the "
                         f"working dtype {inputs_embeds.dtype} nor fp8")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    hidden = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        hidden = _layer(cfg, hidden, params, i, cos, sin, cache, write_pos,
                        spec)
    return rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps), cache


def embed_tokens(params: dict, ids: torch.Tensor,
                 cfg: Optional[DecoderConfig] = None) -> torch.Tensor:
    """A quantized embedding gathers payload rows (int4: unpacked along H,
    the low nibbles then the high ones), widens them to f32, multiplies the
    row scales and casts to the scales' dtype (the model's compute dtype),
    as ``qwen3_asr_tpu/models/decoder.py:367-379``. A tensor-parallel
    shard's ``cfg`` (required there) names its vocab slice: ids outside it
    give zero rows, and the ranks' rows are summed."""
    tp = tp_of(cfg)
    if tp is None:
        return _embed_rows(params["embed"], ids)
    w = params["embed"]
    rows = (w["q"] if is_quantized(w) else w).shape[0]
    local = ids - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    out = _embed_rows(w, torch.where(inside, local, torch.zeros_like(local)))
    return reduce_from_tp(out * inside[..., None].to(out.dtype), tp)


def _embed_rows(w, ids: torch.Tensor) -> torch.Tensor:
    if not is_quantized(w):
        return F.embedding(ids, w)
    q = w["q"]
    # fp8 has no index kernel everywhere: the same bytes through uint8
    rows = (q.view(torch.uint8)[ids].view(q.dtype)
            if q.dtype == torch.float8_e4m3fn else q[ids])
    if is_packed_int4(w):
        rows = unpack_int4(rows)
    return (rows.float() * w["s"][ids].float()).to(w["s"].dtype)


def lm_logits(params: dict, cfg: DecoderConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """hidden: [..., H] → logits [..., V] in f32. In bf16 the product is
    taken in bf16 (f32 accumulation) and widened; in f32 it is exact f32.
    A quantized embedding or lm_head (both stored ``[V, H]``, int4
    ``[V, H/2]`` with row or group scales) takes ``ops.quant.qlogits``:
    ``(h @ q.T) * s`` in f32 (int4 groups: each group's sum scaled, then
    added), on the card through the quantized GEMV or GEMM."""
    tp = tp_of(cfg)
    hidden = copy_to_tp(hidden, tp)
    w = params["embed"] if cfg.tie_word_embeddings else params["lm_head"]
    if is_quantized(w):
        return gather_from_tp(qlogits(hidden, w), tp)
    if not cfg.tie_word_embeddings:
        w = w.T
    return gather_from_tp(F.linear(hidden, w).float(), tp)
