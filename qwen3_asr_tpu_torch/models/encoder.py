"""AuT audio encoder in PyTorch (the Qwen3-Omni audio tower design).

Counterpart of ``qwen3_asr_tpu/models/encoder.py``: log-mel [B, n_mels, T]
is cut into chunks of ``n_window*2`` frames; each chunk runs three stride-2
conv2d + exact GELU stages, ``conv_out`` to d_model and a sinusoid
positional embedding that restarts per chunk; then ``encoder_layers``
pre-LN blocks whose self-attention is block-diagonal over windows (through
``ops.attention.attend``, i.e. the flash kernel on the card); finally
ln_post → proj1 → GELU → proj2 into the decoder's hidden space. Only the
last chunk can be partial, so valid tokens are a prefix: validity is one
length per row (``valid_to``). The layers' projections go through
``ops.quant.qdot`` (q, k and v as one ``qdot_group``), so int8, fp8 and
int4 weights (``QUANTIZE``) work as in JAX. A tensor-parallel shard
(``parallel/mesh.py``) holds its heads, FFN and proj1 columns and conv_out
features; its config's ``TPShard`` makes the layers call their
collectives, and the biases of wo, fc2 and proj2 are added once, after
the sum over the ranks.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import AttnSpec, attend
from ..ops.quant import layer_slice, qdot, qdot_group
from ..parallel.collectives import (copy_to_tp, gather_from_tp,
                                    reduce_from_tp, tp_of)
from .config import AudioEncoderConfig


def sinusoid_position_embedding(length: int, channels: int,
                                max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper-style sinusoidal PE [length, channels]."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _position_embedding(length: int, channels: int, device: torch.device,
                        dtype: torch.dtype) -> torch.Tensor:
    """The sinusoid PE on ``device``, copied there once: a CUDA graph
    capture refuses host-to-device copies, and the eager run before it
    fills this cache."""
    return torch.from_numpy(sinusoid_position_embedding(length, channels)).to(
        device=device, dtype=dtype)


def conv_tokens_per_chunk(chunk_frames: int) -> int:
    t = chunk_frames
    for _ in range(3):
        t = (t - 1) // 2 + 1
    return t


def encoder_output_length(feature_len, chunk_frames: int):
    """Valid token count for a mel length (int or integer tensor)."""
    per_chunk = conv_tokens_per_chunk(chunk_frames)
    n_full = feature_len // chunk_frames
    r = feature_len % chunk_frames
    return n_full * per_chunk + (r + 7) // 8


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * w.float() + b.float()).to(x.dtype)


def init_encoder_params(cfg: AudioEncoderConfig, generator: torch.Generator,
                        device, dtype: torch.dtype = torch.float32
                        ) -> dict:
    """Random weights at scale 0.02 (biases 0, norms 1), drawn with
    ``generator`` on ``device``; the JAX package's layout."""
    l, d, ffn = cfg.encoder_layers, cfg.d_model, cfg.encoder_ffn_dim
    ch = cfg.downsample_hidden_size

    def rnd(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "conv1_w": rnd(ch, 1, 3, 3), "conv1_b": zeros(ch),
        "conv2_w": rnd(ch, ch, 3, 3), "conv2_b": zeros(ch),
        "conv3_w": rnd(ch, ch, 3, 3), "conv3_b": zeros(ch),
        "conv_out_w": rnd(cfg.conv_out_dim, d),
        "layers": {
            "ln1_w": ones(l, d), "ln1_b": zeros(l, d),
            "wq": rnd(l, d, d), "bq": zeros(l, d),
            "wk": rnd(l, d, d), "bk": zeros(l, d),
            "wv": rnd(l, d, d), "bv": zeros(l, d),
            "wo": rnd(l, d, d), "bo": zeros(l, d),
            "ln2_w": ones(l, d), "ln2_b": zeros(l, d),
            "fc1_w": rnd(l, d, ffn), "fc1_b": zeros(l, ffn),
            "fc2_w": rnd(l, ffn, d), "fc2_b": zeros(l, d),
        },
        "ln_post_w": ones(d), "ln_post_b": zeros(d),
        "proj1_w": rnd(d, d), "proj1_b": zeros(d),
        "proj2_w": rnd(d, cfg.output_dim), "proj2_b": zeros(cfg.output_dim),
    }


def _conv_frontend(params: dict, cfg: AudioEncoderConfig,
                   mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, n_mels, T] with T % chunk == 0 → tokens [B, T_tok, d_model]."""
    b, n_mels, t = mel.shape
    chunk = cfg.n_window * 2
    n_chunks = t // chunk
    x = mel.reshape(b, n_mels, n_chunks, chunk).permute(0, 2, 1, 3)
    x = x.reshape(b * n_chunks, 1, n_mels, chunk)
    for w, bias in (("conv1_w", "conv1_b"), ("conv2_w", "conv2_b"),
                    ("conv3_w", "conv3_b")):
        x = F.conv2d(x, params[w].to(x.dtype), stride=2, padding=1)
        x = F.gelu(x + params[bias].to(x.dtype)[None, :, None, None])

    bc, c, f, tt = x.shape                     # [B*n_chunks, ch, f, tok]
    x = x.permute(0, 3, 1, 2).reshape(bc, tt, c * f)
    tp = tp_of(cfg)
    x = gather_from_tp(copy_to_tp(x, tp) @ params["conv_out_w"].to(x.dtype),
                       tp)
    x = x + _position_embedding(tt, cfg.d_model, x.device, x.dtype)[None]
    return x.reshape(b, n_chunks * tt, cfg.d_model)


def _encoder_layer(cfg: AudioEncoderConfig, hidden: torch.Tensor, params: dict,
                   i: int, spec: AttnSpec) -> torch.Tensor:
    lp = layer_slice(params["layers"], i)
    b, t, d = hidden.shape
    tp = tp_of(cfg)
    nh, hd = cfg.encoder_attention_heads, cfg.head_dim
    if tp is not None:
        nh //= tp.size

    def heads(x):
        return x.reshape(b, t, nh, hd).transpose(1, 2).contiguous()

    x = copy_to_tp(layer_norm(hidden, lp["ln1_w"], lp["ln1_b"]), tp)
    # q, k and v read one x: one launch of the quantized GEMM on the card
    q, k, v = (heads(y + lp[b]) for y, b in zip(
        qdot_group(x, [lp["wq"], lp["wk"], lp["wv"]]), ("bq", "bk", "bv")))
    attn = attend(q, k, v, spec, scale=hd ** -0.5)
    attn = attn.transpose(1, 2).reshape(b, t, nh * hd)
    hidden = hidden + reduce_from_tp(qdot(attn, lp["wo"]), tp) + lp["bo"]

    x = copy_to_tp(layer_norm(hidden, lp["ln2_w"], lp["ln2_b"]), tp)
    x = F.gelu(qdot(x, lp["fc1_w"]) + lp["fc1_b"])
    return hidden + (reduce_from_tp(qdot(x, lp["fc2_w"]), tp) + lp["fc2_b"])


def encoder_forward(params: dict, cfg: AudioEncoderConfig, mel: torch.Tensor,
                    feature_lens: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel: [B, n_mels, T] bucket-padded to a multiple of n_window*2;
    feature_lens: [B] true mel frame counts.

    Returns (audio_embeds [B, n_tokens, output_dim], token_lens [B] int32).
    Tokens beyond token_lens are garbage and must be masked by the caller.
    """
    chunk = cfg.n_window * 2
    hidden = _conv_frontend(params, cfg, mel)
    token_lens = encoder_output_length(feature_lens.to(torch.int64),
                                       chunk).to(torch.int32)
    window = conv_tokens_per_chunk(chunk) * max(1, cfg.n_window_infer // chunk)
    spec = AttnSpec(window_block=window, valid_to=token_lens)
    for i in range(cfg.encoder_layers):
        hidden = _encoder_layer(cfg, hidden, params, i, spec)
    tp = tp_of(cfg)
    hidden = copy_to_tp(layer_norm(hidden, params["ln_post_w"],
                                   params["ln_post_b"]), tp)
    hidden = F.gelu(hidden @ params["proj1_w"] + params["proj1_b"])
    hidden = reduce_from_tp(hidden @ params["proj2_w"], tp) + params["proj2_b"]
    return hidden, token_lens
