"""Greedy generation: prefill, then a host loop over decode steps.

Counterpart of ``qwen3_asr_tpu/runtime/generate.py``. The JAX package runs
the loop on the device in a ``while_loop``; here it is a Python loop whose
``done.all()`` check costs one device→host sync per step (CUDA graphs and
checking every K steps are later work). Semantics kept: the cache is
rounded up to a multiple of 128; emitting ``pad_id`` also ends a row;
tokens after a row is done are ``pad_id``; ``lengths`` counts tokens
``!= pad_id``; the loop stops when every row is done.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.config import DecoderConfig
from ..models.decoder import decoder_forward, embed_tokens, init_kv_cache, lm_logits
from ..ops.attention import AttnSpec


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32, pad_id beyond end-of-text
    lengths: torch.Tensor   # [B] int32 tokens generated incl. EOS
    steps: int              # emitted-token frontier (1 + decode steps run)


def cache_length(prompt_len: int, max_new: int) -> int:
    return -(-(prompt_len + max_new) // 128) * 128


@torch.inference_mode()
def greedy_generate(params: dict, cfg: DecoderConfig,
                    inputs_embeds: torch.Tensor, valid_from: torch.Tensor, *,
                    max_new: int, eos_id: int, pad_id: int,
                    cache_dtype: Optional[torch.dtype] = None
                    ) -> GenerateResult:
    """inputs_embeds: [B, prompt_len, H]; valid_from: [B] int32 — LEFT-padded
    prompts: keys below valid_from are masked. Positions are absolute
    (0..prompt_len-1 for the prompt), whatever valid_from is. The KV cache
    is in ``cache_dtype``: the working dtype (inputs_embeds') by default,
    or fp8."""
    b, prompt_len, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    cache_dtype = cache_dtype or inputs_embeds.dtype
    valid_from = valid_from.to(dev, torch.int32)
    cache = init_kv_cache(cfg, b, cache_length(prompt_len, max_new),
                          cache_dtype, dev)

    positions = torch.arange(prompt_len, device=dev).expand(b, prompt_len)
    spec = AttnSpec(causal=True, q_offset=0, valid_from=valid_from)
    hidden, cache = decoder_forward(params, cfg, inputs_embeds, positions,
                                    cache, 0, spec)
    first = lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(torch.int32)

    tokens = torch.full((b, max_new), pad_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = first
    done = (first == eos_id) | (first == pad_id)
    last = first
    i = 1
    while i < max_new and not bool(done.all()):
        # `last` is generated token i-1: its position is prompt_len + i - 1
        pos = prompt_len + i - 1
        hidden = embed_tokens(params, last[:, None].long())
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=dev)
        spec = AttnSpec(valid_from=valid_from,
                        valid_to=torch.full((b,), pos + 1, dtype=torch.int32,
                                            device=dev))
        hidden, cache = decoder_forward(params, cfg, hidden, positions, cache,
                                        pos, spec)
        nxt = lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        tokens[:, i] = nxt
        done = done | (nxt == eos_id) | (nxt == pad_id)
        last = nxt
        i += 1

    lengths = (tokens != pad_id).sum(-1).to(torch.int32)
    return GenerateResult(tokens, lengths, i)


def strip_generation(tokens, length: int, eos_id: int) -> list:
    """Trim one row of generated ids to the text span (drop EOS/pad)."""
    out = []
    for t in tokens[:length]:
        t = int(t)
        if t == eos_id:
            break
        out.append(t)
    return out
