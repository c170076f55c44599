"""Greedy generation: prefill, then the decode loop as persistent state and a
fixed chunk of predicated steps.

Counterpart of ``qwen3_asr_tpu/runtime/generate.py``, whose loop is one
``lax.while_loop`` on the device. Here the loop's carry lives in device
tensors allocated once per shape (``GreedyLoop``): the KV cache, ``tokens``,
``last``, ``done``, the frontier ``i`` and the flag ``active``. ``prefill``
fills them from a prompt; ``chunk`` runs ``DECODE_CHUNK`` decode steps,
each predicated on ``active = (i < max_new) & ~all(done)`` computed on the
device, so neither holds a host integer and a CUDA graph can replay them
(``runtime/graphs.py``). The host reads ``active`` once per chunk.

What the predicate guarantees: ``i`` advances, and the token column ``i``
(clamped into range) is written, only while active. So the write position
``prompt_len + i - 1`` never passes ``prompt_len + max_new - 1``, inside
``cache_length``; a step past the end, or past the step where every row
finished, rewrites only a position nothing reads again. Semantics kept
from the JAX loop: the cache is rounded up to a multiple of 128; emitting
``pad_id`` also ends a row; tokens after a row is done are ``pad_id``;
``lengths`` counts tokens ``!= pad_id``; ``steps`` is the emitted-token
frontier (JAX's ``final.i``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.config import DecoderConfig
from ..models.decoder import decoder_forward, embed_tokens, init_kv_cache, lm_logits
from ..ops.attention import AttnSpec

# Decode steps per chunk, the host's one sync per chunk. Past the last live
# step a chunk runs at most DECODE_CHUNK - 1 steps whose effects are masked
# (at most 7 of the 30 s bucket's 256-token budget), while 8 steps of the
# 1.7B decoder keep the card busy for tens of milliseconds between two host
# reads of ``active``, against tens of microseconds that a read costs.
DECODE_CHUNK = 8


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32, pad_id beyond end-of-text
    lengths: torch.Tensor   # [B] int32 tokens generated incl. EOS
    steps: int              # emitted-token frontier (1 + live decode steps)
    steps_run: int          # decode steps computed: chunks x DECODE_CHUNK


def cache_length(prompt_len: int, max_new: int) -> int:
    return -(-(prompt_len + max_new) // 128) * 128


class GreedyLoop:
    """The greedy loop's device state for one (batch, prompt_len, max_new,
    cache dtype), allocated once and rewritten by every run: ``prefill``
    resets all of it that a run reads (the cache at ``[0, prompt_len)``,
    and each decode step writes its position before attending over it)."""

    def __init__(self, params: dict, cfg: DecoderConfig, batch: int,
                 prompt_len: int, max_new: int, *, eos_id: int, pad_id: int,
                 cache_dtype: torch.dtype, device, cache=None):
        self.params, self.cfg, self.batch = params, cfg, batch
        self.prompt_len, self.max_new = prompt_len, max_new
        self.eos_id, self.pad_id = eos_id, pad_id
        self.cache = cache if cache is not None else init_kv_cache(
            cfg, batch, cache_length(prompt_len, max_new), cache_dtype,
            device)
        self.valid_from = torch.zeros(batch, dtype=torch.int32, device=device)
        self.tokens = torch.full((batch, max_new), pad_id, dtype=torch.int32,
                                 device=device)
        self.last = torch.zeros(batch, dtype=torch.int32, device=device)
        self.done = torch.zeros(batch, dtype=torch.bool, device=device)
        self.i = torch.ones((), dtype=torch.int64, device=device)
        self.active = torch.zeros((), dtype=torch.bool, device=device)
        self._columns = torch.arange(max_new, device=device)

    def nbytes(self) -> int:
        """Bytes of the loop's state and KV cache."""
        held = [self.valid_from, self.tokens, self.last, self.done, self.i,
                self.active, self._columns]
        held += [x for x in self.cache if x is not None]
        return sum(x.nbytes for x in held)

    def _is_active(self) -> torch.Tensor:
        return (self.i < self.max_new) & ~self.done.all()

    def _emit(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(self.params, self.cfg,
                         hidden[:, -1]).argmax(-1).to(torch.int32)

    def prompt(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        """The prompt [B, prompt_len, H] (left-padded: keys below
        ``valid_from`` are masked; positions are absolute) → the cache's
        prompt span; returns the first token [B] int32."""
        b, t = self.batch, self.prompt_len
        positions = torch.arange(t, device=inputs_embeds.device).expand(b, t)
        spec = AttnSpec(causal=True, q_offset=0, valid_from=self.valid_from)
        hidden, _ = decoder_forward(self.params, self.cfg, inputs_embeds,
                                    positions, self.cache, 0, spec)
        return self._emit(hidden)

    def prefill(self, inputs_embeds: torch.Tensor) -> None:
        """``prompt``, then the first token, ``done``, ``i = 1`` and
        ``active``."""
        first = self.prompt(inputs_embeds)
        self.tokens.fill_(self.pad_id)
        self.tokens[:, 0] = first
        self.last.copy_(first)
        torch.logical_or(first == self.eos_id, first == self.pad_id,
                         out=self.done)
        self.i.fill_(1)
        self.active.copy_(self._is_active())

    def _step(self) -> None:
        active = self._is_active()
        # `last` is generated token i-1: its position is prompt_len + i - 1
        pos = self.i + (self.prompt_len - 1)
        hidden = embed_tokens(self.params, self.last[:, None].long(),
                              self.cfg)
        spec = AttnSpec(valid_from=self.valid_from,
                        valid_to=(pos + 1).to(torch.int32).expand(
                            self.batch).contiguous())
        hidden, _ = decoder_forward(self.params, self.cfg, hidden,
                                    pos.expand(self.batch, 1), self.cache,
                                    pos, spec)
        nxt = self._emit(hidden).masked_fill(self.done, self.pad_id)
        column = (self._columns == self.i.clamp(max=self.max_new - 1)) & active
        self.tokens.copy_(torch.where(column, nxt[:, None], self.tokens))
        ended = self.done | (nxt == self.eos_id) | (nxt == self.pad_id)
        self.done.copy_(torch.where(active, ended, self.done))
        self.last.copy_(torch.where(active, nxt, self.last))
        self.i.add_(active.long())

    def chunk(self) -> None:
        """DECODE_CHUNK predicated decode steps, then ``active``."""
        for _ in range(DECODE_CHUNK):
            self._step()
        self.active.copy_(self._is_active())

    def result(self, chunks: int) -> GenerateResult:
        lengths = (self.tokens != self.pad_id).sum(-1).to(torch.int32)
        return GenerateResult(self.tokens.clone(), lengths, int(self.i),
                              chunks * DECODE_CHUNK)


def run_loop(front, chunk, active: torch.Tensor) -> int:
    """``front()``, then ``chunk()`` while ``active`` (read on the host once
    per chunk). ``front`` and ``chunk`` are the loop's functions, or their
    CUDA graphs. Returns the chunks run."""
    front()
    chunks = 0
    while bool(active):
        chunk()
        chunks += 1
    return chunks


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
    fp8, or ``torch.int4`` (packed values with scale planes). On a CUDA
    device the prefill and the chunk run as CUDA graphs
    captured for this call (``runtime/graphs.py``; the engine keeps its
    graphs per bucket instead); on the CPU they run eagerly."""
    from .graphs import Graph
    b, prompt_len, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    loop = GreedyLoop(params, cfg, b, prompt_len, max_new, eos_id=eos_id,
                      pad_id=pad_id,
                      cache_dtype=cache_dtype or inputs_embeds.dtype,
                      device=dev)
    loop.valid_from.copy_(valid_from)
    front = Graph(lambda: loop.prefill(inputs_embeds), dev)
    chunk = Graph(loop.chunk, dev)
    return loop.result(run_loop(front, chunk, loop.active))


def strip_generation(tokens, length: int, eos_id: int) -> list:
    """Trim one row of generated ids to the text span (drop EOS/pad)."""
    out = []
    for t in tokens[:length]:
        t = int(t)
        if t == eos_id:
            break
        out.append(t)
    return out
