"""Resume decoding: verify the previous partial's tokens in one pass.

Counterpart of ``qwen3_asr_tpu/runtime/resume.py``. A streaming session
re-transcribes its window every 450 ms, and consecutive partials share
most of their tokens, so the previous partial's ids act as a self-draft:

1. prefill the window's prompt;
2. run ONE forward over the previous tokens (the verify window: T =
   ``max_new`` queries at ``q_offset = prompt_len``, causal, over the whole
   cache): the model's argmax at each position says how many of them
   survive the new audio;
3. greedy-decode only from the first divergence.

The output is token-identical to full greedy decoding; only the number of
sequential steps changes.

``ResumeLoop`` is the port's device-resident form, built on
``runtime/generate.py``'s ``GreedyLoop``: its state lives in tensors
allocated once per key, ``prefill`` is the front (prompt, verify and the
accept arithmetic, all on the device with no host read, so a CUDA graph
captures it), and ``chunk`` runs ``DECODE_CHUNK`` predicated steps of the
per-row continuation. Each row keeps its own frontier ``text_len``: its
frontier token sits at position ``prompt_len + text_len - 1``, which is
where the step writes its K/V (a ``[B]`` write position, one launch a
layer on the card) and ``valid_to = pos + 1`` ends its keys. A row that
has finished, or filled its budget, freezes: it re-writes the same bytes
at its frozen position and its token is discarded, as JAX's does
(``resume.py:168-170``). At B = 1 this is JAX's ``verify_and_continue``
(its ``i`` is the row's ``text_len``), so one loop serves both.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..models.config import DecoderConfig
from ..models.decoder import KVCache, decoder_forward, embed_tokens, lm_logits
from ..ops.attention import AttnSpec
from .generate import DECODE_CHUNK, GreedyLoop, run_loop


class ResumeResult(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32, pad_id beyond end-of-text
    lengths: torch.Tensor   # [B] int32 tokens generated incl. EOS
    steps: torch.Tensor     # [B] continuation steps past the accepted draft
    accepted: torch.Tensor  # [B] draft tokens accepted by the verify pass
    steps_run: int          # decode steps computed: chunks x DECODE_CHUNK


class ResumeLoop(GreedyLoop):
    """The resume loop's device state for one (batch, prompt_len, max_new,
    cache dtype): the greedy loop's, plus the draft (``prev_tokens``
    [B, max_new], ``prev_len`` [B], input buffers the caller fills) and
    the per-row frontier ``text_len`` (and its value after the verify
    pass, ``text_len0``)."""

    def __init__(self, params: dict, cfg: DecoderConfig, batch: int,
                 prompt_len: int, max_new: int, *, eos_id: int, pad_id: int,
                 cache_dtype: torch.dtype, device, cache=None):
        super().__init__(params, cfg, batch, prompt_len, max_new,
                         eos_id=eos_id, pad_id=pad_id,
                         cache_dtype=cache_dtype, device=device, cache=cache)
        self.prev_tokens = torch.full((batch, max_new), pad_id,
                                      dtype=torch.int32, device=device)
        self.prev_len = torch.zeros(batch, dtype=torch.int32, device=device)
        self.text_len = torch.ones(batch, dtype=torch.int64, device=device)
        self.text_len0 = torch.ones(batch, dtype=torch.int64, device=device)

    def nbytes(self) -> int:
        return super().nbytes() + sum(
            x.nbytes for x in (self.prev_tokens, self.prev_len,
                               self.text_len, self.text_len0))

    def _live(self) -> torch.Tensor:
        return ~self.done & (self.text_len < self.max_new)

    def verify(self, first: torch.Tensor) -> None:
        """The draft through one forward at positions prompt_len ..
        prompt_len + max_new - 1 (writing their K/V), then the accept
        arithmetic of ``qwen3_asr_tpu/runtime/resume.py:143-160``: row r
        keeps the longest prefix of its draft that greedy decoding would
        emit (at most ``max_new - 1`` tokens, so a slot stays free), and
        its next token ``g_n`` is the model's own after that prefix."""
        b, plen, max_new = self.batch, self.prompt_len, self.max_new
        prev = self.prev_tokens
        dev = prev.device
        hidden = embed_tokens(self.params, prev.long(), self.cfg)
        positions = (torch.arange(max_new, device=dev) + plen).expand(
            b, max_new)
        spec = AttnSpec(causal=True, q_offset=plen,
                        valid_from=self.valid_from)
        hidden, _ = decoder_forward(self.params, self.cfg, hidden, positions,
                                    self.cache, plen, spec)
        preds = lm_logits(self.params, self.cfg,
                          hidden).argmax(-1).to(torch.int32)   # [B, max_new]
        slot = self._columns[None, :]
        eq = torch.where(slot == 0, prev[:, :1] == first[:, None],
                         prev == torch.roll(preds, 1, dims=1))
        eq &= slot < self.prev_len[:, None]
        eq &= prev != self.eos_id
        eq &= prev != self.pad_id
        accepted = torch.cumprod(eq.to(torch.int32), dim=1)
        n = accepted.sum(dim=1).clamp(max=max_new - 1)            # [B]
        g_n = torch.where(
            n == 0, first,
            preds.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0])
        tokens0 = torch.where((slot < n[:, None]) & (accepted > 0), prev,
                              torch.full_like(prev, self.pad_id))
        tokens0 = torch.where(slot == n[:, None], g_n[:, None], tokens0)
        self.tokens.copy_(tokens0)
        self.last.copy_(g_n)
        torch.logical_or(g_n == self.eos_id, g_n == self.pad_id,
                         out=self.done)
        self.text_len.copy_(n + 1)
        self.text_len0.copy_(n + 1)
        self.active.copy_(self._live().any())

    def prefill(self, inputs_embeds: torch.Tensor) -> None:
        """The front: the prompt, the verify window and the accept
        arithmetic; afterwards ``active`` says whether any row goes on."""
        self.verify(self.prompt(inputs_embeds))

    def _step(self) -> None:
        live = self._live()
        pos = self.text_len + (self.prompt_len - 1)                # [B]
        hidden = embed_tokens(self.params, self.last[:, None].long(),
                              self.cfg)
        spec = AttnSpec(valid_from=self.valid_from,
                        valid_to=(pos + 1).to(torch.int32))
        hidden, _ = decoder_forward(self.params, self.cfg, hidden,
                                    pos[:, None], self.cache, pos, spec)
        nxt = torch.where(live, self._emit(hidden),
                          torch.full_like(self.last, self.pad_id))
        idx = self.text_len.clamp(max=self.max_new - 1)
        column = (self._columns[None, :] == idx[:, None]) & live[:, None]
        self.tokens.copy_(torch.where(column, nxt[:, None], self.tokens))
        self.done.copy_(self.done | (nxt == self.eos_id)
                        | (nxt == self.pad_id))
        self.last.copy_(torch.where(live, nxt, self.last))
        self.text_len.add_(live.long())

    def chunk(self) -> None:
        """DECODE_CHUNK predicated continuation steps, then ``active``."""
        for _ in range(DECODE_CHUNK):
            self._step()
        self.active.copy_(self._live().any())

    def result(self, chunks: int) -> ResumeResult:
        lengths = (self.tokens != self.pad_id).sum(-1).to(torch.int32)
        return ResumeResult(self.tokens.clone(), lengths,
                            self.text_len - self.text_len0,
                            self.text_len0 - 1, chunks * DECODE_CHUNK)


def _fill_draft(loop: ResumeLoop, prev_tokens: torch.Tensor,
                prev_len: torch.Tensor) -> None:
    loop.prev_tokens.copy_(prev_tokens)
    loop.prev_len.copy_(prev_len)


def _run(loop: ResumeLoop, front) -> ResumeResult:
    from .graphs import Graph
    dev = loop.prev_tokens.device
    return loop.result(run_loop(Graph(front, dev), Graph(loop.chunk, dev),
                                loop.active))


@torch.inference_mode()
def resume_generate_batch(params: dict, cfg: DecoderConfig,
                          inputs_embeds: torch.Tensor,
                          valid_from: torch.Tensor,
                          prev_tokens: torch.Tensor, prev_len: torch.Tensor,
                          *, max_new: int, eos_id: int, pad_id: int,
                          cache_dtype: Optional[torch.dtype] = None
                          ) -> ResumeResult:
    """B independent streams' ticks in one run: each row its own prompt
    (inputs_embeds [B, P, H], left-padded from ``valid_from`` [B]) and its
    own draft (``prev_tokens`` [B, max_new] int32, pad-filled;
    ``prev_len`` [B] usable tokens). Per row the tokens equal greedy
    decoding of that row alone. On a CUDA device the front and the chunk
    run as CUDA graphs captured for this call."""
    b, plen, _ = inputs_embeds.shape
    loop = ResumeLoop(params, cfg, b, plen, max_new, eos_id=eos_id,
                      pad_id=pad_id,
                      cache_dtype=cache_dtype or inputs_embeds.dtype,
                      device=inputs_embeds.device)
    loop.valid_from.copy_(valid_from)
    _fill_draft(loop, prev_tokens, prev_len)
    return _run(loop, lambda: loop.prefill(inputs_embeds))


def resume_generate(params: dict, cfg: DecoderConfig,
                    inputs_embeds: torch.Tensor, valid_from: torch.Tensor,
                    prev_tokens: torch.Tensor, prev_len: torch.Tensor, *,
                    max_new: int, eos_id: int, pad_id: int,
                    cache_dtype: Optional[torch.dtype] = None
                    ) -> ResumeResult:
    """One stream's tick (batch 1): exactly what greedy decoding returns,
    in fewer sequential steps."""
    if inputs_embeds.shape[0] != 1:
        raise ValueError("resume_generate is per stream (batch 1); use "
                         "resume_generate_batch")
    return resume_generate_batch(params, cfg, inputs_embeds, valid_from,
                                 prev_tokens, prev_len, max_new=max_new,
                                 eos_id=eos_id, pad_id=pad_id,
                                 cache_dtype=cache_dtype)


@torch.inference_mode()
def verify_and_continue_batch(params: dict, cfg: DecoderConfig,
                              cache: KVCache, plen: int, first: torch.Tensor,
                              valid_from: torch.Tensor,
                              prev_tokens: torch.Tensor,
                              prev_len: torch.Tensor, *, max_new: int,
                              eos_id: int, pad_id: int
                              ) -> Tuple[KVCache, ResumeResult]:
    """The verify pass and the per-row continuation on an EXISTING
    prefilled cache (the prompt's K/V at positions < ``plen``; ``first``
    [B] is each row's greedy token after its prompt). The cache is
    updated in place and returned."""
    b = prev_tokens.shape[0]
    loop = ResumeLoop(params, cfg, b, plen, max_new, eos_id=eos_id,
                      pad_id=pad_id, cache_dtype=cache.k.dtype,
                      device=prev_tokens.device, cache=cache)
    loop.valid_from.copy_(valid_from)
    _fill_draft(loop, prev_tokens, prev_len)
    first = first.to(torch.int32)
    return cache, _run(loop, lambda: loop.verify(first))


def verify_and_continue(params: dict, cfg: DecoderConfig, cache: KVCache,
                        plen: int, first: torch.Tensor,
                        valid_from: torch.Tensor, prev_tokens: torch.Tensor,
                        prev_len: torch.Tensor, *, max_new: int, eos_id: int,
                        pad_id: int) -> Tuple[KVCache, ResumeResult]:
    """``verify_and_continue_batch`` for one stream (batch 1)."""
    if prev_tokens.shape[0] != 1:
        raise ValueError("verify_and_continue is per stream (batch 1); use "
                         "verify_and_continue_batch")
    return verify_and_continue_batch(params, cfg, cache, plen, first,
                                     valid_from, prev_tokens, prev_len,
                                     max_new=max_new, eos_id=eos_id,
                                     pad_id=pad_id)
