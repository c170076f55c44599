"""Token-level speculative decoding: a draft model proposes, the verifier
accepts the matching prefix.

Counterpart of ``qwen3_asr_tpu/runtime/speculative.py``, whose loop is one
``lax.while_loop`` on the device. Each round the draft decodes γ tokens at
T = 1, the verifier scores ``[last, d_0 .. d_{γ-2}]`` in ONE forward at
T = γ, and each row keeps the longest prefix of its drafts that the
verifier's argmax agrees with, plus the verifier's own token where they
part. Greedy acceptance makes the output the verifier's greedy decoding,
token for token; only the number of verifier forwards changes.

``SpecLoop`` is the port's device-resident form, in the way of
``runtime/generate.py``'s ``GreedyLoop``: both KV caches, ``last``,
``text_len`` [B], ``tokens`` [B, max_new + γ], ``done``, ``rounds`` and
``active`` are tensors allocated once per key. ``prefill`` is the front
(both prefills and the verifier's first token); ``chunk`` runs
``rounds_per_chunk(γ)`` rounds, each predicated on ``active = ~all(done |
text_len >= max_new)`` computed on the device at the round's start, so
neither holds a host integer and a CUDA graph replays them
(``runtime/graphs.py``). The host reads ``active`` once per chunk.

Rows accept different prefix lengths, so their frontiers diverge: a row's
draft steps write at ``plen_d + text_len - 1 + i`` and its verify window
at ``plen_v + text_len - 1`` (the ``[B]`` write position of
``models/decoder.py``, one launch a layer of kernel B), with the window's
causal ``q_offset`` the same ``[B]`` tensor (kernel #1). The semantics are
JAX's, to the token and the round count:

- the no-bonus invariant: at a round's start both caches hold K/V through
  text position ``text_len - 2``, and ``last`` (at ``text_len - 1``) is
  not yet processed; rejected drafts' K/V stay, masked by causality and
  overwritten later;
- ``n_accept = γ`` when all γ drafts match, else ``n_s + 1`` (the matching
  prefix and the verifier's correction);
- end-of-text inside the window truncates it, ``pad_id`` counting as a
  second end-of-text;
- a finished row freezes: it accepts nothing more (its writes land at its
  frozen positions, outside what it attends).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.config import DecoderConfig
from ..models.decoder import decoder_forward, embed_tokens, init_kv_cache, lm_logits
from ..ops.attention import AttnSpec
from .generate import DECODE_CHUNK, run_loop


class SpecResult(NamedTuple):
    tokens: torch.Tensor    # [B, max_new] int32, pad_id beyond end-of-text
    lengths: torch.Tensor   # [B] int32 tokens generated incl. EOS
    steps: int              # verifier rounds (JAX's ``final.rounds``)
    steps_run: int          # rounds computed: chunks x rounds_per_chunk


def spec_cache_length(prompt_len: int, max_new: int, gamma: int) -> int:
    """A spec cache's keys: the prompt, the budget and a verify window's
    slack, rounded up to 128 (``speculative.py:69-70``)."""
    return -(-(prompt_len + max_new + gamma + 2) // 128) * 128


def rounds_per_chunk(gamma: int) -> int:
    """Rounds a chunk runs between two host reads: at full acceptance a row
    gains γ tokens a round, so ``DECODE_CHUNK // γ`` rounds emit at most
    the greedy chunk's ``DECODE_CHUNK`` tokens (2 rounds at γ = 4)."""
    return max(1, DECODE_CHUNK // gamma)


class SpecLoop:
    """The speculative loop's device state for one (batch, the two prompt
    lengths, max_new, γ, cache dtype), allocated once and rewritten by
    every run: ``prefill`` resets all of it that a run reads. The draft's
    cache is in the verifier's cache dtype, as JAX's is."""

    def __init__(self, draft_params: dict, verify_params: dict,
                 draft_cfg: DecoderConfig, verify_cfg: DecoderConfig,
                 batch: int, plen_d: int, plen_v: int, max_new: int, *,
                 gamma: int, eos_id: int, pad_id: int,
                 cache_dtype: torch.dtype, device):
        if gamma < 2:
            raise ValueError(f"gamma must be >= 2, got {gamma}")
        self.draft_params, self.verify_params = draft_params, verify_params
        self.draft_cfg, self.verify_cfg = draft_cfg, verify_cfg
        self.batch, self.plen_d, self.plen_v = batch, plen_d, plen_v
        self.prompt_len = plen_v
        self.max_new, self.gamma = max_new, gamma
        self.eos_id, self.pad_id = eos_id, pad_id
        self.rounds_per_chunk = rounds_per_chunk(gamma)
        self.cache_d = init_kv_cache(
            draft_cfg, batch, spec_cache_length(plen_d, max_new, gamma),
            cache_dtype, device)
        self.cache_v = init_kv_cache(
            verify_cfg, batch, spec_cache_length(plen_v, max_new, gamma),
            cache_dtype, device)

        def vec(dtype, fill=0):
            return torch.full((batch,), fill, dtype=dtype, device=device)

        self.valid_from_d = vec(torch.int32)
        self.valid_from_v = vec(torch.int32)
        # slack of γ, so a window written at text_len = max_new stays in
        self.tokens = torch.full((batch, max_new + gamma), pad_id,
                                 dtype=torch.int32, device=device)
        self.last = vec(torch.int32)
        self.text_len = vec(torch.int64, 1)
        self.done = vec(torch.bool)
        self.rounds = torch.zeros((), dtype=torch.int64, device=device)
        self.active = torch.zeros((), dtype=torch.bool, device=device)
        self._slot = torch.arange(gamma, device=device)

    def nbytes(self) -> int:
        """Bytes of the loop's state and both KV caches."""
        held = [self.valid_from_d, self.valid_from_v, self.tokens, self.last,
                self.text_len, self.done, self.rounds, self.active,
                self._slot]
        held += [x for c in (self.cache_d, self.cache_v) for x in c
                 if x is not None]
        return sum(x.nbytes for x in held)

    def _is_active(self) -> torch.Tensor:
        return ~(self.done | (self.text_len >= self.max_new)).all()

    def _prompt(self, params, cfg, embeds, valid_from, cache) -> torch.Tensor:
        b, t = self.batch, embeds.shape[1]
        positions = torch.arange(t, device=embeds.device).expand(b, t)
        spec = AttnSpec(causal=True, q_offset=0, valid_from=valid_from)
        hidden, _ = decoder_forward(params, cfg, embeds, positions, cache, 0,
                                    spec)
        return lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(
            torch.int32)

    def prefill(self, embeds_d: torch.Tensor, embeds_v: torch.Tensor
                ) -> None:
        """Both prompts ([B, plen_*, H_*], left-padded from each
        ``valid_from``) into their caches, the verifier's first token, and
        the state a first round reads."""
        self._prompt(self.draft_params, self.draft_cfg, embeds_d,
                     self.valid_from_d, self.cache_d)
        first = self._prompt(self.verify_params, self.verify_cfg, embeds_v,
                             self.valid_from_v, self.cache_v)
        self.tokens.fill_(self.pad_id)
        self.tokens[:, 0] = first
        self.last.copy_(first)
        torch.logical_or(first == self.eos_id, first == self.pad_id,
                         out=self.done)
        self.text_len.fill_(1)
        self.rounds.zero_()
        self.active.copy_(self._is_active())

    def _draft(self) -> torch.Tensor:
        """γ draft steps at T = 1, row r at ``plen_d + text_len[r] - 1 +
        i``; returns the drafts [B, γ]."""
        params, cfg = self.draft_params, self.draft_cfg
        frontier = self.text_len + (self.plen_d - 1)
        x, drafts = self.last, []
        for i in range(self.gamma):
            pos = frontier + i
            hidden = embed_tokens(params, x[:, None].long(), cfg)
            spec = AttnSpec(valid_from=self.valid_from_d,
                            valid_to=(pos + 1).to(torch.int32))
            hidden, _ = decoder_forward(params, cfg, hidden, pos[:, None],
                                        self.cache_d, pos, spec)
            x = lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(
                torch.int32)
            drafts.append(x)
        return torch.stack(drafts, dim=1)

    def _verify(self, drafts: torch.Tensor) -> torch.Tensor:
        """One verifier forward of ``[last, d_0 .. d_{γ-2}]`` at T = γ,
        causal from the per-row ``q_offset = plen_v + text_len - 1``, which
        is also where the window's K/V are written; returns the
        verifier's argmax at each slot [B, γ]."""
        params, cfg = self.verify_params, self.verify_cfg
        frontier = self.text_len + (self.plen_v - 1)                # [B]
        ids = torch.cat([self.last[:, None], drafts[:, :-1]], dim=1)
        hidden = embed_tokens(params, ids.long(), cfg)
        positions = frontier[:, None] + self._slot[None, :]
        spec = AttnSpec(causal=True, q_offset=frontier.to(torch.int32),
                        valid_from=self.valid_from_v)
        hidden, _ = decoder_forward(params, cfg, hidden, positions,
                                    self.cache_v, frontier, spec)
        return lm_logits(params, cfg, hidden).argmax(-1).to(torch.int32)

    def _round(self) -> None:
        """One predicated round: drafts, the verify forward and the accept
        arithmetic of ``qwen3_asr_tpu/runtime/speculative.py:139-173``;
        the state moves only while ``active``."""
        gamma, pad_id, eos_id = self.gamma, self.pad_id, self.eos_id
        act = self._is_active()
        drafts = self._draft()
        preds = self._verify(drafts)
        slot = self._slot[None, :]
        # n_s: the matching prefix's length (0..γ)
        n_s = torch.cumprod((preds == drafts).to(torch.int64), dim=1).sum(1)
        correction = preds.gather(1, n_s.clamp(max=gamma - 1)[:, None])
        accepted = torch.where(
            slot < n_s[:, None], drafts,
            torch.where(slot == n_s[:, None], correction,
                        torch.full_like(drafts, pad_id)))
        n_accept = torch.where(n_s == gamma, n_s, n_s + 1)
        hit = (((accepted == eos_id) | (accepted == pad_id))
               & (slot < n_accept[:, None]))
        any_eos = hit.any(dim=1)
        first_eos = (torch.cumsum(hit.to(torch.int64), dim=1) == 0).sum(1)
        n_eff = torch.where(any_eos, first_eos + 1, n_accept)
        n_eff = torch.where(self.done, torch.zeros_like(n_eff), n_eff)
        offs = self.text_len[:, None] + slot
        old = self.tokens.gather(1, offs)
        window = torch.where(slot < n_eff[:, None], accepted, old)
        tokens = self.tokens.scatter(1, offs, window)
        last_new = accepted.gather(1, (n_eff - 1).clamp(min=0)[:, None])[:, 0]
        last = torch.where(n_eff > 0, last_new, self.last)
        text_len = (self.text_len + n_eff).clamp(max=self.max_new)
        self.tokens.copy_(torch.where(act, tokens, self.tokens))
        self.last.copy_(torch.where(act, last, self.last))
        self.text_len.copy_(torch.where(act, text_len, self.text_len))
        self.done.copy_(self.done | (act & any_eos))
        self.rounds.add_(act.long())

    def chunk(self) -> None:
        """``rounds_per_chunk`` predicated rounds, then ``active``."""
        for _ in range(self.rounds_per_chunk):
            self._round()
        self.active.copy_(self._is_active())

    def result(self, chunks: int) -> SpecResult:
        tokens = self.tokens[:, :self.max_new].clone()
        lengths = (tokens != self.pad_id).sum(-1).to(torch.int32)
        return SpecResult(tokens, lengths, int(self.rounds),
                          chunks * self.rounds_per_chunk)


@torch.inference_mode()
def speculative_generate(draft_params: dict, verify_params: dict,
                         draft_cfg: DecoderConfig, verify_cfg: DecoderConfig,
                         embeds_d: torch.Tensor, embeds_v: torch.Tensor,
                         valid_from_d: torch.Tensor,
                         valid_from_v: torch.Tensor, *, gamma: int,
                         max_new: int, eos_id: int, pad_id: int,
                         cache_dtype=None) -> SpecResult:
    """embeds_d/v: [B, prompt_len_*, H_*], each model's own prompt (its own
    encoder output spliced in); valid_from_d/v: [B] int32. Returns the
    verifier's greedy sequence, and in ``steps`` its forward count. The
    caches are in ``cache_dtype`` (the verifier prompt's dtype by
    default). On a CUDA device the front and the chunk run as CUDA graphs
    captured for this call; on the CPU they run eagerly."""
    from .graphs import Graph
    b, plen_d, _ = embeds_d.shape
    dev = embeds_v.device
    loop = SpecLoop(draft_params, verify_params, draft_cfg, verify_cfg, b,
                    plen_d, embeds_v.shape[1], max_new, gamma=gamma,
                    eos_id=eos_id, pad_id=pad_id,
                    cache_dtype=cache_dtype or embeds_v.dtype, device=dev)
    loop.valid_from_d.copy_(valid_from_d)
    loop.valid_from_v.copy_(valid_from_v)
    front = Graph(lambda: loop.prefill(embeds_d, embeds_v), dev)
    chunk = Graph(loop.chunk, dev)
    return loop.result(run_loop(front, chunk, loop.active))
