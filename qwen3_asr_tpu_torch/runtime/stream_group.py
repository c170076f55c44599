"""Grouped prefix-cache streaming (``ASR_WS_STREAM_MODE=grouped``): the
ticks of concurrent sessions as one dispatch over a pooled decoder cache.

Counterpart of ``qwen3_asr_tpu/runtime/stream_group.py`` (``GroupMember``,
``StreamGroup``), with its names and semantics. It joins the two WS modes
that are exclusive otherwise: prefix caching (``runtime/stream.py``: a
session's tick recomputes only what its new audio changed, but each
session dispatches alone) and tick batching (``runtime/batcher.py``
``TickBatcher``: sessions share a dispatch, but every row re-encodes and
re-prefills its whole window). Up to ``slots`` sessions
(``ASR_WS_GROUP_SLOTS``, 8) share one decoder cache of ``slots`` rows,
and a cadence's ticks run as one segment prefill over every row and one
batched verify and continuation; each member keeps its own cached encoder
blocks.

Correctness rests on the invariant of ``runtime/stream.py``, made
batch-wide: re-prefilling a cache range that is already valid writes the
same keys. So a dispatch runs ALL rows from ONE segment start, the
largest rung at or below the smallest first stale position of the
ticking members; rows that needed less, members that are not ticking and
empty slots recompute what they hold, and their outputs are dropped. An
empty slot, or a member that has not ticked since it attached or reset,
is a dead row: a pad prefix (``valid_from`` = the prefix budget) and zero
audio tokens for an empty slot, and its first token is EOS, so it cannot
hold the shared loop open.

How the card runs it. The pooled cache is the engine's workspace of
``("gstate", P, max_new, slots, dtype)`` (``stream.StreamWorkspace`` with
``slots`` rows), with a front graph a rung ``("gtick", seg_start, P,
max_new, slots, dtype)`` and the continuation's chunk graph; the block
encoders ``("encode", frames)`` are the sessions', and a member's changed
blocks are encoded one member at a time into its row. The group owns the
workspace while it ticks; when a bucket has more members than ``slots``,
two groups of one key share it and take turns by copying their state
(cache and audio tokens) out and in, as two sessions do
(``StreamWorkspace.acquire``). A lone group never copies. JAX frees a
group's pooled cache when its last member leaves
(``qwen3_asr_tpu/runtime/engine.py:575-582``); here the workspace is an
engine key and stays for the process, like every key, and the emptied
group drops its host state and its stashed copy (ROADMAP §3). A dispatch
reads the host once: every row's tokens and length and the blocks' raw
maxes, in one transfer.

After a failed dispatch every member is reset and the group rebuilds on
its next tick (JAX's ``stream_group.py:343-352``); the error is
re-raised. The group cache of an int4 engine is fp8, as JAX's is
(``stream_group.py:126-130``).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .generate import strip_generation
from .stream import (BucketPlan, change_token, clamp_guess, diff_blocks,
                     session_cache_dtype, true_max)


class GroupMember:
    """One WS connection's host-side state inside a ``StreamGroup``, with
    the surface the serving layer uses on a ``StreamSession`` (``update``,
    ``reset``, ``release``, ``has_state``, ``held_bytes``, ``stats``)."""

    def __init__(self, group: "StreamGroup", row: int,
                 language: Optional[str], context: str):
        self.group = group
        self.row = row
        self.engine = group.engine
        self.model = group.engine.model
        self.prefix, self.valid_from = group.engine.padded_prefix(
            language, context)                       # [1, 64], [1]
        self.stats = {"ticks": 0, "tail": 0, "full": 0, "redo": 0}
        self._reset_host()

    def _reset_host(self) -> None:
        n = len(self.group.plan.spans)
        self.encoded = [False] * n
        self.block_max = np.full(n, -np.inf)
        self.clamp_max: Optional[float] = None
        self.prev_window = np.zeros(0, np.float32)
        self.prev_tokens: List[int] = []
        self._prefix_filled = False

    def has_state(self) -> bool:
        """Whether a later tick counts on this member's row."""
        return self._prefix_filled or any(self.encoded)

    def held_bytes(self) -> int:
        """0: a member's state lives in its group's rows, which the group
        counts once."""
        return 0

    def update(self, window: np.ndarray):
        """A group tick with this member as the only participant."""
        return self.group.tick([(self, window)])[0]

    def reset(self) -> None:
        """Flush or reset: the member's next tick rebuilds its row."""
        self._reset_host()
        if self.group is not None:
            self.group._dirty.add(self.row)

    def release(self) -> None:
        """Leave the group (its slot is free for the next member) and drop
        the engine's references; the serving layer binds anew."""
        if self.group is not None:
            self.group.detach(self)
        self.group = None
        self.engine = None
        self.model = None


class _Req:
    __slots__ = ("member", "window", "guess", "changed", "change_tok")

    def __init__(self, member, window, guess, changed, change_tok):
        self.member = member
        self.window = window
        self.guess = guess
        self.changed = changed
        self.change_tok = change_tok


class StreamGroup:
    """Streaming sessions of one bucket on a pooled cache of ``slots``
    rows. Not thread-safe: the serving layer runs its ticks on the queue's
    device thread.

    ``eager = True`` runs the same functions without the graphs (on the
    card only to hold the graphs against them)."""

    def __init__(self, engine, cap_s: float, slots: int):
        if slots < 1 or slots & (slots - 1):
            raise ValueError(f"ASR_WS_GROUP_SLOTS must be a power of two, "
                             f"got {slots}")
        self.engine = engine
        self.plan = plan = BucketPlan(engine, cap_s)
        self.slots = slots
        self.members: List[Optional[GroupMember]] = [None] * slots
        self.cache_dtype = session_cache_dtype(engine)
        self.work = engine._stream_fn(
            ("gstate", plan.prompt_len, plan.max_new, slots,
             self.cache_dtype), plan)
        self.stored: Optional[List[torch.Tensor]] = None
        self.eager = False
        # rows whose audio tokens are to be zeroed before the next
        # dispatch (empty or reused slots: zero blocks, as JAX's)
        self._dirty = set(range(slots))
        self._pad_prefix = np.full((1, plan.prefix_budget),
                                   engine.model.pad_id, np.int32)
        self.dispatches = 0
        self.last_run: dict = {}

    # -- membership ------------------------------------------------------------
    def try_attach(self, language: Optional[str],
                   context: str = "") -> Optional[GroupMember]:
        for row, occupant in enumerate(self.members):
            if occupant is None:
                member = GroupMember(self, row, language, context)
                self.members[row] = member
                self._dirty.add(row)
                return member
        return None

    def attach_or_raise(self, language: Optional[str],
                        context: str = "") -> GroupMember:
        member = self.try_attach(language, context)
        if member is None:
            raise RuntimeError("stream group has no free slot")
        return member

    def detach(self, member: GroupMember) -> None:
        if self.members[member.row] is member:
            self.members[member.row] = None
            self._dirty.add(member.row)
        self.engine._drop_stream_group_if_empty(self)

    @property
    def live_members(self) -> int:
        return sum(m is not None for m in self.members)

    # -- the state it keeps --------------------------------------------------------
    def has_state(self) -> bool:
        """Whether a later tick counts on the group's rows."""
        return any(m is not None and m.has_state() for m in self.members)

    def held_bytes(self) -> int:
        """Device bytes the group holds of its own: its stashed state
        (0 while it has been the only group of its workspace)."""
        return sum(x.nbytes for x in self.stored or [])

    def drop_state(self) -> None:
        """The group is empty: drop its stashed copy and its claim on the
        workspace (the workspace itself is an engine key and stays)."""
        self.stored = None
        self.work.drop(self)

    def _reset_all(self) -> None:
        for member in self.members:
            if member is not None:
                member._reset_host()
        self._dirty = set(range(self.slots))
        self.stored = None

    # -- one batched tick --------------------------------------------------------
    @torch.inference_mode()
    def tick(self, requests: List[Tuple[GroupMember, np.ndarray]]):
        """The members' ticks as ONE dispatch (two when a clamp guess is
        refuted). Each output is token-identical to a solo
        ``StreamSession``'s (and so to the fused resume path's). Returns
        [(text, ids)] in request order."""
        plan = self.plan
        self.engine.last_used = time.time()   # the idle watchdog's clock
        seen = set()
        reqs: List[_Req] = []
        for member, window in requests:
            if member.group is not self:
                raise ValueError("a member ticks in its own group only")
            if id(member) in seen:
                raise ValueError("a member ticks once a dispatch (the "
                                 "batcher splits repeats into rounds)")
            seen.add(id(member))
            window = np.asarray(window, np.float32)
            if len(window) > plan.pinned_samples:
                window = window[-plan.pinned_samples:]
            member.stats["ticks"] += 1
            changed = diff_blocks(plan, window, member.prev_window,
                                  member.encoded)
            guess = clamp_guess(member.block_max)
            if member.clamp_max is None or guess != member.clamp_max:
                changed = list(range(len(plan.spans)))   # clamp change
            reqs.append(_Req(member, window, guess, changed,
                             change_token(plan, changed,
                                          member._prefix_filled)))

        work = self.work
        work.acquire(self)
        try:
            for row in sorted(self._dirty):
                work.audio[row].zero_()
            self._dirty.clear()
            self._encode(reqs)
            seg_start = max(s for s in plan.seg_starts
                            if s <= min(r.change_tok for r in reqs))
            for r in reqs:
                r.member.stats["full" if seg_start == 0 else "tail"] += 1
            tokens, lengths = self._dispatch(seg_start, reqs)
            # The clamp proof: every ticking member's window max is now
            # known. Members whose guess was refuted encode every block
            # again with the proven max, and ONE redo dispatch recomputes
            # every row from the prefix rung (the first dispatch filled
            # every row's prefix keys).
            redo = [r for r in reqs
                    if true_max(r.member.block_max) != r.guess]
            if redo:
                for r in redo:
                    r.member.stats["redo"] += 1
                    r.guess = true_max(r.member.block_max)
                    r.changed = list(range(len(plan.spans)))
                self._encode(redo)
                tokens, lengths = self._dispatch(plan.prefix_budget, reqs)
        except Exception:
            # the rows are no longer to be trusted: every member's next
            # tick rebuilds from scratch
            self._reset_all()
            work.drop(self)
            raise

        results = []
        eos = self.engine.model.eos_id
        for r in reqs:
            member = r.member
            member._prefix_filled = True
            member.clamp_max = true_max(member.block_max)
            member.prev_window = r.window.copy()
            ids = strip_generation(tokens[member.row],
                                   int(lengths[member.row]), eos)
            member.prev_tokens = ids
            text = self.engine.model.tokenizer.decode(ids).strip()
            results.append((text, ids))
        return results

    # -- internals -------------------------------------------------------------
    def _encode(self, reqs: List[_Req]) -> None:
        """Each request's changed blocks into its row, one member at a
        time, through the shared block encoders."""
        for r in reqs:
            self.work.encode(r.member.row, r.window, r.changed, r.guess,
                             self.eager)
            for b in r.changed:
                r.member.encoded[b] = True

    def _dispatch(self, seg_start: int, reqs: List[_Req]):
        """One tick over ALL rows from one segment start; then the one
        host read. Ticking rows get fresh results; every other row
        recomputes what it holds (or garbage, for a dead row) that
        nothing reads."""
        plan, slots = self.plan, self.slots
        pad = self.engine.model.pad_id
        ticking = {id(r.member) for r in reqs}
        prefix = np.repeat(self._pad_prefix, slots, axis=0)
        valid_from = np.full(slots, plan.prefix_budget, np.int32)
        prev = np.full((slots, plan.max_new), pad, np.int32)
        prev_len = np.zeros(slots, np.int32)
        live = np.zeros(slots, np.bool_)
        for slot, member in enumerate(self.members):
            if member is None:
                continue
            prefix[slot] = member.prefix[0]
            valid_from[slot] = member.valid_from[0]
            usable = member.prev_tokens[:plan.max_new]
            prev[slot, :len(usable)] = usable
            prev_len[slot] = len(usable)
            # a member that has not ticked since it attached or reset
            # holds no state: a dead row
            live[slot] = id(member) in ticking or member._prefix_filled
        work = self.work
        work.load_rows(prefix, valid_from, prev, prev_len, live)
        tokens, lengths, maxes, chunks = work.run(seg_start, self.eager)
        self.dispatches += 1
        for r in reqs:
            for b in r.changed:
                r.member.block_max[b] = float(maxes[r.member.row, b])
        self.last_run = {"seg_start": seg_start, "rows": len(reqs),
                         "live": int(live.sum()), "chunks": chunks}
        return tokens, lengths
