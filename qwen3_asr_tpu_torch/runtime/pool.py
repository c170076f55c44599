"""Continuous batching: a shared decode pool with per-request slots.

Counterpart of ``qwen3_asr_tpu/runtime/pool.py`` ``DecodePool``, with its
names, variables and semantics:

* a persistent KV cache of ``max_slots`` rows (``[L, rows, n_kv, S, D]``,
  S = ``s_pool``: the largest bucket's prompt plus its token budget,
  rounded up to 128);
* per-bucket PREFILL at B=1 (the engine's ``prompt_embeds`` of the padded
  audio and ``padded_prefix``, the decoder's causal prefill, the first
  token), whose cache segment is copied into a free slot row;
* one DECODE SEGMENT per slot window advancing every row of the window
  ``segment`` tokens, each row at its own position: ``pos``, ``active``
  and ``limit`` are per row, ``valid_to = pos + 1`` and the K/V write
  position is ``pos[B]`` (kernel B's per-row route), a row ends on EOS, on
  pad or at ``pos >= limit``, and ``last`` keeps its value when the step
  emits pad;
* a SLOT WINDOW that autoscales over the ladder base, 2x, .. up to
  ``max_slots``: a burst grows it instead of queueing, and stragglers at
  high rows are compacted down (a row copy) so that it shrinks back.

Requests join at segment boundaries, greedy output is the fused path's
(the same argmax recurrence; only scheduling changes), and stale cache
content needs no zeroing: a row's key at position p is attendable only
once its occupant's own write has reached p.

How the card runs it. The prefill of each bucket and the segment of each
window are CUDA graphs (``runtime/graphs.py`` ``Graph``) in a memory pool
of their own, captured when the pool starts (the segments, and the
prefills of ``buckets``; a bucket first met later is captured then, under
``graphs.device_lock`` as every build is). The state (``last``, ``pos``,
``active``, ``valid_from``, ``limit``, ``first``, ``tokens``) lives in
device buffers that the graphs rewrite in place, so after each segment
its outputs are copied, on the stream and before the next segment is
launched, into one of two pinned host buffers with an event: the host
reads segment n there while n+1 runs, and admission (a pinned copy in, a
prefill replay, the row insert and the state join, all eager ops on the
stream) never waits for the card. The drive thread launches on the
device's default stream, the one the queue's thread replays the engine's
graphs on.

The window's rows. The cache is one flat allocation per K and V, and the
window of w rows is its first ``L*w`` rows viewed as ``[L, w, ...]``:
contiguous, so kernels #2/#3 and B read and write it in place with no copy
in or out per segment. A window change re-lays the occupied rows
(``_relayout``: a copy of the occupied rows of each layer, once per
change, not per segment).

The pool cache of an int4 engine is fp8, as JAX's is (ROADMAP §3: JAX
does it for a jit bug that torch does not have; kept for token parity
with the JAX pool).

Enable with ``ASR_CONTINUOUS_BATCHING=true`` (``ASR_POOL_SLOTS``,
``ASR_POOL_MAX_SLOTS``, ``ASR_POOL_SEGMENT``). Requests that cannot pool
(timestamps, resampling, multichannel, longer than ``MAX_SEGMENT_S``,
resume ticks) keep the fused path.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from functools import partial
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..audio.frontend import HOP_LENGTH
from ..models.decoder import (KVCache, decoder_forward, embed_tokens,
                              init_kv_cache, lm_logits)
from ..ops.attention import AttnSpec
from .engine import (AUDIO_BUCKETS_S, PREFIX_BUDGET, TARGET_SR,
                     max_new_tokens_for)
from .generate import GreedyLoop
from .graphs import Graph

log = logging.getLogger(__name__)


class PoolStoppedError(RuntimeError):
    """The decode pool is stopping or stopped; the caller serves the
    request on the fused path (``ModelManager.transcribe_pooled`` does)."""


class _Request(NamedTuple):
    audio: np.ndarray          # f32/s16 mono 16 kHz, <= largest bucket
    language: Optional[str]
    set_result: callable       # called with (text, token_ids) off-thread
    set_error: callable


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _to_device(dst: torch.Tensor, array: np.ndarray) -> None:
    """Host array → ``dst`` with no host sync on the card (a pinned copy,
    which the caching host allocator keeps until the copy has run)."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class _Prefill:
    """One bucket's admission at B=1: the audio and prefix ids as input
    buffers, the engine's prompt, the decoder's causal prefill into a B=1
    cache of the prompt rounded up to 128 in the pool's cache dtype, and
    the first token into ``first``: one ``Graph``."""

    def __init__(self, pool: "DecodePool", bucket_frames: int):
        eng, dev = pool.engine, pool.engine.device
        cfg = eng.model.cfg.decoder
        self.engine, self.bucket_frames = eng, bucket_frames
        self.prompt_len = eng.prompt_length(bucket_frames)
        self.s_pad = _round128(self.prompt_len)
        self.audio = torch.zeros((1, bucket_frames * HOP_LENGTH),
                                 dtype=torch.float32, device=dev)
        self.prefix = torch.zeros((1, PREFIX_BUDGET), dtype=torch.int32,
                                  device=dev)
        self.first = torch.zeros(1, dtype=torch.int32, device=dev)
        self.loop = GreedyLoop(
            eng.model.params["decoder"], cfg, 1, self.prompt_len, 1,
            eos_id=eng.model.eos_id, pad_id=eng.model.pad_id,
            cache_dtype=pool.cache_dtype, device=dev,
            cache=init_kv_cache(cfg, 1, self.s_pad, pool.cache_dtype, dev))
        self.graph = Graph(self._run, dev, pool.graph_pool)

    def _run(self) -> None:
        self.first.copy_(self.loop.prompt(self.engine.prompt_embeds(
            self.audio, self.prefix, self.bucket_frames)))

    def nbytes(self) -> int:
        return (self.audio.nbytes + self.prefix.nbytes + self.first.nbytes
                + self.loop.nbytes())


class DecodePool:
    def __init__(self, engine, slots: int = None, segment: int = None,
                 max_slots: int = None, buckets=()):
        """``buckets``: seconds whose prefills are captured now (the
        segments of every window always are); a pool that cannot build
        them raises here."""
        if getattr(engine, "mesh", None) is not None:
            raise NotImplementedError("the decode pool under a mesh is "
                                      "ROADMAP item 14b")
        self.engine = engine
        self.model = engine.model
        self.base = slots or int(os.getenv("ASR_POOL_SLOTS", "8"))
        # An EXPLICIT slots= without max_slots= pins the pool at that size;
        # the env-driven serving default gets 4x burst headroom.
        if max_slots is not None:
            self.max_slots = max(max_slots, self.base)
        elif slots is not None:
            self.max_slots = self.base
        else:
            self.max_slots = max(int(os.getenv("ASR_POOL_MAX_SLOTS", "0"))
                                 or self.base * 4, self.base)
        self._sizes = []
        w = self.base
        while w < self.max_slots:
            self._sizes.append(w)
            w *= 2
        self._sizes.append(self.max_slots)
        self.segment = segment or int(os.getenv("ASR_POOL_SEGMENT", "16"))

        longest = 0
        for sec in AUDIO_BUCKETS_S:
            bf, bs = engine.bucket_frames(int(sec * TARGET_SR))
            longest = max(longest, engine.prompt_length(bf)
                          + max_new_tokens_for(bs))
        self.s_pool = _round128(longest)
        self.cache_dtype = (torch.float8_e4m3fn
                            if engine.cache_dtype == torch.int4
                            else engine.cache_dtype)

        dev, cfg = engine.device, self.model.cfg.decoder
        n = self.max_slots
        with torch.inference_mode():
            # flat K and V: the window of w rows is their first L*w rows
            store = init_kv_cache(cfg, n, self.s_pool, self.cache_dtype, dev)
            self._store = KVCache(store.k.view(-1), store.v.view(-1))
            self._views = {w: self._window_cache(w) for w in self._sizes}
            self.last = torch.zeros(n, dtype=torch.int32, device=dev)
            self.pos = torch.zeros(n, dtype=torch.int64, device=dev)
            self.valid_from = torch.zeros(n, dtype=torch.int32, device=dev)
            self.active = torch.zeros(n, dtype=torch.bool, device=dev)
            self.limit = torch.zeros(n, dtype=torch.int64, device=dev)
            self.first = torch.zeros(n, dtype=torch.int32, device=dev)
            self.tokens = torch.full((n, self.segment), self.model.pad_id,
                                     dtype=torch.int32, device=dev)
        # two host copies of a segment's outputs, used in turns
        self._host = [{name: torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=dev.type == "cuda")
                       for name, t in self._outputs().items()}
                      for _ in range(2)]
        self._flip = 0
        self.graph_pool = (torch.cuda.graph_pool_handle()
                           if dev.type == "cuda" else None)
        self._prefill_fns = {}
        self._decode_fns = {}
        self.admitted = 0          # requests slotted (observability)
        self.moved = 0             # rows moved down by compaction
        # run the prefills and segments without their graphs (on the card
        # only to hold the graphs against them, as BucketExecutable.run's
        # ``eager``)
        self.eager = False

        # Host-side slot state. _active is OPTIMISTIC for freshly admitted
        # slots (their first token is on the device until the slot's first
        # segment is drained: _pending_first).
        self._last = np.zeros(n, np.int32)
        self._pos = np.zeros(n, np.int64)
        self._valid_from = np.zeros(n, np.int32)
        self._active = np.zeros(n, bool)
        self._limit = np.zeros(n, np.int64)
        self._tokens: List[List[int]] = [[] for _ in range(n)]
        self._owner: List[Optional[_Request]] = [None] * n
        self._pending_first = [False] * n
        # admission generation per slot: a drain applies only to the
        # occupant its segment was launched with
        self._gen = np.zeros(n, np.int64)
        self._pending: List[_Request] = []
        # popped from _pending but not yet slotted: still in flight
        self._admitting = 0
        # the window's size; the rows are laid out in its view
        self.window = self.base

        with torch.inference_mode():
            for w in self._sizes:
                self._decode_segment_fn(w)
            for sec in buckets:
                self._prefill_fn(engine.bucket_frames(int(sec * TARGET_SR))[0])
        self._cv = threading.Condition()
        self._running = True
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="decode-pool")
        self._thread.start()
        log.info("DecodePool: %d..%d slots (window ladder %s) x S=%d %s "
                 "cache, segment %d tokens", self.base, self.max_slots,
                 self._sizes, self.s_pool,
                 str(self.cache_dtype).replace("torch.", ""), self.segment)

    @property
    def slots(self) -> int:
        """Allocated slot rows (the autoscale ceiling)."""
        return self.max_slots

    # -- observability --------------------------------------------------------
    def graphs(self) -> List[Graph]:
        return ([p.graph for p in list(self._prefill_fns.values())]
                + list(self._decode_fns.values()))

    @property
    def executable_count(self) -> int:
        """Graphs built: a prefill per bucket met, a segment per window."""
        return len(self._prefill_fns) + len(self._decode_fns)

    def held_bytes(self) -> int:
        """Bytes of the pool's cache, state and prefill buffers (the graphs'
        memory pool is not counted)."""
        state = [self._store.k, self._store.v, self.last, self.pos,
                 self.valid_from, self.active, self.limit, self.first,
                 self.tokens]
        return (sum(x.nbytes for x in state)
                + sum(p.nbytes() for p in list(self._prefill_fns.values())))

    # -- public API -----------------------------------------------------------
    def submit(self, audio: np.ndarray, language: Optional[str],
               set_result, set_error) -> None:
        """Queue one clip; set_result(text, token_ids) fires off-thread."""
        with self._cv:
            # under the cv: the drive thread's final _fail_all takes it too,
            # so an append either sees False here or is failed there
            if not self._running:
                set_error(PoolStoppedError("decode pool stopped"))
                return
            self._pending.append(_Request(audio, language, set_result,
                                          set_error))
            self._cv.notify()

    def stop(self) -> None:
        self._running = False
        with self._cv:
            self._cv.notify()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # slot state is the thread's to mutate: it fails all
            # outstanding work itself on exit (_drive's finally)
            log.warning("DecodePool stop: drive thread still draining; "
                        "outstanding requests fail when it exits")

    @property
    def depth(self) -> int:
        with self._cv:
            return (len(self._pending) + self._admitting
                    + int(self._active.sum()))

    @staticmethod
    def _safe_error(req: _Request, err: Exception) -> None:
        try:
            req.set_error(err)
        except Exception:  # callbacks must never kill pool teardown
            log.exception("decode-pool error callback raised")

    def _fail_all(self, err: Exception) -> None:
        """Fail everything queued or slotted (drive thread only)."""
        with self._cv:
            pending, self._pending = self._pending, []
            self._admitting = 0
        for req in pending:
            self._safe_error(req, err)
        for s in range(self.max_slots):
            req, self._owner[s] = self._owner[s], None
            self._active[s] = False
            self._pending_first[s] = False
            if req is not None:
                self._safe_error(req, err)

    # -- device functions -----------------------------------------------------
    def _window_cache(self, w: int) -> KVCache:
        cfg = self.model.cfg.decoder
        shape = (cfg.num_hidden_layers, w, cfg.num_key_value_heads,
                 self.s_pool, cfg.head_dim)
        n = int(np.prod(shape))
        return KVCache(self._store.k[:n].view(shape),
                       self._store.v[:n].view(shape))

    def _outputs(self) -> dict:
        return {"last": self.last, "pos": self.pos, "active": self.active,
                "first": self.first, "tokens": self.tokens}

    def _prefill_fn(self, bucket_frames: int) -> _Prefill:
        fn = self._prefill_fns.get(bucket_frames)
        if fn is None:
            fn = self._prefill_fns[bucket_frames] = _Prefill(self,
                                                             bucket_frames)
        return fn

    def _decode_segment_fn(self, window: int) -> Graph:
        """The segment of ``window``: a callable that launches it."""
        fn = self._decode_fns.get(window)
        if fn is None:
            fn = self._decode_fns[window] = Graph(
                partial(self._segment, window), self.engine.device,
                self.graph_pool)
        return fn

    def _segment(self, w: int) -> None:
        """``segment`` predicated steps of rows [0, w), in place
        (``qwen3_asr_tpu/runtime/pool.py:305-350``)."""
        params = self.model.params["decoder"]
        cfg = self.model.cfg.decoder
        eos_id, pad_id = self.model.eos_id, self.model.pad_id
        last, pos, active = self.last[:w], self.pos[:w], self.active[:w]
        valid_from, limit = self.valid_from[:w], self.limit[:w]
        tokens, cache = self.tokens[:w], self._views[w]
        tokens.fill_(pad_id)
        for i in range(self.segment):
            hidden = embed_tokens(params, last[:, None].long(), cfg)
            spec = AttnSpec(valid_from=valid_from,
                            valid_to=(pos + 1).to(torch.int32))
            hidden, _ = decoder_forward(params, cfg, hidden, pos[:, None],
                                        cache, pos, spec)
            nxt = lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(
                torch.int32)
            nxt = torch.where(active, nxt, pad_id)
            tokens[:, i] = nxt
            pos.add_(active.long())
            # pad_id is an alternate end-of-text, as on the fused path
            active &= (nxt != eos_id) & (nxt != pad_id) & (pos < limit)
            last.copy_(torch.where(nxt == pad_id, last, nxt))

    def _insert(self, prefill: _Prefill, slot: int) -> None:
        """The prefill's cache segment into row ``slot``, and the state join
        (``_join_state_fn``): device ops on the stream, no host sync."""
        view = self._views[self.window]
        for pool_c, seg_c in zip(view, prefill.loop.cache):
            if pool_c is not None:
                pool_c[:, slot, :, :prefill.s_pad].copy_(seg_c[:, 0])
        first = prefill.first[0]
        self.first[slot] = first
        self.last[slot] = first
        self.active[slot] = ((first != self.model.eos_id)
                             & (first != self.model.pad_id))

    def _move_row(self, src: int, dst: int) -> None:
        """Copy one slot's cache row and first token onto another
        (compaction; JAX's ``_move_row_fn``); stale content above the
        occupant's pos copies along harmlessly."""
        view = self._views[self.window]
        for c in (view.k, view.v):
            c[:, dst].copy_(c[:, src])
        self.first[dst] = self.first[src]
        self.moved += 1

    def _relayout(self, new: int, keep: int) -> None:
        """Make ``new`` the window, its rows [0, keep) of every layer laid
        out in its view: each layer's block moves from offset l*old to
        l*new rows, in an order that overwrites no block before it has
        moved (descending layers to grow, ascending to shrink), through a
        copy where a layer's two blocks overlap."""
        old, self.window = self.window, new
        if keep == 0 or new == old:
            return
        cfg = self.model.cfg.decoder
        row = cfg.num_key_value_heads * self.s_pool * cfg.head_dim
        layers = range(1, cfg.num_hidden_layers)
        for store in (self._store.k, self._store.v):
            for layer in (reversed(layers) if new > old else layers):
                src = store[layer * old * row:(layer * old + keep) * row]
                dst = store[layer * new * row:(layer * new + keep) * row]
                if abs(new - old) * layer < keep:
                    src = src.clone()
                dst.copy_(src)

    def _seed_state(self) -> None:
        """Device state from the host's (after compaction), every
        unresolved first token patched from its device value."""
        for dst, host in ((self.last, self._last), (self.pos, self._pos),
                          (self.active, self._active),
                          (self.valid_from, self._valid_from),
                          (self.limit, self._limit)):
            _to_device(dst, host)
        for s in range(self.max_slots):
            if self._pending_first[s]:
                first = self.first[s]
                self.last[s] = first
                self.active[s] = ((first != self.model.eos_id)
                                  & (first != self.model.pad_id))

    def _copy_out(self):
        """A segment's outputs into the next host buffer, on the stream,
        with an event; the handle ``_drain`` reads."""
        buf = self._host[self._flip]
        self._flip ^= 1
        for name, t in self._outputs().items():
            buf[name].copy_(t, non_blocking=True)
        event = None
        if self.engine.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return buf, event

    # -- slot-window policy ---------------------------------------------------
    def _window_for(self, demand: int, *, floor: int = 0) -> int:
        """Smallest ladder size covering both the demand (occupied +
        queued, capped at the allocation) and the highest occupied slot
        index + 1 (rows outside the window never advance)."""
        need = max(min(demand, self.max_slots), floor, 1)
        for w in self._sizes:
            if w >= need:
                return w
        return self._sizes[-1]

    def _occupancy(self):
        occ = [s for s in range(self.max_slots)
               if self._owner[s] is not None]
        return occ, (max(occ) + 1 if occ else 0)

    def _compact(self) -> None:
        """Move occupants down into the lowest free slots so the window can
        shrink. Needs no segment in flight; the device state is reseeded
        from the host after."""
        occ, _ = self._occupancy()
        for s in sorted(occ, reverse=True):
            frees = [l for l in range(s) if self._owner[l] is None]
            if not frees:
                break
            l = frees[0]
            self._move_row(s, l)
            for arr in (self._last, self._pos, self._valid_from,
                        self._active, self._limit):
                arr[l] = arr[s]
            self._tokens[l] = self._tokens[s]
            self._owner[l], self._owner[s] = self._owner[s], None
            self._pending_first[l] = self._pending_first[s]
            self._pending_first[s] = False
            self._active[s] = False
            self._gen[l] += 1
            self._gen[s] += 1
        self._seed_state()

    # -- the drive loop -------------------------------------------------------
    def _admit(self, req: _Request, slot: int) -> None:
        eng = self.engine
        bucket_frames, bucket_s = eng.bucket_frames(len(req.audio))
        # single-sourced with the fused path (bucket_inputs: the s16
        # scaling and padding; padded_prefix)
        audio, prefix, valid_from = eng.bucket_inputs([req.audio],
                                                      bucket_frames,
                                                      req.language)
        prefill = self._prefill_fn(bucket_frames)
        _to_device(prefill.audio, audio)
        _to_device(prefill.prefix, prefix)
        prefill.loop.valid_from.fill_(int(valid_from[0]))
        (prefill.graph.fn if self.eager else prefill.graph)()
        self._insert(prefill, slot)
        prompt_len = prefill.prompt_len
        limit = prompt_len + max_new_tokens_for(bucket_s) - 1
        self.pos[slot] = prompt_len
        self.valid_from[slot] = int(valid_from[0])
        self.limit[slot] = limit

        self._owner[slot] = req
        self._gen[slot] += 1
        self._tokens[slot] = []
        self._pending_first[slot] = True
        self._pos[slot] = prompt_len
        self._valid_from[slot] = int(valid_from[0])
        self._limit[slot] = limit
        # optimistic: a first token that is EOS decodes masked and retires
        # at the slot's first drain
        self._active[slot] = True
        self.admitted += 1

    def _retire(self, slot: int) -> None:
        req = self._owner[slot]
        self._owner[slot] = None
        self._active[slot] = False
        if req is None:
            return
        ids = []
        for t in self._tokens[slot]:
            if t in (self.model.eos_id, self.model.pad_id):
                break
            ids.append(t)
        text = self.model.tokenizer.decode(ids).strip()
        try:
            req.set_result(text, ids)
        except Exception:  # callback errors stay local
            log.exception("decode-pool result callback failed")

    def _drain(self, handle, in_seg) -> None:
        """Read one finished segment's outputs and retire finished rows.

        ``in_seg``: (slot, admission generation) pairs OWNED when the
        segment was launched: only their outputs are authoritative."""
        buf, event = handle
        if event is not None:
            event.synchronize()
        out = {name: t.numpy().copy() for name, t in buf.items()}
        for s, gen in in_seg:
            if self._owner[s] is None or self._gen[s] != gen:
                continue
            if self._pending_first[s]:
                self._tokens[s] = [int(out["first"][s])]
                self._pending_first[s] = False
            self._last[s] = out["last"][s]
            self._pos[s] = out["pos"][s]
            self._active[s] = out["active"][s]
            self._tokens[s].extend(int(t) for t in out["tokens"][s]
                                   if t != self.model.pad_id)
            if not out["active"][s]:
                self._retire(s)

    def _drive(self) -> None:
        """Pipelined segment loop: segment n+1 is launched before segment
        n's outputs are read, so the host's work overlaps the card's.
        Retirements happen one segment late (a finished row decodes at
        most one extra segment, masked, into its own slot)."""
        dev = self.engine.device
        try:
            with torch.inference_mode(), (torch.cuda.device(dev)
                                          if dev.type == "cuda"
                                          else contextlib.nullcontext()):
                self._drive_loop()
        except BaseException:
            log.exception("decode-pool drive thread died")
            raise
        finally:
            # flip _running before the drain: submit() checks it under the
            # cv the drain takes, so nothing is appended after it
            self._running = False
            self._fail_all(PoolStoppedError("decode pool stopped"))

    def _drive_loop(self) -> None:
        inflight = None    # (host-copy handle, in_seg slots)
        while self._running:
            with self._cv:
                while (self._running and not self._pending
                       and not self._active.any() and inflight is None):
                    self._cv.wait(timeout=1.0)
                if not self._running:
                    break
                pending, self._pending = self._pending, []
                self._admitting = len(pending)

            try:
                # Shrink first when only straggler rows (not demand) hold a
                # larger window open: one pipeline sync, compact, reseed.
                occ, floor = self._occupancy()
                demand = len(occ) + len(pending)
                if self._window_for(demand) < self._window_for(demand,
                                                               floor=floor):
                    if inflight is not None:
                        self._drain(*inflight)
                        inflight = None
                        occ, floor = self._occupancy()
                        demand = len(occ) + len(pending)
                    if (self._window_for(demand) <
                            self._window_for(demand, floor=floor)):
                        self._compact()
                        occ, floor = self._occupancy()
                window = self._window_for(len(occ) + len(pending),
                                          floor=floor)
                if window != self.window:
                    log.info("DecodePool window %d -> %d (occupied %d, "
                             "queued %d)", self.window, window, len(occ),
                             len(pending))
                    self._relayout(window, floor)

                while pending:
                    free = [s for s in range(window)
                            if self._owner[s] is None]
                    if not free and inflight is not None:
                        # the in-flight segment may retire rows
                        self._drain(*inflight)
                        inflight = None
                        free = [s for s in range(window)
                                if self._owner[s] is None]
                    if not free:
                        with self._cv:  # genuinely full: decode first
                            self._pending[:0] = pending
                            self._admitting = 0
                        pending = []
                        break
                    # pop BEFORE admit: `pending` holds exactly the requests
                    # the failure handler still owes an error to
                    req = pending.pop(0)
                    try:
                        self._admit(req, free[0])
                    except Exception as e:
                        log.exception("decode-pool admit failed: %s", e)
                        self._owner[free[0]] = None
                        self._active[free[0]] = False
                        self._pending_first[free[0]] = False
                        self.active[free[0]] = False
                        self._safe_error(req, e)
                    with self._cv:
                        self._admitting -= 1

                if not self._active.any() and inflight is None:
                    continue

                segment = self._decode_segment_fn(window)
                (segment.fn if self.eager else segment)()
                handle = self._copy_out()
                in_seg = [(s, self._gen[s]) for s in range(self.max_slots)
                          if self._owner[s] is not None]
                prev, inflight = inflight, (handle, in_seg)
                if prev is not None:
                    self._drain(*prev)   # overlaps the running segment
                if not self._active.any() and not self._pending:
                    # nothing (known to be) active: finish the tail
                    self._drain(*inflight)
                    inflight = None
                self.engine.last_used = time.time()   # the idle clock
            except Exception as e:  # fail in-flight requests, not the thread
                log.exception("decode-pool segment failed: %s", e)
                inflight = None
                with self._cv:
                    self._admitting = 0
                for s in range(self.max_slots):
                    self._pending_first[s] = False
                    self._active[s] = False
                    if self._owner[s] is not None:
                        req = self._owner[s]
                        self._owner[s] = None
                        self._safe_error(req, e)
                for req in pending:
                    self._safe_error(req, e)
                # JAX reallocates its donated cache; the graphs here hold
                # the buffers' addresses, so they are reset in place
                for t in (self._store.k, self._store.v, self.active):
                    t.zero_()
