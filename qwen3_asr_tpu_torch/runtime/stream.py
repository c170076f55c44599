"""WS prefix caching: cached encoder blocks and a persistent decoder cache
per streaming session (``ASR_WS_STREAM_MODE=prefix``).

Counterpart of ``qwen3_asr_tpu/runtime/stream.py`` (``_block_spans``,
``BucketPlan``, ``StreamSession``, ``build_stream_fn``,
``_build_encode_block``, ``_build_tick``), with its names and semantics.
A WS session re-transcribes its window every 450 ms; here a tick
recomputes only what the new audio changed:

* **Pinned bucket.** Every tick runs the bucket of the window CAP, so the
  prompt [prefix 64 | audio tokens | suffix] and each position in it hold
  from tick to tick.
* **Encoder blocks.** The AuT encoder is block-local (its convolutions and
  positional embedding restart per chunk, its attention is block-diagonal
  over ``n_window_infer`` frames), so a block's tokens depend on its own
  mel frames alone, and only blocks whose samples changed are encoded
  again. A changed sample reaches the STFT frames ``N_FFT // 2`` samples
  around it, on both sides of a block edge.
* **The clamp max.** The log-mel clamp couples every frame to the
  window's max. Each block keeps its raw frame max; a tick is run with
  the best known max and redone once, with every block, when the fetched
  maxes prove it wrong (the only recompute).
* **The decoder cache.** A tick re-prefills from the largest rung of a
  fixed ladder of segment starts at or before the first stale position
  (the prefix's 64 positions hold constant tokens, so after a session's
  first tick even a full rebuild starts at 64), then runs resume's verify
  window and continuation (``runtime/resume.py``) on the same cache.
  Keys past the prompt left by an earlier tick are written before any
  query can attend them (the verify window writes them all; a decode
  step writes its position and ends its keys there).

The output is token-identical to the engine's fused resume path at the
pinned bucket: the same operations on the same values, cut at block and
segment edges.

How the card runs it. A CUDA graph replays into fixed addresses, and JAX's
one executable for all sessions, which takes a session's cache as a
donated argument, cannot be copied as it is. So the executables are the
engine's, keyed as JAX keys them and built once for all sessions:
``("encode", frames)`` (``BlockEncoder``: the haloed samples and the clamp
max in input buffers, the block's tokens and raw max out; one graph) and
``("tick", seg_start, P, max_new, dtype)`` (the segment prefill, the first
token and the verify window, one graph a rung), over the working buffers
of ``("state", P, max_new, dtype)`` (``StreamWorkspace``: the working KV
cache, the audio tokens of the prompt, the window's haloed samples, the
prefix and the resume loop's state, with the continuation's chunk graph).
The clamp max is a filled device tensor, not a constant a capture would
bake in. A session owns its encoder state and cache, but they live in the
working buffers while it is the workspace's owner; before another
session's tick the owner's cache and audio tokens are copied out to
buffers of its own and the new owner's copied in (``acquire``). A lone
session never copies. A tick reads the host once after its last chunk:
the tokens, the length and every block's raw max in one transfer.

The session cache of an int4 engine is fp8, as JAX's is
(``stream.py:161-168``; kept for token parity, ROADMAP §3).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..audio.frontend import HOP_LENGTH, N_FFT
from ..models.decoder import decoder_forward, embed_tokens, lm_logits
from ..models.encoder import conv_tokens_per_chunk, encoder_forward
from ..ops.attention import AttnSpec
from .generate import run_loop, strip_generation
from .graphs import Graph
from .resume import ResumeLoop

TAIL_SEG = 64          # decoder positions re-prefilled on a tail tick
FIR_HALO = 128         # samples near the frontier whose bandpassed values
                       # still drift (201-tap FIR: 100, rounded up)


def _block_spans(pinned_frames: int, chunk_frames: int,
                 n_window_infer: int) -> List[tuple]:
    """[(frame_lo, frame_hi), ...]: the encoder's attention blocks over
    the bucket (``models/encoder.py``'s window mask)."""
    block_frames = chunk_frames * max(1, n_window_infer // chunk_frames)
    spans = []
    lo = 0
    while lo < pinned_frames:
        spans.append((lo, min(lo + block_frames, pinned_frames)))
        lo += block_frames
    return spans


class BucketPlan:
    """The pinned bucket's geometry, a function of (engine, window cap)
    alone: the block partition, the prompt layout and the ladder of
    segment starts."""

    def __init__(self, engine, cap_s: float):
        from .engine import PREFIX_BUDGET, max_new_tokens_for

        cfg_enc = engine.model.cfg.encoder
        cap_samples = int(cap_s * 16000)
        self.pinned_frames, self.bucket_s = engine.bucket_frames(cap_samples)
        self.pinned_samples = self.pinned_frames * HOP_LENGTH
        self.chunk_frames = cfg_enc.n_window * 2
        self.spans = _block_spans(self.pinned_frames, self.chunk_frames,
                                  cfg_enc.n_window_infer)
        per_chunk = conv_tokens_per_chunk(self.chunk_frames)
        self.block_tokens = [(hi - lo) // self.chunk_frames * per_chunk
                             for lo, hi in self.spans]
        self.block_offsets = [sum(self.block_tokens[:b])
                              for b in range(len(self.spans))]
        self.max_new = max_new_tokens_for(self.bucket_s)
        self.prefix_budget = PREFIX_BUDGET
        self.prompt_len = (PREFIX_BUDGET + sum(self.block_tokens)
                           + len(engine._suffix))
        # A tick re-prefills [seg_start, P) from the largest start at or
        # before its first stale position: one executable a rung, shared
        # by every session. 64 (the prefix/audio edge) is a rung of its
        # own: the prefix's keys never go stale after a session's first
        # tick.
        starts = {0, PREFIX_BUDGET}
        s = self.prompt_len - TAIL_SEG
        while s > PREFIX_BUDGET:
            starts.add(s)
            s -= TAIL_SEG
        self.seg_starts = sorted(starts)
        # a multiple of 128 (the decode kernels' tile)
        self.s_pad = -(-(self.prompt_len + self.max_new) // 128) * 128

    def block_of_sample(self, s: int) -> int:
        f = s // HOP_LENGTH
        for b, (lo, hi) in enumerate(self.spans):
            if f < hi:
                return b
        return len(self.spans) - 1


def session_cache_dtype(engine) -> torch.dtype:
    """The session cache's dtype: the engine's, but fp8 for an int4
    engine (as JAX's session degrades it)."""
    return (torch.float8_e4m3fn if engine.cache_dtype == torch.int4
            else engine.cache_dtype)


def encode_block(engine, seg: torch.Tensor, clamp_max: torch.Tensor,
                 frames: int):
    """One attention block: haloed samples ``seg`` [(frames - 1)·hop +
    n_fft] f32 and the clamp max (a 0-d f32 tensor) → (tokens [1, nb, H]
    in the engine's dtype, the block's raw mel frame max, 0-d f32).

    JAX's ``_build_encode_block`` (``stream.py:367-395``): frames times
    the window, rfft, power @ mel_fb, log10 of max(·, 1e-10); the raw max;
    max(·, clamp − 8), (· + 4) / 4; the encoder on the block, every frame
    valid. The port's fused ``log_mel`` (``audio/frontend.py``) does the
    same per frame; its constants are shared, its masking is not needed."""
    fe, cfg = engine.frontend, engine.model.cfg.encoder
    x = seg.unfold(0, N_FFT, HOP_LENGTH)[:frames] * fe.window  # [t, n_fft]
    spec = torch.fft.rfft(x, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ fe.mel_fb                                     # [t, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    raw_max = log_spec.amax()
    log_spec = torch.maximum(log_spec, clamp_max - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    mel_block = log_spec.transpose(0, 1)[None].to(engine.dtype)  # [1, M, t]
    flens = torch.full((1,), frames, dtype=torch.int32, device=seg.device)
    toks, _ = encoder_forward(engine.model.params["encoder"], cfg, mel_block,
                              flens)
    return toks.to(engine.dtype), raw_max


class BlockEncoder:
    """``("encode", frames)``: ``encode_block`` as one graph over input
    buffers (``seg``, ``clamp``) and output buffers (``tokens``,
    ``raw_max``), shared by every session."""

    def __init__(self, engine, frames: int):
        dev = engine.device
        chunk = engine.model.cfg.encoder.n_window * 2
        nb = frames // chunk * conv_tokens_per_chunk(chunk)
        self.engine, self.frames = engine, frames
        self.seg = torch.zeros((frames - 1) * HOP_LENGTH + N_FFT,
                               dtype=torch.float32, device=dev)
        self.clamp = torch.zeros((), dtype=torch.float32, device=dev)
        self.tokens = torch.zeros(
            (1, nb, engine.model.cfg.encoder.output_dim),
            dtype=engine.dtype, device=dev)
        self.raw_max = torch.zeros((), dtype=torch.float32, device=dev)
        self.graph = Graph(self._run, dev, engine.graph_pool)

    def _run(self) -> None:
        toks, raw_max = encode_block(self.engine, self.seg, self.clamp,
                                     self.frames)
        self.tokens.copy_(toks)
        self.raw_max.copy_(raw_max)

    def graphs(self) -> List[Graph]:
        return [self.graph]

    def nbytes(self) -> int:
        return sum(x.nbytes for x in (self.seg, self.clamp, self.tokens,
                                      self.raw_max))


class StreamWorkspace:
    """``("state", P, max_new, dtype)``: the working buffers every tick
    graph of one pinned bucket reads and writes, and the owner session
    whose state they hold. The resume loop (``ResumeLoop``, batch 1) holds
    the working cache ``[L, 1, n_kv, s_pad, D]``, ``valid_from`` and the
    draft; ``audio`` holds the prompt's audio tokens, ``halo`` the
    window's reflect-padded samples, ``prefix`` the prompt's prefix ids,
    ``maxes`` the blocks' raw maxes of this tick. ``chunk`` (the
    continuation) is built here, before any session owns the buffers: a
    build runs its function once, and a chunk is not idempotent. The tick
    fronts (``front``) are built on first use: a front run twice is a
    front run once."""

    def __init__(self, engine, plan: BucketPlan, cache_dtype: torch.dtype):
        dev = engine.device
        cfg = engine.model.cfg
        self.engine, self.plan, self.cache_dtype = engine, plan, cache_dtype
        self.loop = ResumeLoop(
            engine.model.params["decoder"], cfg.decoder, 1, plan.prompt_len,
            plan.max_new, eos_id=engine.model.eos_id,
            pad_id=engine.model.pad_id, cache_dtype=cache_dtype, device=dev)
        self.prefix = torch.zeros((1, plan.prefix_budget), dtype=torch.int32,
                                  device=dev)
        self.audio = torch.zeros((1, sum(plan.block_tokens),
                                  cfg.encoder.output_dim),
                                 dtype=engine.dtype, device=dev)
        self.halo = torch.zeros(plan.pinned_samples + N_FFT,
                                dtype=torch.float32, device=dev)
        self.maxes = torch.zeros(len(plan.spans), dtype=torch.float32,
                                 device=dev)
        self.owner: Optional["StreamSession"] = None
        self.lock = threading.Lock()
        self.handovers = 0        # owner changes that copied a state in/out
        self.copied_bytes = 0
        self.fronts: Dict[int, Graph] = {}
        self.chunk = Graph(self.loop.chunk, dev, engine.graph_pool)

    # -- the working state ---------------------------------------------------
    def state_tensors(self) -> List[torch.Tensor]:
        """What a session keeps between ticks: its cache and audio
        tokens."""
        return [x for x in self.loop.cache if x is not None] + [self.audio]

    def state_bytes(self) -> int:
        return sum(x.nbytes for x in self.state_tensors())

    def nbytes(self) -> int:
        return (self.loop.nbytes() + self.prefix.nbytes + self.audio.nbytes
                + self.halo.nbytes + self.maxes.nbytes)

    def acquire(self, session: "StreamSession") -> None:
        """Make ``session`` the owner: the old owner's state (if it has
        one) is copied out to its own buffers, and ``session``'s copied in
        (if it was stashed). A lone session never copies."""
        with self.lock:
            old = self.owner
            if old is session:
                return
            copied = False
            if old is not None and old.has_state():
                if old.stored is None:
                    old.stored = [torch.empty_like(x)
                                  for x in self.state_tensors()]
                for dst, src in zip(old.stored, self.state_tensors()):
                    dst.copy_(src)
                copied = True
            if session.has_state():
                if session.stored is None:
                    raise RuntimeError("a stream session with state owns "
                                       "neither the workspace nor a copy")
                for dst, src in zip(self.state_tensors(), session.stored):
                    dst.copy_(src)
                copied = True
            if copied:
                self.handovers += 1
                self.copied_bytes += self.state_bytes() * (
                    int(old is not None and old.has_state())
                    + int(session.has_state()))
            self.owner = session

    def drop(self, session: "StreamSession") -> None:
        """``session`` no longer counts on the working buffers."""
        with self.lock:
            if self.owner is session:
                self.owner = None

    # -- the tick ------------------------------------------------------------
    def run_front(self, seg_start: int) -> None:
        """The segment prefill of the prompt [prefix | audio | suffix] from
        ``seg_start`` on the working cache (positions seg_start..P-1,
        causal at q_offset = seg_start), the first token, then resume's
        verify window and accept arithmetic (``ResumeLoop.verify``)."""
        eng, loop = self.engine, self.loop
        params, cfg = eng.model.params["decoder"], eng.model.cfg.decoder
        pre = embed_tokens(params, self.prefix.long())
        suf = embed_tokens(params, eng._suffix[None, :])
        prompt = torch.cat([pre.to(eng.dtype), self.audio,
                            suf.to(eng.dtype)], dim=1)          # [1, P, H]
        seg = prompt[:, seg_start:]
        positions = torch.arange(seg_start, loop.prompt_len,
                                 device=prompt.device)[None]
        spec = AttnSpec(causal=True, q_offset=seg_start,
                        valid_from=loop.valid_from)
        hidden, _ = decoder_forward(params, cfg, seg, positions, loop.cache,
                                    seg_start, spec)
        first = lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(
            torch.int32)
        loop.verify(first)

    def front(self, seg_start: int) -> Graph:
        g = self.fronts.get(seg_start)
        if g is None:
            g = Graph(lambda: self.run_front(seg_start), self.engine.device,
                      self.engine.graph_pool)
            self.fronts[seg_start] = g
        return g

    def graphs(self) -> List[Graph]:
        return [self.chunk] + list(self.fronts.values())


class StreamSession:
    """One WS connection's prefix-cached state. Not thread-safe: the
    serving layer runs its ticks on the queue's device thread.

    ``eager = True`` runs the same functions without the graphs (on the
    card only to hold the graphs against them)."""

    def __init__(self, engine, cap_s: float, language: Optional[str] = None,
                 context: str = ""):
        self.engine = engine
        self.model = engine.model
        plan = self.plan = BucketPlan(engine, cap_s)
        self.pinned_frames, self.bucket_s = plan.pinned_frames, plan.bucket_s
        self.pinned_samples = plan.pinned_samples
        self.chunk_frames = plan.chunk_frames
        self.spans = plan.spans
        self.block_tokens = plan.block_tokens
        self.max_new = plan.max_new
        # the fused path's own prefix (engine.padded_prefix): any other
        # truncation or padding would break token parity
        self.prefix, self.valid_from = engine.padded_prefix(language, context)
        self.prompt_len = plan.prompt_len
        self.seg_starts = plan.seg_starts
        self.cache_dtype = session_cache_dtype(engine)
        self.work: StreamWorkspace = engine._stream_fn(
            ("state", plan.prompt_len, plan.max_new, self.cache_dtype), plan)
        self.stored: Optional[List[torch.Tensor]] = None
        self.eager = False
        self._reset_host()
        self.stats = {"ticks": 0, "tail": 0, "full": 0, "redo": 0}
        self.last_run: dict = {}

    def _reset_host(self) -> None:
        self.encoded = [False] * len(self.spans)
        self.block_max = np.full(len(self.spans), -np.inf)
        self.clamp_max: Optional[float] = None
        self.prev_window = np.zeros(0, np.float32)
        self.prev_tokens: List[int] = []
        self._prefix_filled = False

    # -- lifecycle -------------------------------------------------------------
    def has_state(self) -> bool:
        """Whether a later tick counts on this session's cache and tokens."""
        return self._prefix_filled or any(self.encoded)

    def held_bytes(self) -> int:
        """Device bytes the session holds of its own (its stashed state;
        0 while it has been the only session of its workspace)."""
        return sum(x.nbytes for x in self.stored or [])

    def release(self) -> None:
        """Drop every device reference (its own buffers and its claim on
        the workspace); the serving layer binds a new session next time."""
        self.reset()
        if self.work is not None:
            self.work.drop(self)
        self.work = None
        self.engine = None
        self.model = None

    def reset(self) -> None:
        """Flush or reset: forget every cached block and key; the next tick
        rebuilds from scratch."""
        self._reset_host()
        self.stored = None

    def block_tokens_of(self, b: int) -> torch.Tensor:
        """Block ``b``'s cached encoder tokens [1, nb, H] (a copy)."""
        work = self.work
        if work.owner is self:
            src = work.audio
        elif self.stored is not None:
            src = self.stored[-1]
        else:
            raise ValueError("the session holds no encoder tokens")
        off = self.plan.block_offsets[b]
        return src[:, off:off + self.block_tokens[b]].clone()

    # -- one tick --------------------------------------------------------------
    def update(self, window: np.ndarray):
        """window: f32 mono 16 kHz (bandpassed by the caller), at most the
        cap. Returns (text, token_ids), token-identical to the fused
        resume path at the pinned bucket."""
        window = np.asarray(window, np.float32)
        n = len(window)
        if n == 0:
            return "", []
        if n > self.pinned_samples:
            window = window[-self.pinned_samples:]
            n = self.pinned_samples
        self.stats["ticks"] += 1

        # the diff against the previous tick
        m = len(self.prev_window)
        lim = min(m, n)
        neq = np.nonzero(window[:lim] != self.prev_window[:lim])[0]
        common = int(neq[0]) if len(neq) else lim
        first_changed = max(0, min(common, m - FIR_HALO))

        # STFT frames overlap (N_FFT > hop): a changed sample reaches
        # frames N_FFT / 2 samples away on BOTH sides, so the block before
        # an edge and the block after it can read it.
        block_of = self.plan.block_of_sample
        frontier_block = block_of(
            min(max(n - 1, 0) + N_FFT // 2, self.pinned_samples - 1))
        first_block = block_of(max(0, first_changed - N_FFT // 2))
        changed = list(range(first_block, frontier_block + 1))
        # A chunk-quantized trim can SHRINK the window across a block
        # edge: blocks between the new and the old frontier still hold
        # trimmed-out audio where the fused path sees zeros. Encode them
        # again from the zero-padded signal (past the old frontier a block
        # is unencoded or already encodes zeros).
        if m:
            prev_frontier = block_of(
                min(m - 1 + N_FFT // 2, self.pinned_samples - 1))
            changed += [b for b in range(frontier_block + 1,
                                         prev_frontier + 1)
                        if self.encoded[b]]
        missing = [b for b in range(len(self.spans))
                   if not self.encoded[b] and b not in changed]

        # The optimistic clamp max: the best known one (a changed block's
        # stored max is stale, but still the best prior); the fetched maxes
        # prove it or refute it.
        known = [mx for mx in self.block_max if np.isfinite(mx)]
        guess = max(max(known) if known else -10.0, -10.0)

        # The first stale decoder position; the prefix's keys (< 64)
        # survive trims and clamp changes, and only a new or reset session
        # lacks them.
        if self.clamp_max is None or guess != self.clamp_max:
            changed = list(range(len(self.spans)))  # every block is stale
        else:
            changed = sorted(set(changed) | set(missing))
        first_stale = changed[0] if changed else len(self.spans)
        change_tok = (self.plan.prefix_budget
                      + sum(self.block_tokens[:first_stale]))
        if not self._prefix_filled:
            change_tok = 0
        seg_start = max(s for s in self.seg_starts if s <= change_tok)

        ids = self._run(window, changed, guess, seg_start)
        true_max = max(float(np.max(self.block_max)), -10.0)
        if true_max != guess:
            # A new frame raised the window's max (or the block that held
            # it was trimmed out): redo with the proven max, every block.
            self.stats["redo"] += 1
            ids = self._run(window, list(range(len(self.spans))), true_max,
                            self.plan.prefix_budget)
        self._prefix_filled = True
        self.clamp_max = true_max

        self.prev_window = window.copy()
        self.prev_tokens = ids
        text = self.model.tokenizer.decode(ids).strip()
        return text, ids

    # -- internals -------------------------------------------------------------
    @torch.inference_mode()
    def _run(self, window: np.ndarray, changed: List[int], clamp: float,
             seg_start: int) -> List[int]:
        """Encode the changed blocks, run one decoder tick, read the
        results (tokens, length and the blocks' raw maxes: one read)."""
        eng, work, plan = self.engine, self.work, self.plan
        padded = np.zeros(self.pinned_samples, np.float32)
        padded[:len(window)] = window
        halo = np.pad(padded, N_FFT // 2, mode="reflect")
        prev = np.full((1, self.max_new), self.model.pad_id, np.int32)
        usable = self.prev_tokens[:self.max_new]
        prev[0, :len(usable)] = usable
        loop = work.loop
        work.acquire(self)
        try:
            # inputs first (host to device), then the launches
            work.halo.copy_(torch.from_numpy(halo))
            loop.prev_tokens.copy_(torch.from_numpy(prev))
            loop.prev_len.fill_(len(usable))
            work.prefix.copy_(torch.from_numpy(self.prefix))
            loop.valid_from.fill_(int(self.valid_from[0]))
            for b in changed:
                lo, hi = self.spans[b]
                enc = eng._stream_fn(("encode", hi - lo))
                enc.seg.copy_(work.halo[lo * HOP_LENGTH:
                                        (hi - 1) * HOP_LENGTH + N_FFT])
                enc.clamp.fill_(clamp)
                if self.eager:
                    enc._run()
                else:
                    enc.graph()
                off = plan.block_offsets[b]
                work.audio[:, off:off + self.block_tokens[b]].copy_(
                    enc.tokens)
                work.maxes[b].copy_(enc.raw_max)
                self.encoded[b] = True
            if self.eager:
                chunks = run_loop(lambda: work.run_front(seg_start),
                                  loop.chunk, loop.active)
            else:
                front = eng._stream_fn(("tick", seg_start, self.prompt_len,
                                        self.max_new, self.cache_dtype))
                chunks = run_loop(front, work.chunk, loop.active)
            self.stats["full" if seg_start == 0 else "tail"] += 1
            lengths = (loop.tokens != self.model.pad_id).sum(-1).to(
                torch.int32)
            host = torch.cat([loop.tokens[0], lengths,
                              work.maxes.view(torch.int32)]).cpu().numpy()
        except Exception:
            # the working buffers and the session's state are no longer
            # to be trusted: the next tick rebuilds from scratch
            self.reset()
            work.drop(self)
            raise
        n_tok = self.max_new
        tokens, length = host[:n_tok], int(host[n_tok])
        maxes = host[n_tok + 1:].view(np.float32)
        for b in changed:
            self.block_max[b] = float(maxes[b])
        self.last_run = {"seg_start": seg_start, "changed": len(changed),
                         "chunks": chunks}
        return strip_generation(tokens, length, self.model.eos_id)


# -- engine-level executables (shared by every session) -------------------------

def build_stream_fn(engine, key, plan: Optional[BucketPlan] = None):
    """What the engine memoizes under ``key`` (``engine._stream_fn``):
    ``("encode", frames)`` a ``BlockEncoder``; ``("state", P, max_new,
    dtype)`` a ``StreamWorkspace`` (``plan`` given); ``("tick", seg_start,
    P, max_new, dtype)`` that workspace's front graph at ``seg_start``."""
    kind = key[0]
    if kind == "encode":
        return BlockEncoder(engine, key[1])
    if kind == "state":
        if plan is None:
            raise KeyError(f"{key}: a workspace is built from its plan")
        return StreamWorkspace(engine, plan, key[3])
    if kind == "tick":
        _, seg_start, prompt_len, max_new, dtype = key
        work = engine._stream_fns[("state", prompt_len, max_new, dtype)]
        return work.front(seg_start)
    raise KeyError(key)


def warm_stream_keys(engine, cap_s: float) -> List[tuple]:
    """Build every executable a session at ``cap_s`` can reach (each block
    shape's encoder, the workspace with its chunk graph, each rung's
    front) and return their keys. Nothing runs but each build's own
    run."""
    plan = BucketPlan(engine, cap_s)
    dtype = session_cache_dtype(engine)
    keys = [("encode", f) for f in sorted({hi - lo for lo, hi in
                                           plan.spans})]
    keys.append(("state", plan.prompt_len, plan.max_new, dtype))
    keys += [("tick", s, plan.prompt_len, plan.max_new, dtype)
             for s in plan.seg_starts]
    for key in keys:
        engine._stream_fn(key, plan)
    return keys
