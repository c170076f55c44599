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

The grouped mode (``runtime/stream_group.py``) runs on the same
workspace class with ``slots`` rows: ``("gstate", P, max_new, slots,
dtype)`` and its fronts ``("gtick", seg_start, P, max_new, slots,
dtype)``; its owner is a ``StreamGroup``. The diff, the clamp guess and
the first stale position (``diff_blocks``, ``clamp_guess``,
``change_token``) are shared with the group's members.

The session cache of an int4 engine is fp8, as JAX's is
(``stream.py:161-168``; kept for token parity, ROADMAP §3).
"""
from __future__ import annotations

import threading
import time
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
    """The working buffers every tick graph of one pinned bucket reads and
    writes, for ``rows`` rows, and the owner whose state they hold: under
    ``("state", P, max_new, dtype)`` one row, a ``StreamSession``'s; under
    ``("gstate", P, max_new, slots, dtype)`` ``slots`` rows, a
    ``StreamGroup``'s pooled cache (``runtime/stream_group.py``). The
    resume loop (``ResumeLoop``, batch ``rows``) holds the working cache
    ``[L, rows, n_kv, s_pad, D]``, ``valid_from`` and the draft; ``audio``
    ``[rows, n_tok, H]`` holds the prompts' audio tokens, ``prefix``
    ``[rows, 64]`` the prefix ids, ``live`` ``[rows]`` which rows decode
    (a dead row's first token is EOS), ``maxes`` ``[rows, n_blocks]`` the
    blocks' raw maxes of this tick, and ``halo`` the reflect-padded
    samples of the window being encoded (one row's at a time). ``chunk``
    (the continuation) is built here, before any owner holds the buffers:
    a build runs its function once, and a chunk is not idempotent. The
    tick fronts (``front``) are built on first use: a front run twice is
    a front run once."""

    def __init__(self, engine, plan: BucketPlan, key: tuple):
        dev = engine.device
        cfg = engine.model.cfg
        self.engine, self.plan, self.key = engine, plan, key
        self.cache_dtype = cache_dtype = key[-1]
        self.rows = rows = key[3] if key[0] == "gstate" else 1
        self.loop = ResumeLoop(
            engine.model.params["decoder"], cfg.decoder, rows,
            plan.prompt_len, plan.max_new, eos_id=engine.model.eos_id,
            pad_id=engine.model.pad_id, cache_dtype=cache_dtype, device=dev)
        self.prefix = torch.zeros((rows, plan.prefix_budget),
                                  dtype=torch.int32, device=dev)
        self.audio = torch.zeros((rows, sum(plan.block_tokens),
                                  cfg.encoder.output_dim),
                                 dtype=engine.dtype, device=dev)
        self.halo = torch.zeros(plan.pinned_samples + N_FFT,
                                dtype=torch.float32, device=dev)
        self.maxes = torch.zeros((rows, len(plan.spans)),
                                 dtype=torch.float32, device=dev)
        self.live = torch.ones(rows, dtype=torch.bool, device=dev)
        self.owner = None
        self.lock = threading.Lock()
        self.handovers = 0        # owner changes that copied a state in/out
        self.copied_bytes = 0
        self.fronts: Dict[int, Graph] = {}
        self.chunk = Graph(self.loop.chunk, dev, engine.graph_pool)

    def front_key(self, seg_start: int) -> tuple:
        """The engine's key of this workspace's front at ``seg_start``."""
        kind = "gtick" if self.key[0] == "gstate" else "tick"
        return (kind, seg_start) + self.key[1:]

    # -- the working state ---------------------------------------------------
    def state_tensors(self) -> List[torch.Tensor]:
        """What an owner keeps between ticks: its cache and audio
        tokens."""
        return [x for x in self.loop.cache if x is not None] + [self.audio]

    def state_bytes(self) -> int:
        return sum(x.nbytes for x in self.state_tensors())

    def nbytes(self) -> int:
        return (self.loop.nbytes() + self.prefix.nbytes + self.audio.nbytes
                + self.halo.nbytes + self.maxes.nbytes + self.live.nbytes)

    def acquire(self, owner) -> None:
        """Make ``owner`` (a session or a group: ``has_state()`` and
        ``stored``) the owner: the old owner's state (if it has one) is
        copied out to its own buffers, and ``owner``'s copied in (if it
        was stashed). A lone owner never copies."""
        with self.lock:
            old = self.owner
            if old is owner:
                return
            copied = False
            if old is not None and old.has_state():
                if old.stored is None:
                    old.stored = [torch.empty_like(x)
                                  for x in self.state_tensors()]
                for dst, src in zip(old.stored, self.state_tensors()):
                    dst.copy_(src)
                copied = True
            if owner.has_state():
                if owner.stored is None:
                    raise RuntimeError("a stream owner with state owns "
                                       "neither the workspace nor a copy")
                for dst, src in zip(self.state_tensors(), owner.stored):
                    dst.copy_(src)
                copied = True
            if copied:
                self.handovers += 1
                self.copied_bytes += self.state_bytes() * (
                    int(old is not None and old.has_state())
                    + int(owner.has_state()))
            self.owner = owner

    def drop(self, owner) -> None:
        """``owner`` no longer counts on the working buffers."""
        with self.lock:
            if self.owner is owner:
                self.owner = None

    # -- the tick ------------------------------------------------------------
    def load_rows(self, prefix: np.ndarray, valid_from: np.ndarray,
                  prev: np.ndarray, prev_len: np.ndarray,
                  live: np.ndarray) -> None:
        """Every row's inputs, host to device: the prefix ids [rows, 64],
        ``valid_from`` [rows], the draft [rows, max_new] and its length
        [rows], and which rows decode [rows]."""
        loop = self.loop
        self.prefix.copy_(torch.from_numpy(prefix))
        loop.valid_from.copy_(torch.from_numpy(valid_from))
        loop.prev_tokens.copy_(torch.from_numpy(prev))
        loop.prev_len.copy_(torch.from_numpy(prev_len))
        self.live.copy_(torch.from_numpy(live))

    def encode(self, row: int, window: np.ndarray, blocks: List[int],
               clamp: float, eager: bool = False) -> None:
        """Encode ``blocks`` of ``window`` (f32 samples, at most the
        bucket) at clamp max ``clamp`` into row ``row``'s audio tokens and
        raw maxes, through the shared ``("encode", frames)`` encoders."""
        if not blocks:
            return
        eng, plan = self.engine, self.plan
        padded = np.zeros(plan.pinned_samples, np.float32)
        padded[:len(window)] = window
        self.halo.copy_(torch.from_numpy(
            np.pad(padded, N_FFT // 2, mode="reflect")))
        for b in blocks:
            lo, hi = plan.spans[b]
            enc = eng._stream_fn(("encode", hi - lo))
            enc.seg.copy_(self.halo[lo * HOP_LENGTH:
                                    (hi - 1) * HOP_LENGTH + N_FFT])
            enc.clamp.fill_(clamp)
            if eager:
                enc._run()
            else:
                enc.graph()
            off = plan.block_offsets[b]
            self.audio[row, off:off + plan.block_tokens[b]].copy_(
                enc.tokens[0])
            self.maxes[row, b].copy_(enc.raw_max)

    def run_front(self, seg_start: int) -> None:
        """The segment prefill of every row's prompt [prefix | audio |
        suffix] from ``seg_start`` on the working cache (positions
        seg_start..P-1, causal at q_offset = seg_start, each row from its
        ``valid_from``), the first token (EOS for a dead row, so it cannot
        hold the shared loop open: JAX's ``stream_group.py:416-419``), then
        resume's verify window and accept arithmetic
        (``ResumeLoop.verify``)."""
        eng, loop = self.engine, self.loop
        params, cfg = eng.model.params["decoder"], eng.model.cfg.decoder
        pre = embed_tokens(params, self.prefix.long(), cfg)
        suf = embed_tokens(params, eng._suffix[None, :], cfg).expand(
            self.rows, -1, -1)
        prompt = torch.cat([pre.to(eng.dtype), self.audio,
                            suf.to(eng.dtype)], dim=1)      # [rows, P, H]
        seg = prompt[:, seg_start:]
        positions = torch.arange(seg_start, loop.prompt_len,
                                 device=prompt.device).expand(self.rows, -1)
        spec = AttnSpec(causal=True, q_offset=seg_start,
                        valid_from=loop.valid_from)
        hidden, _ = decoder_forward(params, cfg, seg, positions, loop.cache,
                                    seg_start, spec)
        first = lm_logits(params, cfg, hidden[:, -1]).argmax(-1).to(
            torch.int32)
        first = torch.where(self.live, first,
                            torch.full_like(first, eng.model.eos_id))
        loop.verify(first)

    def front(self, seg_start: int) -> Graph:
        g = self.fronts.get(seg_start)
        if g is None:
            g = Graph(lambda: self.run_front(seg_start), self.engine.device,
                      self.engine.graph_pool)
            self.fronts[seg_start] = g
        return g

    def run(self, seg_start: int, eager: bool = False):
        """The tick's decoder work on the loaded rows: the front at
        ``seg_start``, then chunks while a row is live; then ONE host read
        of every row's tokens and length and the blocks' raw maxes.
        Returns (tokens [rows, max_new], lengths [rows], maxes [rows,
        n_blocks] f32, chunks run)."""
        loop = self.loop
        if eager:
            chunks = run_loop(lambda: self.run_front(seg_start), loop.chunk,
                              loop.active)
        else:
            front = self.engine._stream_fn(self.front_key(seg_start))
            chunks = run_loop(front, self.chunk, loop.active)
        lengths = (loop.tokens != loop.pad_id).sum(-1).to(torch.int32)
        host = torch.cat([loop.tokens.flatten(), lengths,
                          self.maxes.flatten().view(torch.int32)]
                         ).cpu().numpy()
        n_tok = self.rows * loop.max_new
        tokens = host[:n_tok].reshape(self.rows, loop.max_new)
        lengths = host[n_tok:n_tok + self.rows]
        maxes = host[n_tok + self.rows:].view(np.float32).reshape(
            self.rows, -1)
        return tokens, lengths, maxes, chunks

    def graphs(self) -> List[Graph]:
        return [self.chunk] + list(self.fronts.values())


# -- a tick's plan, shared by the session and the group's members -----------------

def diff_blocks(plan: BucketPlan, window: np.ndarray,
                prev_window: np.ndarray, encoded: List[bool]) -> List[int]:
    """The blocks a tick encodes against the previous tick's window: those
    the new samples reach, those a shrunk window must encode as zeros
    again, and those never encoded (before the clamp max is considered)."""
    n, m = len(window), len(prev_window)
    lim = min(m, n)
    neq = np.nonzero(window[:lim] != prev_window[:lim])[0]
    common = int(neq[0]) if len(neq) else lim
    first_changed = max(0, min(common, m - FIR_HALO))

    # STFT frames overlap (N_FFT > hop): a changed sample reaches frames
    # N_FFT / 2 samples away on BOTH sides, so the block before an edge
    # and the block after it can read it.
    block_of = plan.block_of_sample
    frontier_block = block_of(
        min(max(n - 1, 0) + N_FFT // 2, plan.pinned_samples - 1))
    first_block = block_of(max(0, first_changed - N_FFT // 2))
    changed = list(range(first_block, frontier_block + 1))
    # A chunk-quantized trim can SHRINK the window across a block edge:
    # blocks between the new and the old frontier still hold trimmed-out
    # audio where the fused path sees zeros. Encode them again from the
    # zero-padded signal (past the old frontier a block is unencoded or
    # already encodes zeros).
    if m:
        prev_frontier = block_of(
            min(m - 1 + N_FFT // 2, plan.pinned_samples - 1))
        changed += [b for b in range(frontier_block + 1, prev_frontier + 1)
                    if encoded[b]]
    missing = [b for b in range(len(plan.spans))
               if not encoded[b] and b not in changed]
    return sorted(set(changed) | set(missing))


def clamp_guess(block_max: np.ndarray) -> float:
    """The optimistic clamp max: the best known one (a changed block's
    stored max is stale, but still the best prior); the fetched maxes
    prove it or refute it."""
    known = [mx for mx in block_max if np.isfinite(mx)]
    return max(max(known) if known else -10.0, -10.0)


def true_max(block_max: np.ndarray) -> float:
    """The window's proven clamp max, once every block's max is known."""
    return max(float(np.max(block_max)), -10.0)


def change_token(plan: BucketPlan, changed: List[int],
                 prefix_filled: bool) -> int:
    """The first stale decoder position; the prefix's keys (< 64) survive
    trims and clamp changes, and only a new or reset session lacks
    them."""
    if not prefix_filled:
        return 0
    first_stale = changed[0] if changed else len(plan.spans)
    return plan.prefix_budget + sum(plan.block_tokens[:first_stale])


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
        self.engine.last_used = time.time()   # the idle watchdog's clock
        if n > self.pinned_samples:
            window = window[-self.pinned_samples:]
        self.stats["ticks"] += 1
        changed = diff_blocks(self.plan, window, self.prev_window,
                              self.encoded)
        guess = clamp_guess(self.block_max)
        if self.clamp_max is None or guess != self.clamp_max:
            changed = list(range(len(self.spans)))  # every block is stale
        change_tok = change_token(self.plan, changed, self._prefix_filled)
        seg_start = max(s for s in self.seg_starts if s <= change_tok)

        ids = self._run(window, changed, guess, seg_start)
        proven = true_max(self.block_max)
        if proven != guess:
            # A new frame raised the window's max (or the block that held
            # it was trimmed out): redo with the proven max, every block.
            self.stats["redo"] += 1
            ids = self._run(window, list(range(len(self.spans))), proven,
                            self.plan.prefix_budget)
        self._prefix_filled = True
        self.clamp_max = proven

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
        work = self.work
        prev = np.full((1, self.max_new), self.model.pad_id, np.int32)
        usable = self.prev_tokens[:self.max_new]
        prev[0, :len(usable)] = usable
        work.acquire(self)
        try:
            # inputs first (host to device), then the launches
            work.load_rows(self.prefix, self.valid_from, prev,
                           np.array([len(usable)], np.int32),
                           np.ones(1, np.bool_))
            work.encode(0, window, changed, clamp, self.eager)
            for b in changed:
                self.encoded[b] = True
            tokens, lengths, maxes, chunks = work.run(seg_start, self.eager)
            self.stats["full" if seg_start == 0 else "tail"] += 1
        except Exception:
            # the working buffers and the session's state are no longer
            # to be trusted: the next tick rebuilds from scratch
            self.reset()
            work.drop(self)
            raise
        for b in changed:
            self.block_max[b] = float(maxes[0, b])
        self.last_run = {"seg_start": seg_start, "changed": len(changed),
                         "chunks": chunks}
        return strip_generation(tokens[0], int(lengths[0]),
                                self.model.eos_id)


# -- engine-level executables (shared by every session and group) ---------------

def build_stream_fn(engine, key, plan: Optional[BucketPlan] = None):
    """What the engine memoizes under ``key`` (``engine._stream_fn``):
    ``("encode", frames)`` a ``BlockEncoder``; ``("state", P, max_new,
    dtype)`` a session's ``StreamWorkspace`` and ``("gstate", P, max_new,
    slots, dtype)`` a group's (``plan`` given); ``("tick", seg_start, P,
    max_new, dtype)`` and ``("gtick", seg_start, P, max_new, slots,
    dtype)`` that workspace's front graph at ``seg_start``."""
    kind = key[0]
    if kind == "encode":
        return BlockEncoder(engine, key[1])
    if kind in ("state", "gstate"):
        if plan is None:
            raise KeyError(f"{key}: a workspace is built from its plan")
        return StreamWorkspace(engine, plan, key)
    if kind in ("tick", "gtick"):
        state = ("gstate" if kind == "gtick" else "state",) + key[2:]
        return engine._stream_fns[state].front(key[1])
    raise KeyError(key)


def warm_stream_keys(engine, cap_s: float,
                     slots: Optional[int] = None) -> List[tuple]:
    """Build every executable a session at ``cap_s`` (with ``slots``: a
    group of that many slots) can reach (each block shape's encoder, the
    workspace with its chunk graph, each rung's front) and return their
    keys. Nothing runs but each build's own run."""
    plan = BucketPlan(engine, cap_s)
    dtype = session_cache_dtype(engine)
    keys = [("encode", f) for f in sorted({hi - lo for lo, hi in
                                           plan.spans})]
    if slots is None:
        keys.append(("state", plan.prompt_len, plan.max_new, dtype))
        keys += [("tick", s, plan.prompt_len, plan.max_new, dtype)
                 for s in plan.seg_starts]
    else:
        keys.append(("gstate", plan.prompt_len, plan.max_new, slots, dtype))
        keys += [("gtick", s, plan.prompt_len, plan.max_new, slots, dtype)
                 for s in plan.seg_starts]
    for key in keys:
        engine._stream_fn(key, plan)
    return keys
