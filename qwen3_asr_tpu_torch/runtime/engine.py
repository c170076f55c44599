"""TranscriptionEngine: bucketed, batched ASR inference in PyTorch.

Counterpart of ``qwen3_asr_tpu/runtime/engine.py`` for the batch
transcription path: audio is zero-padded to a length bucket, log-mel and
the encoder run on the padded bucket, the prompt is a PREFIX_BUDGET-token
left-padded prefix + the audio embeddings + the suffix, and greedy decoding
produces the tokens. Audio longer than MAX_SEGMENT_S is split at the
quietest 25 ms frame near each window's end, and same-bucket segments run
as one batch.

Each (bucket_frames, max_new, batch, cache dtype) owns a
``BucketExecutable``, the counterpart of the JAX engine's fused executable
per bucket (``_fused_fn``): persistent input buffers, the greedy loop's
state and its KV cache, and on the card two CUDA graphs (everything up to
the first token; a chunk of decode steps), so a warm request is a copy in,
a few replays and a copy out. ``warmup`` builds them at load.

Resume decoding (``runtime/resume.py``) has keys of its own, (bucket_frames,
max_new, batch, cache dtype, "resume"): the front graph adds the verify
window and the accept arithmetic, the chunk graph is the per-row
continuation, and the previous tokens are input buffers. A streaming
session's tick takes it with ``transcribe(..., resume_tokens=...)`` and a
cross-session tick batch with ``_run_bucket(..., resume_rows=...)``.

``transcribe(..., return_timestamps=True)`` adds word timestamps to each
segment's result: the forced aligner's (``sidecars/aligner.py``) when one
is loaded, else char-proportional estimates, offset by the segment's start
and rounded to ms, as the JAX engine gives them.

The prefix-cached WS modes (``runtime/stream.py``,
``runtime/stream_group.py``) have executables of their own, shared by
every session and group: ``stream_session`` binds a session,
``stream_group_member`` a member of a group (``_stream_groups``, by
bucket), and ``_stream_fn`` memoizes their keys (``("encode", frames)``,
``("state", P, max_new, dtype)``, ``("tick", seg_start, P, max_new,
dtype)``, ``("gstate", P, max_new, slots, dtype)``, ``("gtick",
seg_start, P, max_new, slots, dtype)``).

Token-level speculative decoding (``runtime/speculative.py``):
``attach_draft`` takes a second model (the fast engine's) as the draft,
and while it is attached every non-resume dispatch takes a spec key,
(bucket_frames, max_new, batch, cache dtype, "spec", γ), whatever its
batch: both encoders, each through its own model's mel frontend, both
prompts from the same prefix ids, and a ``SpecLoop``, in two graphs as
any key. The tokens are the plain key's; only the verifier's forwards
change. AOT caches and meshes are not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.frontend import HOP_LENGTH, LogMelFrontend
from ..audio.resample import resample
from ..models.asr import AsrModel, normalize_language
from ..models.decoder import embed_tokens
from ..models.encoder import encoder_forward, encoder_output_length
from ..ops.attention import decode_kernel
from ..ops.quant import (any_quantized, check_int4_layouts,
                         check_quantized_dtype, param_bytes)
from ..utils.device import resolve_device, working_dtype
from .batcher import _pad_pow2
from .generate import GreedyLoop, cache_length, run_loop, strip_generation
from .graphs import Graph
from .resume import ResumeLoop
from .speculative import SpecLoop

log = logging.getLogger(__name__)

TARGET_SR = 16000
AUDIO_BUCKETS_S: Tuple[float, ...] = (1, 2, 4, 6, 10, 15, 20, 30)
PREFIX_BUDGET = 64          # left-padded prompt prefix tokens
MAX_SEGMENT_S = 30.0        # beyond this, silence-boundary chunking


def long_form_batch() -> int:
    """Most same-bucket segments per long-form run: ``ASR_LONG_FORM_BATCH``
    (default 8) floored to a power of two, as the JAX engine reads it."""
    cap = int(os.getenv("ASR_LONG_FORM_BATCH", "8"))
    return 1 << (max(1, cap).bit_length() - 1)


@dataclasses.dataclass
class TranscriptionResult:
    text: str
    language: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    token_ids: Optional[List[int]] = None
    timestamps: Optional[List[dict]] = None


def max_new_tokens_for(seconds: float) -> int:
    """Token budget per bucket: generous for dense CJK speech (~8 tok/s)."""
    return int(16 + 8 * seconds)


def spec_gamma() -> int:
    """``ASR_SPEC_GAMMA`` (default 4), the drafts a round; below 2 it warns
    and takes 2, as the JAX engine does (``engine.py:429-433``)."""
    gamma = int(os.getenv("ASR_SPEC_GAMMA", "4"))
    if gamma < 2:
        log.warning("ASR_SPEC_GAMMA=%d below the minimum; using 2 (the "
                    "verify pass needs >=2 positions)", gamma)
        gamma = 2
    return gamma


class BucketExecutable:
    """One key's executable: audio [B, n_samples] f32, prefix ids [B,
    PREFIX_BUDGET] and valid_from [B] as persistent input buffers, a
    ``GreedyLoop`` (state and KV cache, allocated here and reused by every
    request of the key), and two ``Graph``s: ``front`` (frontend, encoder,
    prompt, prefill, the first token; kernel #1) and ``chunk`` (decode
    steps; kernels #2 and #3). With ``resume`` the loop is a
    ``ResumeLoop``: the front adds the verify window (flash at T =
    max_new) and the accept arithmetic, the chunk is the per-row
    continuation (kernel B's per-row write, #2 or #3 with a per-row
    ``valid_to``), and ``prev_tokens``/``prev_len`` are inputs too. Build
    it under inference mode."""

    def __init__(self, engine: "TranscriptionEngine", bucket_frames: int,
                 max_new: int, batch: int, resume: bool = False):
        dev = engine.device
        self.engine, self.bucket_frames = engine, bucket_frames
        self.resume = resume
        self.audio = torch.zeros((batch, bucket_frames * HOP_LENGTH),
                                 dtype=torch.float32, device=dev)
        self.prefix = torch.zeros((batch, PREFIX_BUDGET), dtype=torch.int32,
                                  device=dev)
        self.loop = self._new_loop(batch, max_new)
        self.front = Graph(self._front, dev, engine.graph_pool)
        self.chunk = Graph(self.loop.chunk, dev, engine.graph_pool)

    def _new_loop(self, batch: int, max_new: int):
        eng = self.engine
        return (ResumeLoop if self.resume else GreedyLoop)(
            eng.model.params["decoder"], eng.model.cfg.decoder, batch,
            eng.prompt_length(self.bucket_frames), max_new,
            eos_id=eng.model.eos_id, pad_id=eng.model.pad_id,
            cache_dtype=eng.cache_dtype, device=eng.device)

    def nbytes(self) -> int:
        """Bytes of the key's persistent tensors: input buffers, loop state
        and KV cache (the graphs' pool is not counted)."""
        return (self.audio.nbytes + self.prefix.nbytes
                + self.loop.nbytes())

    def _front(self) -> None:
        self.loop.prefill(self.engine.prompt_embeds(
            self.audio, self.prefix, self.bucket_frames))

    @torch.inference_mode()
    def run(self, audio: np.ndarray, prefix: np.ndarray,
            valid_from: np.ndarray, eager: bool = False,
            prev: Optional[np.ndarray] = None,
            prev_len: Optional[np.ndarray] = None):
        """Copy the inputs in (a resume key's draft too: ``prev``
        [B, max_new] int32, ``prev_len`` [B]), replay ``front`` and then
        ``chunk`` until no row is active. ``eager`` runs the same functions
        without the graphs (on the card only to hold the graphs against
        them). Returns a ``GenerateResult``, or a resume key's
        ``ResumeResult``."""
        self.audio.copy_(torch.from_numpy(audio))
        self.prefix.copy_(torch.from_numpy(prefix))
        self._set_valid_from(torch.from_numpy(valid_from))
        if self.resume:
            self.loop.prev_tokens.copy_(torch.from_numpy(prev))
            self.loop.prev_len.copy_(torch.from_numpy(prev_len))
        if eager:
            chunks = run_loop(self._front, self.loop.chunk, self.loop.active)
        else:
            chunks = run_loop(self.front, self.chunk, self.loop.active)
        return self.loop.result(chunks)

    def _set_valid_from(self, valid_from: torch.Tensor) -> None:
        self.loop.valid_from.copy_(valid_from)


class SpecExecutable(BucketExecutable):
    """A spec key's executable: the plain key's input buffers, and a
    ``SpecLoop`` over the engine's model (the verifier) and its draft.
    ``front`` runs the mel frontend and encoder of each model (the draft's
    through its own frontend when its mel bins differ), both prompts from
    the one prefix buffer, both prefills and the verifier's first token;
    ``chunk`` runs ``rounds_per_chunk(γ)`` rounds (kernel #1 at the
    verify window's T = γ with a per-row ``q_offset``, #2 or #3 at the
    draft's steps, kernel B per row at T = 1 and T = γ). The draft's
    weights belong to the fast engine; the key is dropped with the
    engine, or when another draft is attached. Build it under inference
    mode."""

    def __init__(self, engine: "TranscriptionEngine", bucket_frames: int,
                 max_new: int, batch: int, gamma: int):
        self.draft, self.gamma = engine.draft_model, gamma
        super().__init__(engine, bucket_frames, max_new, batch)

    def _new_loop(self, batch: int, max_new: int) -> SpecLoop:
        eng, draft, verify = self.engine, self.draft, self.engine.model
        plen = eng.prompt_length(self.bucket_frames)
        return SpecLoop(
            draft.params["decoder"], verify.params["decoder"],
            draft.cfg.decoder, verify.cfg.decoder, batch, plen, plen,
            max_new, gamma=self.gamma, eos_id=verify.eos_id,
            pad_id=verify.pad_id, cache_dtype=eng.cache_dtype,
            device=eng.device)

    def _front(self) -> None:
        eng = self.engine
        self.loop.prefill(
            eng.prompt_embeds(self.audio, self.prefix, self.bucket_frames,
                              self.draft, eng.draft_frontend),
            eng.prompt_embeds(self.audio, self.prefix, self.bucket_frames))

    def _set_valid_from(self, valid_from: torch.Tensor) -> None:
        self.loop.valid_from_d.copy_(valid_from)
        self.loop.valid_from_v.copy_(valid_from)


class TranscriptionEngine:
    def __init__(self, model: AsrModel, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 cache_dtype: Optional[torch.dtype] = None):
        """``model.params`` must already be on ``device``. dtype defaults to
        bf16 on the card and f32 on the CPU. The KV cache is in
        ``cache_dtype``: the working dtype by default, fp8
        (``torch.float8_e4m3fn``) or int4 (``torch.int4``: packed values
        with per-(token, head) scales), both of which need head_dim 128;
        int4 on the card needs bf16, and so do quantized weights, whose
        int4 group layouts the card's kernels must take."""
        self.model = model
        self.model_id: Optional[str] = None     # set by load_engine
        self.load_parts: dict = {}   # load_engine's seconds by part
        self.device = resolve_device(device)
        self.dtype = dtype or working_dtype(self.device)
        self.cache_dtype = cache_dtype or self.dtype
        if self.cache_dtype not in (self.dtype, torch.float8_e4m3fn,
                                    torch.int4):
            raise ValueError(f"KV cache dtype {self.cache_dtype} is neither "
                             f"the working dtype {self.dtype} nor fp8 nor "
                             f"int4")
        if (self.cache_dtype == torch.int4 and self.device.type == "cuda"
                and self.dtype != torch.bfloat16):
            raise ValueError("an int4 KV cache on the card needs the bf16 "
                             "working dtype (kernel #3's int4 route)")
        if any_quantized(model.params):
            check_quantized_dtype(self.device, self.dtype)
            check_int4_layouts(model.params, self.device)
        # raises now for a cache no decode kernel takes, not mid-request
        decode_kernel(1, model.cfg.decoder.head_dim, 128, self.cache_dtype)
        self.frontend = LogMelFrontend(n_mels=model.cfg.encoder.num_mel_bins,
                                       device=self.device)
        self._chunk_frames = model.cfg.encoder.n_window * 2
        self._suffix = torch.tensor(
            model.tokenizer.encode(model.template.suffix_text()),
            dtype=torch.int64, device=self.device)
        # One executable per (bucket_frames, max_new, batch, cache dtype);
        # their graphs share one memory pool (one device thread replays
        # them, one at a time).
        self.executables: Dict[tuple, BucketExecutable] = {}
        self.graph_pool = (torch.cuda.graph_pool_handle()
                           if self.device.type == "cuda" else None)
        # the prefix-cached WS modes' executables (runtime/stream.py),
        # replayed on the same device thread, in the same graph pool
        self._stream_fns: Dict[tuple, object] = {}
        # the grouped mode's groups (runtime/stream_group.py), by bucket
        self._stream_groups: Dict[tuple, list] = {}
        # shapes and counts of the last bucket run (for measurement scripts)
        self.last_run: dict = {}
        self.stream_warmup: dict = {}   # the stream modes' keys and seconds
        # token-level speculation's draft (attach_draft), and its frontend
        self.draft_model: Optional[AsrModel] = None
        self.draft_frontend: Optional[LogMelFrontend] = None
        # the idle watchdog's clock: every dispatch stamps it
        self.last_used = time.time()

    @property
    def executable_count(self) -> int:
        """Keys built so far (the bucket keys and the stream keys) and the
        live stream groups, as JAX's ``engine.py:170-180`` counts them:
        serving a fixed set of shapes must hold it constant (each key
        holds its KV cache and loop state)."""
        return (len(self.executables) + len(self._stream_fns)
                + sum(len(g) for g in list(self._stream_groups.values())))

    def attach_draft(self, draft_model: AsrModel) -> None:
        """Token-level speculative decoding: ``draft_model`` (on this
        engine's device, in its dtype) proposes and this engine's model
        verifies; the tokens stay the verifier's greedy ones. Refused, as
        the JAX engine refuses (``engine.py:182-198``), when the two chunk
        the audio differently (AssertionError) or when their tokenizers
        give different prompt ids (ValueError): both prompts are built from
        one prefix buffer. Drops the spec keys of an earlier draft."""
        if draft_model.cfg.encoder.n_window != self.model.cfg.encoder.n_window:
            raise AssertionError("draft/verify chunking differs")
        probe = self.model.template.prefix_text("English", "probe context")
        if (draft_model.tokenizer.encode(probe)
                != self.model.tokenizer.encode(probe)):
            raise ValueError(
                "draft/verify tokenizers produce different prompt ids; "
                "token-level speculative decoding requires shared token ids")
        n_mels = draft_model.cfg.encoder.num_mel_bins
        self.draft_frontend = (
            self.frontend if n_mels == self.frontend.n_mels
            else LogMelFrontend(n_mels=n_mels, device=self.device))
        self.draft_model = draft_model
        self.executables = {k: v for k, v in self.executables.items()
                            if "spec" not in k}

    def held_bytes(self) -> int:
        """Bytes of the tensors the engine holds: its weights, every key's
        buffers, loop state and KV cache, and the stream groups' stashed
        state. Safe from another thread (``/health``) while the device
        thread adds a key."""
        return (param_bytes(self.model.params)
                + sum(x.nbytes() for x in list(self.executables.values()))
                + sum(x.nbytes() for x in list(self._stream_fns.values())
                      if hasattr(x, "nbytes"))
                + sum(g.held_bytes() for gs in
                      list(self._stream_groups.values()) for g in list(gs)))

    # -- bucketing ---------------------------------------------------------------
    def bucket_frames(self, n_samples: int) -> Tuple[int, float]:
        """Smallest bucket (mel frames, effective seconds) covering
        n_samples. Frames round up to the encoder chunk, and the seconds
        returned are that rounded coverage, so the token budget matches the
        audio the bucket holds."""
        mel_frames = max(1, n_samples // HOP_LENGTH)
        chunk = self._chunk_frames
        for sec in AUDIO_BUCKETS_S:
            frames = -(-int(sec * 100) // chunk) * chunk
            if mel_frames <= frames:
                return frames, frames / 100.0
        frames = -(-int(AUDIO_BUCKETS_S[-1] * 100) // chunk) * chunk
        return frames, frames / 100.0

    def padded_prefix_rows(self, languages: Sequence[Optional[str]],
                           context: str = ""
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """One language hint per row, in ``padded_prefix``'s shapes: the
        budget is fixed, so a tick batch of mixed languages shares one key
        (JAX ``engine.py:300``)."""
        rows = [self.padded_prefix(lang, context, 1) for lang in languages]
        return (np.concatenate([p for p, _ in rows], axis=0),
                np.concatenate([v for _, v in rows], axis=0))

    def padded_prefix(self, language: Optional[str], context: str = "",
                      batch: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """PREFIX_BUDGET-left-padded prompt prefix ids and valid_from."""
        prefix_ids, _, _ = self.model.prompt_ids(0, language, context)
        if len(prefix_ids) > PREFIX_BUDGET:
            prefix_ids = prefix_ids[-PREFIX_BUDGET:]
        pad_count = PREFIX_BUDGET - len(prefix_ids)
        prefix = np.full((batch, PREFIX_BUDGET), self.model.pad_id, np.int32)
        prefix[:, pad_count:] = prefix_ids
        valid_from = np.full((batch,), pad_count, np.int32)
        return prefix, valid_from

    def prompt_length(self, bucket_frames: int) -> int:
        """Prompt tokens of a bucket: prefix, audio tokens, suffix."""
        return (PREFIX_BUDGET + len(self._suffix)
                + encoder_output_length(bucket_frames, self._chunk_frames))

    def prompt_embeds(self, audio: torch.Tensor, prefix_ids: torch.Tensor,
                      bucket_frames: int, model: Optional[AsrModel] = None,
                      frontend: Optional[LogMelFrontend] = None
                      ) -> torch.Tensor:
        """[B, n_samples] f32 PCM on the device → [prefix, audio, suffix]
        inputs_embeds [B, prompt_length(bucket_frames), H]. Device work
        only (no host-to-device copy), so a CUDA graph can capture it.
        ``model`` and its ``frontend`` (the draft's) default to the
        engine's; the prefix and suffix ids are the same for both."""
        model = model or self.model
        cfg, params = model.cfg, model.params
        n_samples = bucket_frames * HOP_LENGTH
        mel, _ = (frontend or self.frontend)(audio, n_samples)
        b = audio.shape[0]
        flens = torch.full((b,), bucket_frames, dtype=torch.int32,
                           device=self.device)
        audio_embeds, _ = encoder_forward(params["encoder"], cfg.encoder,
                                          mel.to(self.dtype), flens)
        pre = embed_tokens(params["decoder"], prefix_ids.long())
        suf = embed_tokens(params["decoder"], self._suffix.expand(b, -1))
        return torch.cat([pre.to(self.dtype), audio_embeds.to(self.dtype),
                          suf.to(self.dtype)], dim=1)

    # -- executables ------------------------------------------------------------
    def executable(self, bucket_frames: int, max_new: int, batch: int,
                   resume: bool = False, gamma: Optional[int] = None
                   ) -> Tuple[BucketExecutable, float]:
        """The key's executable, built (its graphs captured, on the card)
        on first use; and the seconds this call spent building it. A resume
        key is the plain key with "resume" appended, a spec key (``gamma``
        set, a draft attached) the plain key with ("spec", γ)."""
        key = (bucket_frames, max_new, batch, self.cache_dtype)
        if resume:
            key += ("resume",)
        elif gamma is not None:
            key += ("spec", gamma)
        exe = self.executables.get(key)
        if exe is not None:
            return exe, 0.0
        t0 = time.perf_counter()
        with torch.inference_mode():
            exe = (SpecExecutable(self, bucket_frames, max_new, batch, gamma)
                   if gamma is not None else
                   BucketExecutable(self, bucket_frames, max_new, batch,
                                    resume))
        self.executables[key] = exe
        return exe, time.perf_counter() - t0

    # -- WS prefix caching (runtime/stream.py) ------------------------------------
    def _stream_fn(self, key: tuple, plan=None):
        """The stream executable of ``key``, built on first use and shared
        by every session (``runtime/stream.py`` ``build_stream_fn``)."""
        fn = self._stream_fns.get(key)
        if fn is None:
            from .stream import build_stream_fn
            fn = self._stream_fns[key] = build_stream_fn(self, key, plan)
        return fn

    def stream_session(self, cap_s: float, language: Optional[str] = None,
                       context: str = ""):
        """A WS connection's prefix-cached session at window cap ``cap_s``:
        encoder blocks and decoder keys persist across its ticks."""
        from .stream import StreamSession
        return StreamSession(self, cap_s, language, context)

    def stream_group_member(self, cap_s: float,
                            language: Optional[str] = None,
                            context: str = "", slots: Optional[int] = None):
        """A WS connection's member of a grouped prefix-cache session
        (``runtime/stream_group.py``): it joins a group of its bucket with
        a free slot, else starts a group of ``slots``
        (``ASR_WS_GROUP_SLOTS``, 8) rows."""
        from .stream_group import StreamGroup
        slots = slots or int(os.getenv("ASR_WS_GROUP_SLOTS", "8"))
        key = self.bucket_frames(int(cap_s * TARGET_SR))
        groups = self._stream_groups.setdefault(key, [])
        for g in groups:
            member = g.try_attach(language, context)
            if member is not None:
                return member
        group = StreamGroup(self, cap_s, slots)
        groups.append(group)
        return group.attach_or_raise(language, context)

    def _drop_stream_group_if_empty(self, group) -> None:
        """An emptied group leaves the registry (the next member of its
        bucket starts a fresh one) and drops its stashed state; its
        workspace stays an engine key (ROADMAP §3)."""
        if group.live_members == 0:
            for groups in self._stream_groups.values():
                if group in groups:
                    groups.remove(group)
                    break
            group.drop_state()

    def stream_graphs(self) -> List[Graph]:
        """Every graph of the stream executables (encoders, workspaces'
        chunks, tick fronts, the groups' included)."""
        return [g for fn in list(self._stream_fns.values())
                if hasattr(fn, "graphs") for g in fn.graphs()]

    def warmup(self, buckets: Optional[Sequence[float]] = None,
               language: Optional[str] = "en") -> None:
        """Build and run the executables of ``buckets`` (default: the
        smallest two) at B=1, and at each batch of
        ``ASR_WARMUP_BATCH_SHAPES`` ("2,4,8"), on 0.01-scale noise, as the
        JAX engine's ``warmup`` does; on the card the first run of a key
        captures its graphs and the warm-up request replays them once.

        Each bucket's resume key at B=1 too (a WS session's solo ticks and
        flushes decode with resume); then what the WS modes that
        ``config.ws_warmup_profile`` names can reach: under ``tick``, the
        batched resume keys at 2, 4, .. ``ASR_WS_TICK_MAX_BATCH`` for the
        buckets at or below ``WS_WINDOW_MAX_S``; and, for any WS mode, the
        plain keys of the flush bucket (the cap plus
        ``WS_FLUSH_SILENCE_MS``) at those batches, which concurrent finals
        reach through the micro-batcher. (JAX nests the last under
        ``tick``: ``ADVICE.md``'s first finding.) Under ``prefix``, every
        stream executable a session at the cap can reach (each block
        shape's encoder, each rung's tick front, the continuation), built
        directly rather than by pacing a throwaway session across the cap
        as JAX does (``engine.py:921-975``): the same keys, without the
        paced ticks' decode time. Under ``grouped``, the same for a group
        of ``ASR_WS_GROUP_SLOTS`` slots (its workspace and ``gtick``
        fronts), where JAX paces a 2-member throwaway group
        (``engine.py:934-959``); the ``auto`` policy at a long cap names
        both modes, and both are built. An unknown WS mode raises
        (``config.check_ws_modes``)."""
        from ..config import _safe_float, _safe_int, check_ws_modes
        modes = {m.name for m in check_ws_modes()}
        buckets = buckets or AUDIO_BUCKETS_S[:2]
        batch_shapes = [int(x) for x in
                        os.getenv("ASR_WARMUP_BATCH_SHAPES", "").split(",")
                        if x.strip()]
        rng = np.random.default_rng(42)

        def noise(sec):
            return (rng.standard_normal(int(TARGET_SR * sec))
                    .astype(np.float32) * 0.01)

        for sec in buckets:
            dummy = noise(sec)
            bf, bs = self.bucket_frames(len(dummy))
            self._run_bucket([dummy], bf, bs, language)
            self._run_bucket([dummy], bf, bs, language, resume_tokens=[])
            for batch in batch_shapes:
                self._run_bucket([dummy] * batch, bf, bs, language)
        cap = _safe_float("WS_WINDOW_MAX_S", "6.0")
        max_b = _safe_int("ASR_WS_TICK_MAX_BATCH", "8")
        shapes = [1 << i for i in range(1, max(1, max_b).bit_length())]
        if "tick" in modes:
            for sec in [s for s in buckets if s <= cap] or buckets[:1]:
                dummy = noise(sec)
                bf, bs = self.bucket_frames(len(dummy))
                for batch in shapes:
                    self._run_bucket([dummy] * batch, bf, bs, language,
                                     resume_rows=[None] * batch)
        if modes:
            flush_s = cap + _safe_int("WS_FLUSH_SILENCE_MS",
                                      "600") / 1000.0
            dummy = noise(flush_s)
            bf, bs = self.bucket_frames(len(dummy))
            for batch in shapes:
                self._run_bucket([dummy] * batch, bf, bs, language)
        if modes & {"prefix", "grouped"}:
            from .stream import warm_stream_keys
            t0 = time.perf_counter()
            keys = []
            if "prefix" in modes:
                keys += warm_stream_keys(self, cap)
            if "grouped" in modes:
                slots = _safe_int("ASR_WS_GROUP_SLOTS", "8")
                keys += [k for k in warm_stream_keys(self, cap, slots)
                         if k not in keys]
            self.stream_warmup = {"keys": keys,
                                  "seconds": time.perf_counter() - t0}

    # -- core batched path --------------------------------------------------------
    def bucket_inputs(self, clips: Sequence[np.ndarray], bucket_frames: int,
                      language: Optional[str], context: str = ""
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """An executable's inputs for clips ≤ the bucket: audio [B,
        n_samples] f32 (s16 clips scaled by 2^-15, exactly), the prefix ids
        and valid_from."""
        n_samples = bucket_frames * HOP_LENGTH
        audio = np.zeros((len(clips), n_samples), dtype=np.float32)
        for i, clip in enumerate(clips):
            c = clip[:n_samples]
            if c.dtype == np.int16:
                c = c.astype(np.float32) / 32768.0
            audio[i, :len(c)] = c
        return (audio,) + self.padded_prefix(language, context, len(clips))

    def _run_bucket(self, clips: Sequence[np.ndarray], bucket_frames: int,
                    bucket_s: float, language: Optional[str],
                    context: str = "",
                    resume_tokens: Optional[Sequence[int]] = None,
                    resume_rows: Optional[Sequence[
                        Optional[Sequence[int]]]] = None,
                    language_rows: Optional[Sequence[Optional[str]]] = None
                    ) -> Tuple[List[str], List[List[int]]]:
        """All clips already ≤ bucket. Returns (texts, token_id_lists).

        ``resume_tokens``: one stream's previous tokens (batch 1, a resume
        key). ``resume_rows``: each row's previous tokens (None: no draft)
        for a cross-session tick batch. ``language_rows``: one language per
        row, in place of ``language``. With a draft attached, every
        dispatch that is not a resume takes the spec key, at any batch."""
        self.last_used = time.time()
        try:
            return self._run_key(clips, bucket_frames, bucket_s, language,
                                 context, resume_tokens, resume_rows,
                                 language_rows)
        finally:
            self.last_used = time.time()

    def _run_key(self, clips, bucket_frames, bucket_s, language, context,
                 resume_tokens, resume_rows, language_rows):
        batch = len(clips)
        max_new = max_new_tokens_for(bucket_s)
        if resume_rows is None and resume_tokens is not None and batch == 1:
            resume_rows = [resume_tokens]
        if resume_rows is not None and len(resume_rows) != batch:
            raise ValueError(f"{len(resume_rows)} resume rows for {batch} "
                             f"clips")
        resume = resume_rows is not None
        gamma = (spec_gamma() if not resume and self.draft_model is not None
                 else None)
        exe, capture_s = self.executable(bucket_frames, max_new, batch,
                                         resume, gamma)
        audio, prefix, valid_from = self.bucket_inputs(clips, bucket_frames,
                                                       language, context)
        if language_rows is not None:
            if len(language_rows) != batch:
                raise ValueError(f"{len(language_rows)} languages for "
                                 f"{batch} clips")
            prefix, valid_from = self.padded_prefix_rows(language_rows,
                                                         context)
        prev = prev_len = None
        if resume:
            prev = np.full((batch, max_new), self.model.pad_id, np.int32)
            prev_len = np.zeros(batch, np.int32)
            for i, row in enumerate(resume_rows):
                usable = list(row or [])[:max_new]
                prev[i, :len(usable)] = usable
                prev_len[i] = len(usable)
        replays = exe.front.replays + exe.chunk.replays
        result = exe.run(audio, prefix, valid_from, prev=prev,
                         prev_len=prev_len)
        tokens = result.tokens.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        prompt_len = exe.loop.prompt_len
        self.last_run = {"batch": batch, "bucket_frames": bucket_frames,
                         "prompt_len": prompt_len,
                         "cache_len": (exe.loop.cache_v.k.shape[-2]
                                       if gamma is not None else
                                       cache_length(prompt_len, max_new)),
                         "max_new": max_new, "resume": resume,
                         "steps_run": result.steps_run,
                         "replays": (exe.front.replays + exe.chunk.replays
                                     - replays),
                         "capture_s": capture_s,
                         "generated": int(lengths.sum())}
        if resume:
            # per row: the draft tokens the verify pass accepted, and the
            # decode steps past them
            self.last_run.update(accepted=result.accepted.tolist(),
                                 steps=result.steps.tolist())
        else:
            self.last_run["steps"] = result.steps
        if gamma is not None:
            # the verifier's rounds, and the tokens a row gained a round
            # past the prefill's first (at most γ)
            rounds = result.steps
            self.last_run.update(
                spec=True, gamma=gamma, rounds=rounds,
                tokens_per_round=(float(np.clip(lengths - 1, 0, None).sum())
                                  / (batch * rounds) if rounds else 0.0))
        texts, id_lists = [], []
        for i in range(batch):
            ids = strip_generation(tokens[i], int(lengths[i]),
                                   self.model.eos_id)
            texts.append(self.model.tokenizer.decode(ids).strip())
            id_lists.append(ids)
        return texts, id_lists

    # -- segmentation ---------------------------------------------------------------
    @staticmethod
    def _split_long_audio(audio: np.ndarray, max_samples: int,
                          search_s: float = 5.0) -> List[Tuple[int, np.ndarray]]:
        """Split at the lowest-energy 25 ms frame within the last
        ``search_s`` seconds of each max-length window."""
        if len(audio) <= max_samples:
            return [(0, audio)]
        segments = []
        start = 0
        search = int(search_s * TARGET_SR)
        frame = 400
        while len(audio) - start > max_samples:
            hi = start + max_samples
            lo = max(start + 1, hi - search)
            window = audio[lo:hi].astype(np.float32)  # int16² would overflow
            n_frames = max(1, len(window) // frame)
            frames = window[:n_frames * frame].reshape(n_frames, frame)
            energies = np.sqrt(np.mean(frames ** 2, axis=1))
            cut = lo + int(np.argmin(energies)) * frame + frame // 2
            segments.append((start, audio[start:cut]))
            start = cut
        segments.append((start, audio[start:]))
        return segments

    # -- public API -------------------------------------------------------------------
    def transcribe(self, audio: np.ndarray, sr: int,
                   language: Optional[str] = None,
                   return_timestamps: bool = False,
                   context: str = "",
                   resume_tokens: Optional[Sequence[int]] = None
                   ) -> List[TranscriptionResult]:
        """One clip of any length → one result per segment.

        ``return_timestamps``: each segment with text gets its word
        timestamps (``_word_timestamps``). ``resume_tokens``: the previous
        streaming tick's token ids, which a resume key verifies as a
        self-draft (single-segment audio only; the first ``max_new`` are
        used). The tokens equal a plain run's."""
        audio = _prep_audio(audio, sr)
        if len(audio) == 0:
            return []
        lang_code, _ = normalize_language(language)
        segments = self._split_long_audio(audio,
                                          int(MAX_SEGMENT_S * TARGET_SR))
        if len(segments) == 1:
            seg = segments[0][1]
            bucket_frames, bucket_s = self.bucket_frames(len(seg))
            texts, id_lists = self._run_bucket([seg], bucket_frames, bucket_s,
                                               language, context,
                                               resume_tokens=resume_tokens)
        else:
            texts, id_lists = self._run_segments_batched(segments, language,
                                                         context)
        results = []
        for (seg_start, seg), text, token_ids in zip(segments, texts,
                                                     id_lists):
            start_t = seg_start / TARGET_SR
            end_t = (seg_start + len(seg)) / TARGET_SR
            res = TranscriptionResult(
                text=text, language=_response_language(text, lang_code),
                start_time=start_t, end_time=end_t, token_ids=token_ids)
            if return_timestamps and text:
                res.timestamps = _word_timestamps(seg, text, start_t, end_t,
                                                  res.language)
            results.append(res)
        return results

    def _run_segments_batched(self, segments, language, context):
        """Long-form path: same-bucket segments share batches of up to
        ``long_form_batch()`` rows (padded to a power of two). Rows are
        independent, so each segment's output matches the batch-1 path."""
        cap = long_form_batch()
        by_bucket = {}
        for idx, (_, seg) in enumerate(segments):
            by_bucket.setdefault(self.bucket_frames(len(seg)), []).append(idx)
        texts: List[Optional[str]] = [None] * len(segments)
        id_lists: List[Optional[List[int]]] = [None] * len(segments)
        for (bf, bs), idxs in by_bucket.items():
            for off in range(0, len(idxs), cap):
                chunk = idxs[off:off + cap]
                clips = [segments[i][1] for i in chunk]
                _pad_pow2(clips, dtype=clips[0].dtype)
                t, il = self._run_bucket(clips, bf, bs, language, context)
                for j, i in enumerate(chunk):
                    texts[i], id_lists[i] = t[j], il[j]
        return texts, id_lists

    def transcribe_batch(self, clips: Sequence[Tuple[np.ndarray, int]],
                         language: Optional[str] = None
                         ) -> List[TranscriptionResult]:
        """Batch same-bucket clips (each ≤ MAX_SEGMENT_S) into single runs."""
        prepped = [_prep_audio(audio, sr) for audio, sr in clips]
        max_samples = int(MAX_SEGMENT_S * TARGET_SR)
        too_long = [i for i, a in enumerate(prepped) if len(a) > max_samples]
        if too_long:
            raise ValueError(
                f"clips {too_long} exceed MAX_SEGMENT_S={MAX_SEGMENT_S}s — "
                "use transcribe() (silence-boundary segmentation) for long "
                "audio")
        lang_code, _ = normalize_language(language)
        by_bucket = {}
        for idx, audio in enumerate(prepped):
            by_bucket.setdefault(self.bucket_frames(len(audio)), []).append(idx)
        out: List[Optional[TranscriptionResult]] = [None] * len(prepped)
        for (bf, bs), idxs in by_bucket.items():
            texts, id_lists = self._run_bucket([prepped[i] for i in idxs], bf,
                                               bs, language)
            for i, text, ids in zip(idxs, texts, id_lists):
                out[i] = TranscriptionResult(
                    text=text, language=_response_language(text, lang_code),
                    start_time=0.0, end_time=len(prepped[i]) / TARGET_SR,
                    token_ids=ids)
        return out  # type: ignore[return-value]


def _prep_audio(audio, sr: int) -> np.ndarray:
    """Mono 16 kHz s16 PCM stays int16; everything else becomes mono
    float32 at TARGET_SR."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16 and audio.ndim == 1 and sr == TARGET_SR:
        return audio
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    else:
        audio = audio.astype(np.float32, copy=False)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if sr != TARGET_SR:
        audio = resample(audio, sr, TARGET_SR)
    return audio


def _response_language(text: str, lang_code: Optional[str]) -> str:
    """Explicit language echoes back; language=auto runs script-based
    detection on the produced text."""
    if lang_code:
        return lang_code
    if text:
        from ..text.langid import detect_language
        return detect_language(text) or "auto"
    return "auto"


def _word_timestamps(seg_audio: np.ndarray, text: str, start_t: float,
                     end_t: float, language: str) -> List[dict]:
    """Word timing of one segment: the forced aligner's when it is loaded,
    char-proportional estimates otherwise and when the alignment fails
    (logged and counted in ``sidecars.subtitle.failures``)."""
    from ..sidecars import subtitle
    if subtitle.aligner_loaded():
        try:
            words = subtitle.align_audio(seg_audio, TARGET_SR, text, language)
            if words:
                return [{"word": w.text,
                         "start": round(w.start + start_t, 3),
                         "end": round(w.end + start_t, 3)} for w in words]
        except Exception:  # alignment must never fail the request
            subtitle.count_failure("word timestamps")
    return _estimate_word_timestamps(text, start_t, end_t)


def _estimate_word_timestamps(text: str, start_t: float, end_t: float
                              ) -> List[dict]:
    """Char-proportional word timing over the segment."""
    words = text.split()
    if not words:
        return []
    total_chars = sum(len(w) for w in words) + len(words) - 1
    dur = max(end_t - start_t, 1e-3)
    out = []
    pos = 0
    for w in words:
        w_start = start_t + dur * pos / max(total_chars, 1)
        pos += len(w)
        w_end = start_t + dur * pos / max(total_chars, 1)
        pos += 1
        out.append({"word": w, "start": round(w_start, 3),
                    "end": round(w_end, 3)})
    return out
