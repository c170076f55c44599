"""Engine loading from a ``MODEL_ID``, and the manager a server holds.

Counterpart of ``qwen3_asr_tpu/runtime/lifecycle.py``: ``load_engine`` is
its ``_load_engine_sync`` (``MODEL_ID`` is a local checkpoint directory or
``preset:NAME``, which builds that architecture with zero weights and a
byte-level tokenizer; ``QUANTIZE`` (``int8``, ``fp8``, ``int4`` with
``ASR_INT4_GROUP``) quantizes the weights after load, on the engine's
device; ``ASR_KV_CACHE_DTYPE`` picks
the KV cache dtype, ``int4`` included; ``ASR_INT8_ACT`` and
``ASR_INT8_ACT_MIN_TOKENS`` are read where ``ops.quant.qdot`` runs), and
``ModelManager`` holds the fields of its ``ModelManager`` that the batchers
and the server use (the micro-batcher, the tick batcher, the group tick
batcher, the live WS session count, ``transcribe_sync``), and warms the engine's executables on
start (``_warmup_buckets``; ``SKIP_WARMUP=true`` skips it), refusing first
a WS mode the port does not serve (``config.check_ws_modes``), and under
``ASR_CONTINUOUS_BATCHING=true`` then builds the decode pool
(``runtime/pool.py``) and routes the requests it can serve there
(``pool_eligible``, ``transcribe_pooled``). It also tracks the live
prefix-mode WS sessions and group members (``register_stream_session``,
weakly), so that an idle unload can release them and ``/health`` counts
what they hold; idle unload, the watchdog and the fast
engine are not ported yet (ROADMAP §1 item 7).
"""
from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from ..models.asr import AsrModel, PromptTemplate
from ..models.config import preset
from ..models.decoder import init_decoder_params
from ..models.encoder import init_encoder_params
from ..ops.quant import (check_mode, check_quantized_dtype, param_bytes,
                         quantize_params)
from ..text.tokenizer import BpeTokenizer, bytes_to_unicode
from ..utils.device import resolve_device, working_dtype
from ..config import check_ws_modes
from .batcher import GroupTickBatcher, MicroBatcher, TickBatcher
from .checkpoint import load_asr_checkpoint
from .engine import (AUDIO_BUCKETS_S, MAX_SEGMENT_S, TARGET_SR,
                     TranscriptionEngine, TranscriptionResult, _prep_audio,
                     _response_language)
from .queue import PriorityInferQueue, settle

log = logging.getLogger(__name__)

# ASR_KV_CACHE_DTYPE: "" keeps the working dtype; torch.int4 names the
# packed int4 cache with per-(token, head) scales.
KV_CACHE_DTYPES = {"": None, "bf16": torch.bfloat16,
                   "fp8": torch.float8_e4m3fn, "int4": torch.int4}


def preset_tokenizer(vocab_size: int) -> BpeTokenizer:
    """Byte-level tokenizer with the six special tokens inside the vocab
    (small presets put them at the top of their vocab, big presets keep the
    real Qwen id block)."""
    byte_vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    base = 151640 if vocab_size > 151646 else vocab_size - 6
    specials = {t: base + i for i, t in enumerate(
        ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|AUDIO|>",
         "<|audio_bos|>", "<|audio_eos|>"])}
    return BpeTokenizer(byte_vocab, [], specials)


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def kv_cache_dtype_from_env() -> Optional[torch.dtype]:
    """``ASR_KV_CACHE_DTYPE``: "" (the working dtype), ``bf16``, ``fp8`` or
    ``int4``."""
    name = os.getenv("ASR_KV_CACHE_DTYPE", "").lower()
    if name not in KV_CACHE_DTYPES:
        raise ValueError(f"ASR_KV_CACHE_DTYPE={name!r} is not one of "
                         f"{sorted(KV_CACHE_DTYPES)}")
    return KV_CACHE_DTYPES[name]


def _warmup_buckets():
    """Buckets the load-time warmup sweep covers (the JAX package's policy,
    with its environment variables and meanings).

    Priority: ``USE_CUDA_GRAPHS=true`` sweeps the FULL ladder (it names the
    whole ladder, not whether graphs are used: on the card every key runs
    as CUDA graphs); ``ASR_WARMUP_BUCKETS="1,2,6"`` names an explicit list
    (unknown or malformed entries dropped with a warning, where the JAX
    package raises mid-load on a malformed one; none known: the smallest
    two); the default is
    the WS-reachable prefix of the ladder: every bucket a streaming session
    at ``WS_WINDOW_MAX_S`` can touch, including the flush window's (cap +
    ``WS_FLUSH_SILENCE_MS`` of padded silence, which rounds UP to the next
    bucket)."""
    if os.getenv("USE_CUDA_GRAPHS", "").lower() == "true":
        return AUDIO_BUCKETS_S
    explicit = os.getenv("ASR_WARMUP_BUCKETS", "").strip()
    if explicit:
        ladder = set()
        for entry in filter(None, map(str.strip, explicit.split(","))):
            try:
                ladder.add(float(entry))
            except ValueError:
                log.warning("ASR_WARMUP_BUCKETS: %r is not a number of "
                            "seconds; skipped", entry)
        return tuple(b for b in AUDIO_BUCKETS_S if b in ladder) \
            or AUDIO_BUCKETS_S[:2]
    cap = float(os.getenv("WS_WINDOW_MAX_S", "6.0") or 6.0)
    flush_s = cap + int(os.getenv("WS_FLUSH_SILENCE_MS", "600")) / 1000.0
    need = [b for b in AUDIO_BUCKETS_S if b <= cap]
    for b in AUDIO_BUCKETS_S:
        if b >= flush_s:
            if b not in need:
                need.append(b)
            break
    return tuple(need) or AUDIO_BUCKETS_S[:2]


def quantize_mode_from_env() -> str:
    """``QUANTIZE``: "" (none), ``int8``, ``fp8`` or ``int4``; anything
    else raises ValueError. (The JAX lifecycle ignores an unknown mode; its
    ``config.validate_env`` rejects it.)"""
    mode = os.getenv("QUANTIZE", "").lower()
    if mode:
        check_mode(mode)
    return mode


def quantize_model(model: AsrModel, mode: str) -> None:
    """Quantize ``model.params`` in place of the full-precision tree, on
    their device, logging the megabytes before and after as the JAX
    lifecycle does; on the card the allocator releases the freed blocks
    before any graph is captured."""
    before = param_bytes(model.params) / 1024 ** 2
    model.params = quantize_params(model.params, mode)
    after = param_bytes(model.params) / 1024 ** 2
    log.info("%s quantization applied — %dMB → %dMB (saved %dMB)",
             mode.upper(), round(before), round(after),
             round(before - after))
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def load_engine(model_id: str, device="cuda",
                dtype: Optional[torch.dtype] = None) -> TranscriptionEngine:
    """A ready engine for ``model_id`` on ``device`` (bf16 on the card and
    f32 on the CPU unless ``dtype`` says otherwise), its weights quantized
    as ``QUANTIZE`` says and its KV cache in the dtype
    ``ASR_KV_CACHE_DTYPE`` names. On the card, quantized weights need bf16
    (refused before a weight is read) and an int4 group layout that
    kernels A and C take (refused when the engine is built, before any
    request)."""
    dev = resolve_device(device)
    dtype = dtype or working_dtype(dev)
    cache_dtype = kv_cache_dtype_from_env()
    mode = quantize_mode_from_env()
    if mode:
        # refuse before loading: the engine would refuse after
        check_quantized_dtype(dev, dtype)
    if os.path.isdir(model_id):
        cfg, params = load_asr_checkpoint(model_id, dev, dtype)
        tokenizer = BpeTokenizer.from_file(os.path.join(model_id,
                                                        "tokenizer.json"))
        model = AsrModel(cfg, params, tokenizer,
                         PromptTemplate.from_checkpoint(model_id))
    elif model_id.startswith("preset:"):
        cfg = preset(model_id.split(":", 1)[1])
        gen = torch.Generator(device=dev).manual_seed(0)
        # zero weights, as the JAX server's presets (shapes from init_*)
        params = _zeros_like_tree({
            "encoder": init_encoder_params(cfg.encoder, gen, dev, dtype),
            "decoder": init_decoder_params(cfg.decoder, gen, dev, dtype)})
        model = AsrModel(cfg, params,
                         preset_tokenizer(cfg.decoder.vocab_size))
    else:
        raise FileNotFoundError(
            f"MODEL_ID '{model_id}' is neither a local checkpoint directory "
            "nor preset:NAME")
    del params
    if mode:
        quantize_model(model, mode)
    engine = TranscriptionEngine(model, device=dev, dtype=dtype,
                                 cache_dtype=cache_dtype)
    engine.model_id = model_id
    return engine


def _relay(source: concurrent.futures.Future,
           reply: concurrent.futures.Future) -> None:
    """Settle ``reply`` with what ``source`` settled with."""
    try:
        settle(reply, result=source.result())
    except (Exception, concurrent.futures.CancelledError) as e:
        settle(reply, exc=e)


class ModelManager:
    """Owns the engine and its scheduler; one per serving process.

    ``start()`` warms the engine's executables for ``_warmup_buckets()``
    (once per manager, unless ``SKIP_WARMUP=true``), builds the decode pool
    under ``ASR_CONTINUOUS_BATCHING=true`` (its graphs captured for the
    same buckets), then starts the queue's device thread; ``stop()`` stops
    the pool and settles every job still waiting for the device thread.
    ``REQUEST_TIMEOUT`` (seconds, default 300) bounds how long the server
    waits for one transcription."""

    def __init__(self, engine: TranscriptionEngine):
        self.engine = engine
        self.queue = PriorityInferQueue()
        self.batcher = MicroBatcher(self)
        self.tick_batcher = TickBatcher(self)
        self.group_tick_batcher = GroupTickBatcher(self)
        # live WS sessions (kept by the server): the tick batcher skips its
        # window when there is nothing to coalesce with, and the mode policy
        # reads it
        self.ws_sessions = 0
        self.ws_lock = threading.Lock()
        self.request_timeout = float(os.getenv("REQUEST_TIMEOUT", "300"))
        self.warmed = False
        self.pool = None
        # live prefix-mode WS sessions (runtime/stream.py) and group
        # members (runtime/stream_group.py), weakly: a session dies with
        # its connection
        self._stream_sessions = weakref.WeakSet()
        self._sessions_lock = threading.Lock()
        self._last_stream_ref = None

    def register_stream_session(self, session) -> None:
        """Track a WS prefix-mode session or group member, so that an
        unload can ``release()`` it (ROADMAP §1 item 7.2)."""
        with self._sessions_lock:
            self._stream_sessions.add(session)
        self._last_stream_ref = weakref.ref(session)

    def stream_session_bytes(self) -> int:
        """Device bytes the registered sessions hold of their own (their
        stashed states; a group member's live in its group, which the
        engine counts)."""
        with self._sessions_lock:
            sessions = list(self._stream_sessions)
        return sum(s.held_bytes() for s in sessions)

    @property
    def last_stream_session(self):
        """The newest prefix-mode session (for tests and measurement), a
        weak reference: a strong one would keep its device buffers after
        its connection closed."""
        return self._last_stream_ref() if self._last_stream_ref else None

    def transcribe_sync(self, audio, sr: int, lang_code: Optional[str],
                        return_timestamps: bool = False,
                        use_fast: bool = False, context: str = "",
                        resume_tokens=None):
        """One transcription, run ON the device thread (a queue job).
        ``resume_tokens`` takes the resume key (a WS tick's self-draft).
        ``use_fast`` asks for the fast engine, which the port does not have
        yet (ROADMAP §1 item 7.2): the main engine serves, as JAX's does
        without one (``lifecycle.py:412-414``). ``return_timestamps`` adds
        each segment's word timestamps (the forced aligner's, if loaded)."""
        return self.engine.transcribe(audio, sr, lang_code,
                                      return_timestamps, context,
                                      resume_tokens=resume_tokens)

    def start(self) -> None:
        check_ws_modes()
        warm = os.getenv("SKIP_WARMUP", "").lower() != "true"
        if not self.warmed and warm:
            self.engine.warmup(_warmup_buckets())
            self.warmed = True
        # Continuous batching: pooled decode slots share every weight read
        # across concurrent requests; opt-in, as in the JAX package, since
        # the fused path has the better single-stream latency.
        if (self.pool is None and os.getenv("ASR_CONTINUOUS_BATCHING",
                                            "").lower() == "true"):
            from .pool import DecodePool
            self.pool = DecodePool(self.engine,
                                   buckets=_warmup_buckets() if warm else ())
        self.queue.start()

    def stop(self) -> None:
        """Stop the pool and the device thread, and unload the forced
        aligner."""
        from ..sidecars import subtitle
        pool, self.pool = self.pool, None
        if pool is not None:
            pool.stop()
        self.queue.stop()
        subtitle.unload_aligner()

    def pool_eligible(self, audio, sr: int, return_timestamps: bool) -> bool:
        """Requests the decode pool can serve: plain mono transcription up
        to one segment; everything else keeps the fused path."""
        return (self.pool is not None and not return_timestamps
                and sr == TARGET_SR and np.asarray(audio).ndim == 1
                and len(audio) <= MAX_SEGMENT_S * TARGET_SR)

    def transcribe_pooled(self, audio, sr: int, language
                          ) -> concurrent.futures.Future:
        """Continuous-batching route: a future of the request's results,
        greedy-identical to the fused path's. A request that meets a
        stopped pool is served on the fused path (``PoolStoppedError``, as
        JAX's ``transcribe_pooled`` does)."""
        from ..models.asr import normalize_language
        from .pool import PoolStoppedError
        audio = _prep_audio(audio, sr)
        reply: concurrent.futures.Future = concurrent.futures.Future()
        if len(audio) == 0:
            reply.set_result([])
            return reply
        pool = self.pool        # a snapshot: stop() nulls it
        if pool is None:
            return self._pooled_fallback(audio, language)
        lang_code, _ = normalize_language(language)
        end_t = len(audio) / TARGET_SR

        def ok(text, ids):
            settle(reply, result=[TranscriptionResult(
                text=text, language=_response_language(text, lang_code),
                start_time=0.0, end_time=end_t, token_ids=ids)])

        def err(e):
            if not isinstance(e, PoolStoppedError):
                settle(reply, exc=e)
                return
            try:
                fused = self._pooled_fallback(audio, language)
            except Exception as e2:   # the queue has stopped too
                settle(reply, exc=e2)
                return
            fused.add_done_callback(lambda f: _relay(f, reply))

        pool.submit(audio, language, ok, err)
        return reply

    def _pooled_fallback(self, audio, language) -> concurrent.futures.Future:
        """Fused-path service for a request that raced a stopped pool."""
        from ..models.asr import normalize_language
        lang_code, _ = normalize_language(language)
        return self.queue.submit(lambda: self.transcribe_sync(
            audio, TARGET_SR, lang_code, False))
