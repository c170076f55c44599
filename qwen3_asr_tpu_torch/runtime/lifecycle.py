"""Engine loading from a ``MODEL_ID``, and the manager a server holds.

Counterpart of ``qwen3_asr_tpu/runtime/lifecycle.py``: ``load_engine`` is
its ``_load_engine_sync`` (``MODEL_ID`` is a local checkpoint directory or
``preset:NAME``, which builds that architecture with zero weights and a
byte-level tokenizer; ``QUANTIZE`` (``int8``, ``fp8``, ``int4`` with
``ASR_INT4_GROUP``) quantizes the weights after load, on the engine's
device; ``ASR_KV_CACHE_DTYPE`` picks
the KV cache dtype, ``int4`` included; ``ASR_INT8_ACT`` and
``ASR_INT8_ACT_MIN_TOKENS`` are read where ``ops.quant.qdot`` runs), and
``ModelManager`` is its ``ModelManager``: the lazy load of ``MODEL_ID``
(``ensure_loaded``), the fast engine of ``FAST_MODEL_ID`` under
``DUAL_MODEL`` or ``USE_SPECULATIVE`` (token-level speculation attaches
its model as the main engine's draft; ``ASR_SPECULATIVE_MODE=result``
keeps the reference's result-level heuristic), the warmup
(``_warmup_buckets``; ``SKIP_WARMUP=true`` skips it), the decode pool
under ``ASR_CONTINUOUS_BATCHING=true`` (``runtime/pool.py``;
``pool_eligible``, ``transcribe_pooled``), the idle unload and its
watchdog (``IDLE_TIMEOUT``, ``ASR_WATCHDOG_INTERVAL``), the micro-batcher,
the tick batchers, the live WS session count and ``transcribe_sync``. It
refuses first a WS mode the port does not serve
(``config.check_ws_modes``), and tracks the live prefix-mode WS sessions
and group members (``register_stream_session``, weakly), so that an idle
unload releases them and ``/health`` counts what they hold. The JAX
manager's asyncio lock and watchdog task are a ``threading.Lock`` and a
daemon thread here; loads and unloads run on the queue's device thread.
"""
from __future__ import annotations

import concurrent.futures
import gc
import logging
import os
import threading
import time
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
from ..utils.telemetry import Metrics
from ..config import check_ws_modes
from .batcher import (GroupTickBatcher, MicroBatcher, TickBatcher,
                      dispatch_engine)
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
    # seconds by part, for boot measurements (tools_perf/boot.py)
    parts = {}
    t0 = time.perf_counter()
    if os.path.isdir(model_id):
        cfg, params = load_asr_checkpoint(model_id, dev, dtype)
        tokenizer = BpeTokenizer.from_file(os.path.join(model_id,
                                                        "tokenizer.json"))
        # the checkpoint's chat template drives the prompt when it ships one
        template = PromptTemplate.from_checkpoint(model_id)
        if template.chat_template:
            log.info("Using checkpoint chat template (%d chars)",
                     len(template.chat_template))
        model = AsrModel(cfg, params, tokenizer, template)
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
    parts["read_weights_s"] = _synced(dev, t0)
    if mode:
        t0 = time.perf_counter()
        quantize_model(model, mode)
        parts["quantize_s"] = _synced(dev, t0)
    engine = TranscriptionEngine(model, device=dev, dtype=dtype,
                                 cache_dtype=cache_dtype)
    engine.model_id = model_id
    engine.load_parts = parts
    return engine


def _synced(dev: torch.device, t0: float) -> float:
    """Seconds since ``t0`` once ``dev``'s queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _relay(source: concurrent.futures.Future,
           reply: concurrent.futures.Future) -> None:
    """Settle ``reply`` with what ``source`` settled with."""
    try:
        settle(reply, result=source.result())
    except (Exception, concurrent.futures.CancelledError) as e:
        settle(reply, exc=e)


class ModelManager:
    """Owns the engines and their scheduler; one per serving process.

    ``ModelManager()`` loads lazily: the first ``ensure_loaded()`` loads
    ``MODEL_ID`` on ``device`` (the card unless the caller asks for the
    CPU; in ``dtype``, by default the device's working dtype) as a job of the queue's one device thread, so loads, unloads and
    requests run there in order, one at a time. Under ``USE_SPECULATIVE``
    or ``DUAL_MODEL`` it also loads the fast engine from ``FAST_MODEL_ID``
    (a failed fast load is logged, and the main engine serves alone); under
    ``USE_SPECULATIVE`` with ``ASR_SPECULATIVE_MODE=token`` (the default)
    the fast engine's model becomes the main engine's draft. Then it warms
    both (``_warmup_buckets``, unless ``SKIP_WARMUP=true``) and builds the
    decode pool under ``ASR_CONTINUOUS_BATCHING=true``. A daemon thread,
    the watchdog, wakes every ``ASR_WATCHDOG_INTERVAL`` seconds (30) and
    queues an unload once nothing has used the engines for
    ``IDLE_TIMEOUT`` seconds (120; 0 turns it off); the next request loads
    them again. The watchdog never touches the card itself.

    ``ModelManager(engine)`` serves the engine it is handed: ``start()``
    warms it and builds the pool. Such a manager has no ``MODEL_ID`` of
    its own to load again, so it is never unloaded and starts no
    watchdog. ``stop()`` stops the watchdog, the pool and the device
    thread (settling every job still waiting) and unloads the forced
    aligner. ``REQUEST_TIMEOUT`` (seconds, default 300) bounds how long
    the server waits for one transcription."""

    def __init__(self, engine: Optional[TranscriptionEngine] = None,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        self.engine = engine
        # the working dtype a lazy load asks for (None: the device's)
        self.dtype = dtype
        self.fast_engine: Optional[TranscriptionEngine] = None
        # where a lazy manager loads, and where the WS VAD runs
        self.device = (getattr(engine, "device", device)
                       if engine is not None else device)
        # only a manager that loads its own engine unloads it
        self.lazy = engine is None
        self.loaded_model_id: Optional[str] = (
            getattr(engine, "model_id", None) if engine is not None else None)
        self.queue = PriorityInferQueue()
        # the serving metrics (/metrics), one registry a serving process
        self.metrics = Metrics()
        self.batcher = MicroBatcher(self)
        self.tick_batcher = TickBatcher(self)
        self.group_tick_batcher = GroupTickBatcher(self)
        # live WS sessions (kept by the server): the tick batcher skips its
        # window when there is nothing to coalesce with, and the mode policy
        # reads it
        self.ws_sessions = 0
        self.ws_lock = threading.Lock()
        self.request_timeout = float(os.getenv("REQUEST_TIMEOUT", "300"))
        self.idle_timeout = float(os.getenv("IDLE_TIMEOUT", "120"))
        self.warmed = False
        self.pool = None
        # the JAX manager's asyncio lock: a load or an unload at a time
        self._lock = threading.Lock()
        self._last_used = 0.0
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        # live prefix-mode WS sessions (runtime/stream.py) and group
        # members (runtime/stream_group.py), weakly: a session dies with
        # its connection
        self._stream_sessions = weakref.WeakSet()
        self._sessions_lock = threading.Lock()
        self._last_stream_ref = None

    def register_stream_session(self, session) -> None:
        """Track a WS prefix-mode session or group member, so that an
        unload can ``release()`` it."""
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

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> None:
        """Refuse a WS mode the port does not serve; warm a handed engine
        and build its pool; start the device thread, and the watchdog of a
        lazy manager."""
        check_ws_modes()
        if self.engine is not None and not self.lazy:
            self._prepare(self.engine, None)
        self.queue.start()
        if self.lazy and self._watchdog is None:
            self._watchdog_stop.clear()
            self._watchdog = threading.Thread(
                target=self._idle_watchdog, name="idle-watchdog",
                daemon=True)
            self._watchdog.start()

    def stop(self) -> None:
        """Stop the watchdog, the pool and the device thread, and unload
        the forced aligner."""
        from ..sidecars import subtitle
        self._watchdog_stop.set()
        watchdog, self._watchdog = self._watchdog, None
        if watchdog is not None and watchdog is not threading.current_thread():
            watchdog.join(timeout=10)
        pool, self.pool = self.pool, None
        if pool is not None:
            pool.stop()
        self.queue.stop()
        subtitle.unload_aligner()

    def _prepare(self, engine, fast) -> None:
        """Warm the engines' keys for ``_warmup_buckets()`` (once per
        manager; a spec key when a draft is attached), then build the
        decode pool under ``ASR_CONTINUOUS_BATCHING=true`` (its graphs
        captured for the same buckets)."""
        warm = os.getenv("SKIP_WARMUP", "").lower() != "true"
        if not self.warmed and warm:
            buckets = _warmup_buckets()
            engine.warmup(buckets)
            if fast is not None:
                fast.warmup(buckets)
            self.warmed = True
        # Continuous batching: pooled decode slots share every weight read
        # across concurrent requests; opt-in, as in the JAX package, since
        # the fused path has the better single-stream latency.
        if (self.pool is None and os.getenv("ASR_CONTINUOUS_BATCHING",
                                            "").lower() == "true"):
            from .pool import DecodePool
            self.pool = DecodePool(engine,
                                   buckets=_warmup_buckets() if warm else ())

    @staticmethod
    def _set_cpu_affinity() -> None:
        """``NUMA_NODE``: pin the process to that half of its CPUs (the
        first half for node 0), as the JAX manager does; a failure is
        logged and not fatal."""
        numa_node = os.getenv("NUMA_NODE")
        if numa_node is None:
            return
        try:
            cpus = sorted(os.sched_getaffinity(0))
            half = max(1, len(cpus) // 2)
            node_cpus = cpus[:half] if int(numa_node) == 0 else cpus[half:]
            if node_cpus:
                os.sched_setaffinity(0, node_cpus)
                log.info("CPU affinity set to NUMA node %s: %s", numa_node,
                         node_cpus)
        except (OSError, ValueError) as e:
            log.error("CPU affinity setting failed (non-critical): %s", e)

    def _load_sync(self) -> None:
        """Load ``MODEL_ID`` (and the fast engine), attach the draft, warm
        both and build the pool: on the device thread. A failure leaves
        nothing loaded and raises."""
        if self.engine is not None:
            return
        self._set_cpu_affinity()
        model_id = os.getenv("MODEL_ID", "Qwen/Qwen3-ASR-1.7B")
        t0 = time.time()
        log.info("Loading %s...", model_id)
        engine = load_engine(model_id, device=self.device, dtype=self.dtype)
        fast = None
        use_spec = os.getenv("USE_SPECULATIVE", "").lower() == "true"
        dual = os.getenv("DUAL_MODEL", "").lower() == "true"
        if use_spec or dual:
            fast_id = os.getenv("FAST_MODEL_ID", "Qwen/Qwen3-ASR-0.6B")
            if fast_id != model_id:
                try:
                    log.info("Loading fast model %s (%s)...", fast_id,
                             "speculative" if use_spec else "dual-model")
                    fast = load_engine(fast_id, device=self.device,
                                       dtype=self.dtype)
                except Exception as e:
                    log.error("Fast model load failed: %s, using single "
                              "model", e)
            else:
                log.info("Fast and main model identical; skipping dual load")
        spec_mode = os.getenv("ASR_SPECULATIVE_MODE", "token").lower()
        if use_spec and spec_mode == "token" and fast is not None:
            try:
                engine.attach_draft(fast.model)
                log.info("Token-level speculative decoding enabled "
                         "(gamma=%s)", os.getenv("ASR_SPEC_GAMMA", "4"))
            except AssertionError as e:
                log.error("Token-level speculative unavailable (%s); "
                          "falling back to result-level", e)
        # after attach_draft: the warmup builds the spec keys requests take
        self.warmed = False
        self._prepare(engine, fast)
        self.fast_engine = fast
        self.engine = engine
        self.loaded_model_id = model_id
        self._last_used = time.time()
        log.info("Model loaded in %.1fs on %s (KV cache %s)",
                 time.time() - t0, engine.device, engine.cache_dtype)

    def _last_activity(self) -> float:
        """The newest use on any path: the manager's stamp and each
        engine's (the batchers, the pool and the stream modes dispatch on
        the engines directly)."""
        stamps = [self._last_used]
        for eng in (self.engine, self.fast_engine):
            if eng is not None:
                stamps.append(getattr(eng, "last_used", 0.0))
        return max(stamps)

    def _unload_sync(self) -> None:
        """The idle unload, on the device thread: skipped when the engines
        were used since the watchdog looked, or work waits in the queue or
        the pool; else the aligner, the pool, ``loaded_model_id`` (before
        the engine: ``/health`` never sees an id without a model), both
        engines and every registered stream session go, and the card's
        cached blocks are returned."""
        if self.engine is None:
            return
        if (time.time() - self._last_activity() <= self.idle_timeout
                or self.queue.depth > 0
                or (self.pool is not None and self.pool.depth > 0)):
            log.info("Skipping idle unload: engine used or work in flight")
            return
        log.info("Unloading model (idle timeout)...")
        from ..sidecars import subtitle
        subtitle.unload_aligner()
        pool, self.pool = self.pool, None
        if pool is not None:
            pool.stop()
        self.loaded_model_id = None
        self.engine = None
        self.fast_engine = None
        # a session holds its engine's tensors; its connection binds anew
        with self._sessions_lock:
            sessions = list(self._stream_sessions)
        for session in sessions:
            try:
                session.release()
            except Exception:  # one session must not keep the rest
                log.exception("stream session release failed")
        self._last_stream_ref = None
        del pool, sessions
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        log.info("Model unloaded")

    def ensure_loaded(self) -> None:
        """Stamp the idle clock; load the engines if none is loaded, as a
        job of the device thread (one load at a time; a caller that finds
        them loaded takes no lock)."""
        self._last_used = time.time()
        if self.engine is not None:
            return
        with self._lock:
            if self.engine is not None:
                return
            self.queue.submit(self._load_sync).result()
            self._last_used = time.time()

    def _idle_watchdog(self) -> None:
        interval = float(os.getenv("ASR_WATCHDOG_INTERVAL", "30"))
        while not self._watchdog_stop.wait(interval):
            if self.idle_timeout <= 0 or self.engine is None:
                continue
            if time.time() - self._last_activity() <= self.idle_timeout:
                continue
            try:
                with self._lock:
                    if (self.engine is not None
                            and time.time() - self._last_activity()
                            > self.idle_timeout):
                        self.queue.submit(self._unload_sync).result()
            except Exception:  # one failed unload must not end the watchdog
                log.exception("idle unload failed; watchdog continues")

    # -- inference entry -----------------------------------------------------------
    def transcribe_sync(self, audio, sr: int, lang_code: Optional[str],
                        return_timestamps: bool = False,
                        use_fast: bool = False, context: str = "",
                        resume_tokens=None):
        """One transcription, run ON the device thread (a queue job).
        ``resume_tokens`` takes the resume key (a WS tick's self-draft).
        ``use_fast`` takes the fast engine when one is loaded (WS partials
        under ``DUAL_MODEL``). Under ``USE_SPECULATIVE`` with
        ``ASR_SPECULATIVE_MODE=result`` a batch final goes to the fast
        engine first, and its text stands when it is short and clean (the
        reference's heuristic, ``lifecycle.py:409-411``), else the main
        engine transcribes. ``return_timestamps`` adds each segment's word
        timestamps (the forced aligner's, if loaded). A job that finds no
        engine (an unload won the race against it) loads them first."""
        self._last_used = time.time()
        try:
            engine = dispatch_engine(self, use_fast)
            use_spec = (os.getenv("USE_SPECULATIVE", "").lower() == "true"
                        and self.fast_engine is not None
                        and resume_tokens is None and not use_fast
                        and os.getenv("ASR_SPECULATIVE_MODE",
                                      "token").lower() == "result")
            if use_spec:
                draft = self.fast_engine.transcribe(
                    audio, sr, lang_code, return_timestamps, context)
                draft_text = draft[0].text if draft else ""
                if len(draft_text) < 100 and "[" not in draft_text:
                    return draft
                return engine.transcribe(audio, sr, lang_code,
                                         return_timestamps, context)
            return engine.transcribe(audio, sr, lang_code, return_timestamps,
                                     context, resume_tokens=resume_tokens)
        finally:
            # at the end too: a long job must restart the idle clock
            self._last_used = time.time()

    def serving_engine(self, use_fast: bool = False) -> TranscriptionEngine:
        """``ensure_loaded``, then the engine that serves: the fast one for
        ``use_fast`` when it is loaded, else the main one. Tried again when
        an unload wins the race between the two reads
        (``qwen3_asr_tpu/runtime/batcher.py:185-197``)."""
        for _ in range(3):
            self.ensure_loaded()
            fast = self.fast_engine if use_fast else None
            engine = fast or self.engine
            if engine is not None:
                return engine
        raise RuntimeError("engine unavailable (load/unload race)")

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
