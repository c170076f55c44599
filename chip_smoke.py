"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root: ``python3 chip_smoke.py``. It exits non-zero
without a CUDA device, and whenever any phase fails. Phases:

1. the card's name and power limit; a cold boot by part at preset:1.7b,
   int8 + int4 KV (``tools_perf/boot.py`` in a process of its own, into
   an empty ``ASR_AOT_CACHE_DIR``; phase 19 (f) boots from it), whose
   build is this phase's: build the CUDA kernels from
   ``qwen3_asr_tpu_torch/csrc`` (one nvcc per source, in parallel: the four
   TPU kernels' counterparts, the quantized GEMV and GEMM and the QK-norm +
   RoPE + KV-cache write, and the training path's two backward kernels)
   and print ptxas' registers, shared memory and
   spills, and every line that reports a kernel's wgmmas serialized
   (C7508-C7520); the phase fails if one names kernel C or kernel C
   spills;
2. each kernel against its plain PyTorch version at the main path's shapes
   for preset:1.7b: flash attention (encoder 30 s, prefill 30 s) and the
   single-token decode step at B=1 and B=4 in f32 (TF32 off) and bf16; the
   batched decode step at S=768 for B=1 and B=8 with bf16 and fp8 caches,
   and at the JAX serving shape B=96, S=512 with fp8; the slab-read probe
   at its five shapes (bf16, fp8 and the packed int4 cache with its scale
   rows at B=8 S=768; fp8 and int4 at B=96 S=512); and the quantized
   configurations' kernels: the
   quantized GEMV (kernel A) at M = 1, 8 and 16 for every preset:1.7b
   projection, the tied lm_head and the decoder's two grouped launches
   (q/k/v, gate/up), int8, fp8 and int4 (group scales; library call: one
   F.linear on the bf16-widened weights; a repeat call's bits equal the
   first's, for C too); the quantized GEMM (kernel C) at
   every decoder, encoder and lm_head shape, at the front graph's rows at
   B=1 (30 s) and B=8 (10 s) and 32 decode rows at the lm_head, int8, fp8
   and int4 (library call as A's; the route it replaced,
   ``widened_product``, timed beside; each row's log line and JSON carry
   the launch plan: x width, K splits, blocks); the QK-norm + RoPE + KV-cache
   write (one launch a layer) at a decode step (T=1) for B = 1, 8
   (S=768) and 96 (S=512) and at the 30 s prefill (B=1, T=453), into
   bf16, fp8 and int4 caches,
   against its plain chain (q and K within one ulp, V's bytes equal, the
   bit-equal share printed); and #3's int4 route at B=1, B=8 (S=768, 570
   live) and B=96 (S=512, 257 live), SDPA on a dequantized bf16 copy as
   its yardstick;
3. device times (CUDA graph replays between CUDA events) of kernel, plain
   version and one SDPA call (yardstick only; on a bf16 copy of an fp8
   cache), beside the bound (bytes / 3.35 TB/s against FLOPs /
   989 TFLOP/s, counting only the work the mask leaves) and, in the log
   only, kernels #3 and #4's times before their redesign as PERF.md
   records them; decode steps step through all layers of the stacked
   cache, as the decode loop does, so each call finds its layer cold in
   HBM. Each kernel's headline call, captured in a CUDA graph, must record
   one kernel node and nothing else, and move its own launch counter only;
4. real text: e2e/data/trained_ckpt on the card in f32 must give token ids
   identical to the same port on the CPU and the reference transcripts,
   one clip at a time, and then with the 12 clips sent at once through
   the port's server and its micro-batcher (fewer dispatches than clips);
   every captured graph of phases 4, 5, 6 and 9 records the QK-norm +
   RoPE + KV-cache write once a layer (prefill) and once a layer and step
   (decode chunk);
5. the main path at B=1: a preset:1.7b engine in bf16 with seeded random
   weights, its executables warmed on start for the smoke's buckets
   (``ASR_WARMUP_BUCKETS``: capture seconds per key and the memory the
   warmed keys hold), served by the port's HTTP server on 127.0.0.1,
   answers three uploads (10 s, 15 s and 30 s buckets) one after another,
   each as CUDA-graph replays with no eager kernel launch: flash once per
   encoder and decoder layer and request, the single-token decode kernel
   once per layer and computed decode step (launches counted as what each
   capture recorded times its replays); then the 30 s request through its
   graphs and through the same functions run eagerly, in turns: walls, and
   the same token ids bit for bit;
6. the main path at batch: 8 concurrent uploads of the 10 s bucket with a
   bf16 KV cache and with fp8 (one warmed engine each), in turns (bf16,
   fp8, fp8, bf16), each answered from ONE dispatch at B=8 through the
   batched decode kernel, replays only; then each batch through its graphs
   and eagerly: walls and bit-identical token ids;
7. where the time goes: the 30 s upload once more through the warm engine
   under ``torch.profiler``, recording CUDA activity only (host events
   cost minutes of post-processing and the device share does not need
   them): wall, device busy share, the top kernels, and one decode kernel
   per layer and computed step;
8. the KV read-rate probe (``tools_perf/attn_phase.py``) at its shapes,
   each beside kernel #3's read rate at the same B and cache dtype (its
   int4 route's for the int4 shapes);
9. the JAX package's default serving configuration: preset:1.7b with
   ``QUANTIZE=int8 ASR_KV_CACHE_DTYPE=int4 ASR_INT8_ACT=true`` (weight
   bytes before and after), its keys warmed, the 30 s upload at B=1 and 8
   concurrent uploads at B=8 through the server from replays only (every
   decode step through kernel A, the QK-norm + RoPE + int4 write and #3's
   int4 route; every prompt and encoder product through kernel C or
   W8A8, none through ``widened_product``), the B=8 run against its eager
   run bit for bit; then the same with ``QUANTIZE=int4
   ASR_KV_CACHE_DTYPE=int4`` (kernel A's int4 route, kernel C's); the
   front graph's ms and ms per decode step at B=1 and B=8 of both beside
   the bf16 engines' (phases 5 and 6), with the kernels a decode step as
   in phase 7; one B=1 request with ``QUANTIZE=fp8``;
10. real-time transcription over ``WS /ws/transcribe`` through the port's
   server and its stdlib client (``serving/ws.py``), with the tick
   batches of 3 or 4 sessions (``ASR_WS_TICK_MIN_SESSIONS=3``,
   ``ASR_WS_TICK_MAX_BATCH=4``): the VAD on the card against the CPU on
   10 real clips (both backends; ``is_speech`` equal); (a) trained_ckpt in
   f32 streams a real clip in 450 ms messages with the server VAD on, then
   a flush: every partial's token ids equal a plain run of its window, the
   final is the clip's transcript, draft tokens accepted and decode steps
   per tick against plain greedy's; (b) preset:1.7b bf16, its WS keys
   warmed (capture seconds, memory held), 4 streaming sessions beside 2
   idle ones, all in mode ``tick``: fewer dispatches than ticks, every
   tick's tokens equal its window's solo resume run, replays only, kernel
   B's per-row route and #3 launched; per-tick wall p50/p90, one tick's
   device busy share under the profiler; (c) the same with ``QUANTIZE=int8
   ASR_KV_CACHE_DTYPE=int4 ASR_INT8_ACT=true`` (kernel C on the verify
   rows, B's int4 per-row route, #3-int4). Phases 2 and 3 also
   hold the real-time path's kernel shapes: flash at the verify windows
   (T = 24, 32 and 64 at the 1 s and 6 s prompts, B = 1 and 4, f32 and
   bf16), kernel B with a ``[B]`` write position (T=1 at B = 8 and 96,
   T=64 at B=4; bf16, fp8 and int4 caches; bit-equal shares, repeat
   bits) and #3 with per-row ``valid_to`` (B = 4 and 8, bf16 and int4);
   the phase fails if the VAD counted a failure (``vad.failures``);
11. word timestamps and the forced aligner, SRT subtitles, SSE and
   translations through the server (``sidecars/``): (a) trained_ckpt in
   f32 with ``FORCED_ALIGNER_ID`` at the same checkpoint and its aligner
   on the card in f32: ``return_timestamps`` and ``accurate`` SRTs of 3
   real clips equal the port's on the CPU (words equal, edges within
   1e-3 s); (b) preset:1.7b bf16 (phase 5's engine) with
   ``AlignerEngine`` on its own weights: ``accurate`` SRTs of a 120 s and
   a 330 s upload (a 300 s and a 30 s aligner call; a fixed transcript
   when the random weights transcribe to nothing) and the aligner's
   encoder ms at 30/60/120/300 s; (c) 4 concurrent SSE streams of a 20 s
   real clip: events in order, then ``done``, fewer dispatches than
   chunks, first-event and whole-stream walls; (d) ``json`` and ``srt``
   translations through a fake LLM on 127.0.0.1, and 502 when it fails.
   The phase fails unless flash launched inside the alignments and no
   alignment or VAD failure was counted. Phases 2 and 3 also hold flash
   at the aligner's encoder lengths (T = 750, 1500 and 3750, windows of
   50; f32 and bf16, repeat bits; kernel, plain and SDPA ms and the bound);
12. continuous batching, the decode pool (``runtime/pool.py``) behind
   ``ASR_CONTINUOUS_BATCHING=true``: (a) trained_ckpt in f32 with
   ``ASR_POOL_SLOTS=4``: the 12 real clips at once through the server
   answer phase 4's bodies and, straight through the batcher, its token
   ids, all through the pool (no fused key built), and a WS session with
   ``ASR_POOL_WS=true`` sends every partial and its final through the
   pool; (b) preset:1.7b bf16 (phase 5's engine), the pool at its
   defaults (8 -> 32 slots, segments of 16): 24 uploads in waves of 8
   (30, 15, 10 s buckets) 0.25 s apart through the server with the pool
   and through the micro-batcher with it off, in turns (pool, batcher,
   batcher, pool): tokens/s and request walls p50/p90; the window climbs
   8 -> 16 -> 32 and back to 8; pool runs from replays only, each segment
   graph recording #3 (#2 in f32) and kernel B's per-row route once a
   layer and step; a 45 s upload (long-form, fused) served during a
   fifth pool run equals its solo run (one stream and the ticket buffer
   shared by two device threads); a fixed schedule of 16 requests (a
   compaction and the window's re-layouts on the way) through the graphs
   and then eagerly: the same bits; the share of the pool's tokens
   that agree with the micro-batcher's; a segment's device ms at windows
   8, 16 and 32, the pool's memory and capture seconds; (c) the same
   waves with ``QUANTIZE=int8 ASR_KV_CACHE_DTYPE=int4 ASR_INT8_ACT=true``:
   an fp8 pool cache, kernel A on windows of 8 and 16 rows, kernel C at
   32 and on the prompts, no W8A8. Phases 2 and 3 also hold #3 at the
   pool's windows (8, 16, 32 rows of S=768, per-row valid_from and
   valid_to; bf16 and fp8);
13. WS prefix caching, ``ASR_WS_STREAM_MODE=prefix``
   (``runtime/stream.py``): (a) trained_ckpt in f32 at an 8.5 s cap, a
   quiet real clip then a loud one in 450 ms ticks with chunk trims: every
   tick's token ids equal the fused resume path's at the pinned bucket on
   the card and the CPU session's; tail, full and redo ticks all seen; two
   sessions in turns (the working buffers handed over) equal their solo
   runs; graph = eager bit for bit (ids, the prompt's keys, the audio
   tokens); (b) preset:1.7b bf16 (phase 5's engine) at a 30 s cap: its
   stream keys warmed (seconds, graphs, capture, memory), one session over
   WS streaming the real clips' first 20 s, unpaced: partial wall
   p50/p90, each tick's stream ms by kind (tail at each rung, full, redo),
   the session's memory, its hand-overs (none), replays only; each stream
   graph's device ms and a hand-over's copies; then the same audio in
   mode ``solo`` (its resume keys warmed first): partial wall p50/p90
   beside the prefix session's over the same ticks; (c) the
   same prefix session on the same 20 s with ``QUANTIZE=int8
   ASR_KV_CACHE_DTYPE=int4 ASR_INT8_ACT=true``: an fp8 session cache, #3
   at B=1, kernels A and C.
   The phase fails on a bind failure (``serving/ws.py``
   ``prefix_bind_failures``) or a VAD failure. Phases 2 and 3 also hold
   flash at the mode's shapes: the segment prefill at T = 64 and 389
   (q_offset = P - T, S=768) and one encoder block (T = 50 and 25, windows
   of 50), f32 and bf16, repeat bits, kernel, plain and SDPA ms;
14. the grouped WS mode, ``ASR_WS_STREAM_MODE=grouped``
   (``runtime/stream_group.py``, ``GroupTickBatcher``): (a) trained_ckpt
   in f32, 4 slots at an 8.5 s cap, direct ``StreamGroup.tick`` calls: a
   quiet then loud clip from the first cadence, a Chinese one joining two
   cadences late, one leaving early and a fourth taking its slot; every
   tick's ids equal a solo session's on the card (the first member's also
   the fused resume path's) and the same schedule's on the CPU; graph =
   eager; (b) preset:1.7b bf16 (phase 5's engine) at a 30 s cap and the
   default 8 slots: the group keys warmed, 4 WS sessions streaming 20 s
   of the real clips each at once, unpaced, into one group (the group tick
   batcher dispatching when all 4 have landed, within 200 ms): its group
   sizes and dispatches, partial wall p50/p90, each dispatch's device ms
   by rung, bind failures (none); a fixed schedule of direct ticks (two
   members of 2 ticks, a third joining at the second cadence for 1)
   through the graphs (graph = eager: the card test
   ``test_stream_group_graphs_equal_eager``); each front
   recording flash and kernel B twice a layer, the chunk #3 and kernel
   B's per-row route once a layer and step; the device ms of a front at
   rungs 64 and 389 and of a chunk at 8 rows; (c) the same schedule with
   ``QUANTIZE=int8 ASR_KV_CACHE_DTYPE=int4 ASR_INT8_ACT=true``: an fp8
   group cache, kernels A and C. Phases 2 and 3 also hold flash at the
   group's segment prefill (B=8, T = 64 and 389, per-row valid_from) and
   #3 at its continuation (B=8, S=768, rows at their own frontiers; bf16
   and fp8);
15. the manager's lifecycle, its second engine and token-level
   speculative decoding (``runtime/lifecycle.py``,
   ``runtime/speculative.py``): (a) a lazy ``ModelManager()`` behind the
   server, built from ``MODEL_ID=trained_ckpt``,
   ``FAST_MODEL_ID=trained_draft``, ``USE_SPECULATIVE=true``,
   ``IDLE_TIMEOUT=2`` and ``ASR_WATCHDOG_INTERVAL=1``, f32: ``/health``
   before the load, the load and warmup (spec keys), the 12 real clips one
   at a time and then all at once, token-identical to phase 4's greedy
   ids and to the CPU's spec ids (rounds and tokens a round printed);
   ``/health`` showing the idle unload (``model_loaded`` false,
   ``model_id`` null); the allocator's memory before the load, loaded,
   after the unload (the residue at most ``UNLOAD_RESIDUE_MIB``) and after
   a reload by a request, whose answer and ids are the same; then
   ``DUAL_MODEL=true`` without speculation: one WS session whose partials
   the fast engine decodes and whose final the main one does; (b) phase
   5's preset:1.7b bf16 engine as the verifier with a preset:0.6b draft of
   random bf16 weights (seed 1), γ = 4: the spec keys' capture seconds and
   memory; the 30 s upload at B=1 and 8 uploads at once at B=8 through the
   server from replays only; walls against greedy in turns (spec, greedy,
   greedy, spec), rounds and tokens a round; device ms a round and of its
   draft steps and verify forward; 1.7b self-draft at B=1 (the acceptance
   ceiling); with an fp8 cache, the share of a round that widening the
   verifier's layers takes. Phases 2 and 3 also hold flash at the verify
   window (T = γ = 4 at a per-row q_offset over S = 768, B = 1 and 8) and
   kernel B writing the window at a position a row;
16. the serving contract and the upload codecs: (a) 4 of phase 4's
   clips (every third: Cantonese, Chinese, Hindi, Japanese; samples
   clipped to +-32767, so that every container holds them exactly) as
   WAV and re-encoded as FLAC (16-bit fixed subframes, 24-bit LPC
   subframes, 16-bit stereo with the channel duplicated, by the port's
   ``encode_flac``), AIFF, AIFC float32, AU, CAF and W64, uploaded through
   the port's server to a lazy ``ModelManager`` of trained_ckpt in f32 on
   the card: every upload's body, and the token ids of its own engine
   dispatches, equal the WAV upload's; the first upload, which loads the model, carries an ``X-Request-ID``
   that the JSON log lines of its request thread and of the device thread
   (the load) carry as ``requestId``; the FLAC helper
   (``csrc/audio_dsp.cpp``) built and used; (b) preset:1.7b bf16 (phase
   5's engine): a 29.5 s FLAC of the real clips at 44.1 kHz stereo, host
   decode ms with the helper against its plain version (Python loops, on
   the first 5 s), and its request wall against the same audio as WAV, in
   turns; the 330 s tiled clip as FLAC: decode ms per audio second; (c)
   ``POST /debug/trace?seconds=3`` while a 29.5 s upload runs: a second
   capture answers 409, the answer's seconds recorded agree with its
   ``budget_reached``, the newest Chrome trace in ``ASR_TRACE_DIR`` holds
   the port's flash and decode kernels and no library attention kernel;
   kernel events counted beside the answer's estimate, the upload's wall
   with and without the capture; (a') (a)'s clips as the committed MP3,
   Ogg Vorbis, Ogg Opus (SILK, CELT, hybrid) and Layer II files of
   ``e2e/data/compressed``: bodies and token ids equal a float WAV upload
   of the port's decode, the helper equal to the plain loops on the
   shortest file of each; (b') the 29.5 s stereo MP3, Ogg Vorbis, Ogg Opus
   and Layer II on (b)'s engine: decode ms an audio second with the helper
   and the plain loops, upload walls against WAV in turns;
   (d) ``/metrics``: ``asr_requests_total`` equals the requests the phase
   sent, by route, method and status (a 404 as ``unmatched``), the
   duration histogram counts them, the gauges are there; ``/openapi.json``
   lists every route of ``serving/meta.py``. #1 and #2 must launch in (b)
   and (c).
17. gateway mode (``serving/gateway.py``, ``serving/worker.py``): an
   in-process gateway spawning ``python -m
   qwen3_asr_tpu_torch.serving.worker`` processes on the card; (a) two
   trained_ckpt f32 workers (``WORKER_PORTS``) of a copy whose
   ``tokenizer_config.json`` carries a chat template: (i) one that
   renders the builtin layout: phase 4's 12 clips at once through the
   gateway, answers and token ids (the workers' debug lines, by forwarded
   ``X-Request-ID``) equal to phase 4's, both workers serving, their
   ``/health`` ``hbm_used_mb``; an SSE stream and a WS session (english_02)
   through the gateway equal to the same sent to a worker; (b)
   preset:1.7b bf16 at full width, one worker warmed at 10 and 30 s: the
   10 s and 30 s uploads direct and through the gateway in turns (medians
   of 5, the hop's ms), 8 uploads at once (one B=8 dispatch in the
   worker), the idle kill (``IDLE_TIMEOUT=2``, a 1 s watchdog: card memory
   before the spawn, loaded and after, the worker's PID in ``nvidia-smi``)
   and a cold respawn's seconds. The workers' kernel launches are not
   counted here (another process): the evidence is (a)'s ids, the
   workers' ``hbm_used_mb`` and the memory and PID the card shows.

18. training (``runtime/train.py``, ``tools/finetune.py``): (a) the
   backward kernels against their plain versions in f32 and bf16, a
   repeat call's bits equal the first's, each call on the route
   ``bwd_route`` names (flash's tensor cores in bf16, CUDA cores in f32;
   QK-norm + RoPE's 16-byte vectors at head dim 128, a warp a row at 48),
   every route timed: flash attention's
   (``csrc/flash_attention_bwd.cu``) at the encoder's 6 s (B=8) and 30 s
   (B=1) windows and the training forward's causal shape at preset:1.7b
   (B=8, 6 s bucket: T = 217, the prompt from 12), QK-norm + RoPE's
   (``csrc/qk_rope_bwd.cu``) at that shape's rows and at trained_ckpt's
   heads; bf16 times as phase 3's, the library column SDPA's backward
   through autograd (same boolean mask, ``enable_gqa``; its forward and
   backward captured in one graph, less its forward); (b)
   trained_ckpt in f32: every gradient leaf of both towers non-zero (but
   the encoder's key bias, 0 in exact arithmetic), three train steps at
   lr 1e-5 on a ``make_batch`` of the 12 real clips with losses equal to
   the port's on the CPU to 1e-5 relative, flash forward and backward
   launched once an encoder and a decoder layer and step, kernel B and
   the QK-norm + RoPE backward once a decoder layer and step; the
   trained weights saved (``save_asr_checkpoint``), loaded through
   ``load_engine`` on the card and on the CPU: english_01's ids equal;
   (c) preset:1.7b at full width in bf16 with seeded random weights and
   its byte tokenizer, B=8 real clips at the 6 s bucket: ms a step
   (median of 3 after a warm step), finite losses, peak memory, launches
   a step by kernel and by route; (d) ``python -m
   qwen3_asr_tpu_torch.tools.finetune`` on the card, 2 steps on a manifest
   of 4 clips.

19. the operator tools: (a) ``tools/transcribe.py`` through ``main``:
   trained_ckpt in f32 (``--dtype float32``), the 12 real clips in one
   call with ``--json``, records and token ids equal to phase 4's server
   answers and ids, then the same call with ``--srt --srt-mode accurate``
   and ``FORCED_ALIGNER_ID`` at trained_ckpt; preset:1.7b bf16 with a 45 s
   file (the long-form split), 8 clips of 9.5 s in one batch (#3) and a
   5 s clip alone (#2): the launches of #1, #2 and #3 and the CLI's audio
   seconds a wall second; (b) the preset:1.7b bf16 encoder exported
   (``tools/export_encoder.py``) at the 6 s bucket: 32 nodes of the
   registered flash operator and no SDPA in the graph, the program's
   output equal to the eager ``encoder_forward`` bit for bit (its 32
   flash launches counted), saved, loaded and run again; then phase 7's
   key captured again with the operator registered: its front and chunk
   graphs hold phase 7's node counts; (c) ``tools/train_vad.py`` on the card
   (1500 steps, output to a temporary file): train-set FP/FN, the worst
   flap rate and the held-out clips' rates beside the committed weights'
   through the same ``evaluate()``, its seconds, and the committed file
   unchanged; (d) the BPE trainer on the 12 clips' transcripts: the
   committed ``trained_ckpt/tokenizer.json`` byte for byte (850 merges);
   then ``tools/overfit.py --size base`` without ``--tokenizer`` on 2
   clips for 31 steps; (e) ``runtime/roofline.py``: the analytic cost of
   phase 5's 30 s B=1 request and phase 6's B=8 dispatch and their
   ``mfu`` and ``hbm_util`` from the walls those phases measured; (f) a
   boot by part from the boot cache phase 1's cold boot filled, into an
   empty build directory (no compiler runs; ``QUANTIZE=int8
   ASR_KV_CACHE_DTYPE=int4``): token ids equal to the cold boot's, the
   seconds saved.
20. parallelism: (a) kernel (i)'s m/l route (cotangents on m and l, JAX's
   residual loss sum(out²) + 1e-3·sum(m) + sum(log l)) against its plain
   version at the encoder's 6 s windows and the training forward's causal
   shape, and that shape with duplicated keys (rows tie at their
   maximum), f32 and bf16 at phase 18's tolerances, a repeat call's bits;
   device ms beside the same call with dm = dl = None and (i)'s bound (no
   library call computes this gradient); its launches on its path, that
   loss differentiated through ``FlashFunction``; (b) context parallelism
   folded onto the card (``combine_stacked``) at preset:1.7b's 30 s
   prefill queries, causal at the end of S = 768 and 3072 keys in 4
   shards, against one flash call, and their device ms; (c) a world-1
   NCCL group: phase 5's preset:1.7b bf16 engine and the same model under
   ``make_mesh(1, 1)`` on phase 5's first upload (ids bit for bit, the
   collectives recorded in the sharded key's graphs, node counts, front
   and decode-step device ms), the distributed CP against flash, and on
   trained_ckpt in f32 one step of the finetune path (dp=1 mesh) and one
   pp=1, n_micro=2 pipeline step against the plain train step. There is
   one card: NCCL refuses two ranks on one card, so no multi-card figure
   is taken.

Each phase prints its seconds. The line before the card line is the
kernel table as JSON; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import glob
import json
import logging
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import tracemalloc
import urllib.error
import urllib.request
import uuid

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "e2e", "data")
# walls and graph sizes phases 5-7 measured, for phase 19's roofline and
# its check of phase 7's key
MEASURED = {}
SMOKE_BUCKETS = "10,15,30"         # the buckets phases 5-7 run
KV_NAMES = {torch.bfloat16: "bf16", torch.float8_e4m3fn: "fp8"}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


_T0 = time.time()


def log(msg: str) -> None:
    """A line of the log, after the seconds since the script started."""
    print(f"{time.time() - _T0:7.1f} {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int) -> float:
    """Time of one call as the caller sees it, host overhead included:
    CUDA events around ``iters`` back-to-back calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 ---------------------------------------------------------------------

# ptxas' report that a kernel's wgmmas run one at a time (C7508-C7520:
# "wgmma.mma_async instructions are serialized due to ...")
SERIALIZED = re.compile(r"C75[0-2]\d|serializ", re.IGNORECASE)


def ptxas_faults(reports) -> list:
    """Print every kernel's ptxas registers, spills and serialized-wgmma
    lines; return those of kernel C (``qgemm``) that name a serialized
    wgmma or a spill, which fail the phase."""
    faults = []
    for name, text in reports.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = re.sub(r"_ZN\w*?_cu_\w{8}\d+", "", m.group(1))[:48]
            elif SERIALIZED.search(line):
                log(f"[ptxas] {name}: {line.strip()}")
                if name == "qgemm":
                    faults.append(line.strip())
            elif "registers" in line or "spill" in line:
                log(f"[ptxas] {name}<{entry}>: {line.strip()}")
                if name == "qgemm" and re.search(r"[1-9]\d* bytes spill",
                                                 line):
                    faults.append(f"{entry}: {line.strip()}")
    return faults


def build_kernels() -> None:
    from qwen3_asr_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build(sorted({os.path.basename(src)[:-3]
                                   for src, _, _ in KERNELS.values()}))
    log(f"[build] {len(reports)} kernels ready in {time.time() - t0:.1f} s")
    faults = ptxas_faults(reports)
    log(f"[ptxas] qgemm: {len(faults)} serialized-wgmma or spill lines")
    if faults:
        raise AssertionError("kernel C's wgmmas are serialized or it "
                             "spills:\n" + "\n".join(faults))


# -- phases 2 and 3 ---------------------------------------------------------------

def main_path_shapes():
    """The shapes preset:1.7b gives the kernels on a 30 s request."""
    from qwen3_asr_tpu_torch.models.asr import PromptTemplate
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.encoder import (conv_tokens_per_chunk,
                                                    encoder_output_length)
    from qwen3_asr_tpu_torch.runtime.engine import (PREFIX_BUDGET,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.generate import cache_length
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    enc, dec = cfg.encoder, cfg.decoder
    chunk = enc.n_window * 2
    t_enc = int(encoder_output_length(3000, chunk))
    window = conv_tokens_per_chunk(chunk) * max(1, enc.n_window_infer // chunk)
    tok = preset_tokenizer(dec.vocab_size)
    tmpl = PromptTemplate()
    valid_from = PREFIX_BUDGET - len(tok.encode(tmpl.prefix_text(None)))
    prompt_len = PREFIX_BUDGET + t_enc + len(tok.encode(tmpl.suffix_text()))
    max_new = max_new_tokens_for(30.0)
    s = cache_length(prompt_len, max_new)
    # rows of the quantized products of the front graph: the encoder's
    # tokens (bucket-padded) and the prompt, at B=1 (30 s) and B=8 (10 s)
    enc_tokens = {sec: (sec * 100 // chunk) * conv_tokens_per_chunk(chunk)
                  for sec in (10, 30)}
    prompt_10s = (PREFIX_BUDGET + int(encoder_output_length(1000, chunk))
                  + len(tok.encode(tmpl.suffix_text())))
    return dict(
        enc_rows_b1=enc_tokens[30], enc_rows_b8=8 * enc_tokens[10],
        dec_rows_b8=8 * prompt_10s,
        enc_heads=enc.encoder_attention_heads, enc_d=enc.head_dim,
        t_enc=t_enc, window=window, nq=dec.num_attention_heads,
        nkv=dec.num_key_value_heads, d=dec.head_dim, layers=dec.num_hidden_layers,
        prompt_len=prompt_len, cache=s, valid_from=valid_from,
        decode_pos=prompt_len + max_new // 2)


def make_cases(sh, batch: int, dtype, dev):
    """(label, kernel, kernel call, plain call, SDPA call, bytes, flops,
    layers) for the three main-path uses at this batch and dtype. Kernel and
    plain calls return (out, m, l) for flash and (out,) for decode. The
    decode calls take a layer index, and ``layers`` says how many the timing
    steps through (0: the call takes none)."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(batch)
    esize = torch.tensor([], dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def i32(v):
        return torch.full((batch,), v, dtype=torch.int32, device=dev)

    def flash_extra(b, heads, t):
        """Bytes of the f32 m and l written and the three int32 [B] read."""
        return 2 * 4 * b * heads * t + 3 * 4 * b

    def encoder():
        """Encoder window attention, 30 s bucket."""
        t, h, d, w = sh["t_enc"], sh["enc_heads"], sh["enc_d"], sh["window"]
        q, k, v = (randn(batch, h, t, d) for _ in range(3))
        vt, zero = i32(t), i32(0)
        mask = AttnSpec(window_block=w, valid_to=vt).dense_mask(batch, t, t,
                                                                dev)
        return (
            f"encoder_30s_b{batch}", "flash_attention",
            lambda: flash_attention(q, k, v, window_block=w, kv_valid_to=vt,
                                    return_residuals=True),
            lambda: flash_attention_plain(q, k, v, zero, vt, zero,
                                          causal=False, window_block=w,
                                          sm_scale=d ** -0.5),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=mask[:, None]),
            4 * batch * h * t * d * esize + flash_extra(batch, h, t),
            4 * d * h * int(mask.sum()), 0)

    def prefill():
        """Decoder prefill over the left-padded prompt, into the 30 s cache."""
        t, s, nq, nkv, d = (sh["prompt_len"], sh["cache"], sh["nq"],
                            sh["nkv"], sh["d"])
        q, k, v = randn(batch, nq, t, d), randn(batch, nkv, s, d), randn(
            batch, nkv, s, d)
        vf, vt, zero = i32(sh["valid_from"]), i32(s), i32(0)
        mask = AttnSpec(causal=True, valid_from=vf).dense_mask(batch, t, s,
                                                               dev)
        live = t - sh["valid_from"]      # keys any row can see
        return (
            f"prefill_30s_b{batch}", "flash_attention",
            lambda: flash_attention(q, k, v, causal=True, kv_valid_from=vf,
                                    return_residuals=True),
            lambda: flash_attention_plain(q, k, v, vf, vt, zero, causal=True,
                                          window_block=0,
                                          sm_scale=d ** -0.5),
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None], enable_gqa=True),
            (2 * batch * nq * t * d + 2 * batch * nkv * live * d) * esize
            + flash_extra(batch, nq, t),
            4 * d * nq * int(mask.sum()), 0)

    def decode():
        """One decode step against the stacked cache, mid-budget."""
        s, nq, nkv, d = sh["cache"], sh["nq"], sh["nkv"], sh["d"]
        pos, last = sh["decode_pos"], sh["layers"] - 1
        q = randn(batch, nq, 1, d)
        k, v = (randn(sh["layers"], batch, nkv, s, d) for _ in range(2))
        vf, vt = i32(sh["valid_from"]), i32(pos + 1)
        mask = AttnSpec(valid_from=vf, valid_to=vt).dense_mask(batch, 1, s,
                                                               dev)
        live = pos + 1 - sh["valid_from"]
        return (
            f"decode_step_b{batch}", "decode_attention",
            lambda layer=last: (decode_attention(
                q, k, v, layer_idx=layer, kv_valid_from=vf, kv_valid_to=vt),),
            lambda layer=last: (decode_attention_plain(
                q, k, v, vf, vt, layer_idx=layer, sm_scale=d ** -0.5),),
            lambda layer=last: F.scaled_dot_product_attention(
                q, k[layer], v[layer], attn_mask=mask[:, None],
                enable_gqa=True),
            (2 * batch * nq * d + 2 * batch * nkv * live * d) * esize
            + 8 * batch, 4 * d * nq * batch * live, sh["layers"])

    return [encoder(), prefill(), decode()]


def batched_cases(sh, dev):
    """The batched decode step (kernel #3) at the decode shapes: the 30 s
    bucket's cache (S=768) mid-budget for B=1 and B=8 with bf16 and fp8
    caches, and the JAX serving shape (B=96, S=512, fp8) at S/2. At B=8
    with bf16, the single-token kernel (#2) runs on the same tensors. The
    SDPA yardstick reads a bf16 copy of an fp8 cache. Same tuple as
    ``make_cases``, and a note for the SDPA column."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched, decode_attention_batched_plain)
    nq, nkv, d, layers = sh["nq"], sh["nkv"], sh["d"], sh["layers"]
    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    s30, vf30, vt30 = sh["cache"], sh["valid_from"], sh["decode_pos"] + 1
    for batch, s, kv_dtype, vf0, vt0 in (
            (1, s30, bf16, vf30, vt30), (8, s30, bf16, vf30, vt30),
            (1, s30, fp8, vf30, vt30), (8, s30, fp8, vf30, vt30),
            (96, 512, fp8, 0, 257)):
        gen = torch.Generator(device=dev).manual_seed(batch + s)
        q = torch.randn((batch, nq, 1, d), generator=gen,
                        device=dev).to(bf16)
        k, v = (torch.randn((layers, batch, nkv, s, d), generator=gen,
                            device=dev).to(kv_dtype) for _ in range(2))
        vf = torch.full((batch,), vf0, dtype=torch.int32, device=dev)
        vt = torch.full((batch,), vt0, dtype=torch.int32, device=dev)
        kb, vb = (k, v) if kv_dtype == bf16 else (k.to(bf16), v.to(bf16))
        mask = AttnSpec(valid_from=vf, valid_to=vt).dense_mask(batch, 1, s,
                                                               dev)
        live = vt0 - vf0
        nbytes = (2 * batch * nq * d * 2
                  + 2 * batch * nkv * live * d * k.element_size() + 8 * batch)
        flops = 4 * d * nq * batch * live
        kv_name = KV_NAMES[kv_dtype]

        def sdpa(layer, kb=kb, vb=vb, q=q, mask=mask):
            return F.scaled_dot_product_attention(
                q, kb[layer], vb[layer], attn_mask=mask[:, None],
                enable_gqa=True)

        yield (f"batched_b{batch}_s{s}_{kv_name}", "decode_attention_batch",
               lambda layer, q=q, k=k, v=v, vf=vf, vt=vt: (
                   decode_attention_batched(q, k, v, layer_idx=layer,
                                            kv_valid_from=vf,
                                            kv_valid_to=vt),),
               lambda layer, q=q, k=k, v=v, vf=vf, vt=vt: (
                   decode_attention_batched_plain(q, k, v, vf, vt,
                                                  layer_idx=layer,
                                                  sm_scale=d ** -0.5),),
               sdpa, nbytes, flops, layers,
               "" if kv_dtype == bf16 else " on a bf16 copy of the cache")
        if batch == 8 and kv_dtype == bf16:
            yield (f"decode_step_b8_s{s}", "decode_attention",
                   lambda layer, q=q, k=k, v=v, vf=vf, vt=vt: (
                       decode_attention(q, k, v, layer_idx=layer,
                                        kv_valid_from=vf, kv_valid_to=vt),),
                   lambda layer, q=q, k=k, v=v, vf=vf, vt=vt: (
                       decode_attention_plain(q, k, v, vf, vt,
                                              layer_idx=layer,
                                              sm_scale=d ** -0.5),),
                   sdpa, nbytes, flops, layers, "")
        del k, v, kb, vb


def slab_cases(dev):
    """The slab-read probe (kernel #4) at the probe's shapes, on the last
    layer of its seeded cache. (label, kernel call, plain call, bytes,
    layers)."""
    from qwen3_asr_tpu_torch.ops.slab_reader import (slab_bytes, slab_read,
                                                     slab_read_plain)
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import (
        LAYERS, NKV, SHAPES, stacked_cache)
    for name, batch, seq, dtype in SHAPES:
        cache = stacked_cache(batch, seq, dtype, dev)
        yield (name,
               lambda layer, c=cache: slab_read(**c, layer_idx=layer,
                                                seed=1),
               lambda layer, c=cache: slab_read_plain(
                   **c, layer_idx=layer, seed=1, block_s=128),
               slab_bytes(batch, NKV, seq, dtype), LAYERS)
        del cache


# Replays of a plain version's graph (of 10 calls, each layer) when it is
# timed: its time is a column beside the kernel's, not a bound, and the
# plain versions are 5-100x slower, so 20 replays cost ~80 s of the run.
PLAIN_ITERS = 2


def per_call_ms(fn, layers: int, iters: int = 20) -> float:
    """Device ms of one call; with ``layers``, the calls step through every
    layer of the stacked cache (larger than L2), as the decode loop does.
    ``iters`` replays of a graph of 10 calls (of every layer)."""
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import device_ms
    if not layers:
        return device_ms(fn, iters=iters)
    return device_ms(lambda: [fn(i) for i in range(layers)],
                     iters=iters) / layers


# Device ms of kernels #3, #4, A and B before their redesigns, as PERF.md's
# kernel tables record them (their earlier-time columns, from runs of this
# script on an NVIDIA H100 80GB HBM3 at 700 W). Printed beside this run's in the log only: they are not
# this run's, so no row of the kernel table holds them.
EARLIER_MS = {
    "batched_b1_s768_bf16": 0.0134, "batched_b8_s768_bf16": 0.0212,
    "batched_b1_s768_fp8": 0.0118, "batched_b8_s768_fp8": 0.0191,
    "batched_b96_s512_fp8": 0.0728, "engine_b8_s768_bf16": 0.0115,
    "engine_b8_s768_fp8": 0.0078, "jax_default_b96_s512_fp8": 0.0353,
    "lm_head_m1_int8": 0.1233, "lm_head_m8_int8": 0.3443,
    "lm_head_m1_fp8": 0.1171, "gate_up_m1_int8": 0.0077,
    "gate_up_m8_int8": 0.0173, "down_m1_int8": 0.0084,
    "down_m8_int8": 0.0176, "wq_wo_m1_int8": 0.0043,
    "wq_wo_m8_int8": 0.0079, "wk_wv_m1_int8": 0.0036,
    "wk_wv_m8_int8": 0.0055,
    # kernel B, the int4 cache write alone (before its redesign)
    "qk_b1_t1_int4": 0.0018, "qk_b8_t1_int4": 0.0019,
    "qk_b96_t1_int4": 0.0022,
    # kernels (i) and B' in bf16, their first versions (f32 arithmetic on
    # the CUDA cores, a warp a row)
    "encoder_6s_b8": 0.2057, "encoder_30s_b1": 0.1455,
    "train_causal_b8_6s": 0.8282, "qk_bwd_b8_6s": 0.0456,
    "qk_bwd_trained_ckpt_b12": 0.0243}


def graph_node_types(graph: "torch.cuda.CUDAGraph") -> list:
    """The CUgraphNodeType of every node of a captured, kept graph, read
    through the CUDA driver (0 is a kernel node)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    return types


def one_kernel_per_call(kernel: str, label: str, fn, calls: int = 3,
                        also: tuple = ()) -> None:
    """``calls`` calls of ``fn`` captured into one CUDA graph must record
    ``calls`` graph nodes, every one a kernel, and move ``kernel``'s launch
    counter by ``calls`` and no other counter (but ``also``, counters of a
    route of the same kernel): one device kernel a call, the wrapper's
    own. The graph is read through the CUDA driver, not
    torch.profiler: on the card the profiler has dropped every kernel
    record of a window of a few short calls, in three windows running."""
    fn()
    torch.cuda.synchronize()
    counter = PathLaunches()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    types = graph_node_types(graph)
    moved = {k: n for k, n in counter.read()[1].items() if n}
    del graph
    log(f"[graph] {kernel} {label}: {calls} calls captured {len(types)} "
        f"nodes of types {types} (0: kernel); launch counters moved "
        f"{moved}")
    want = {name: calls for name in (kernel,) + also}
    if types != [0] * calls or moved != want:
        raise AssertionError(f"{kernel} {label}: want {calls} kernel nodes "
                             f"and {want} launches, got node types {types} "
                             f"and {moved}")


def time_row(label, dt, err, run, plain, sdpa, nbytes, flops, layers,
             card, sdpa_note="", lib_name="sdpa", note=""):
    """Phase 3 for one case in bf16: the row of the kernel table."""
    ms = per_call_ms(run, layers)
    plain_ms = per_call_ms(plain, layers, PLAIN_ITERS)
    lib_ms = per_call_ms(sdpa, layers)
    call_ms = eager_ms(run if not layers else (lambda: run(layers - 1)), 50)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    earlier = EARLIER_MS.get(label)
    row = {"shape": label, "dtype": dt, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "eager_ms": call_ms, "bytes": nbytes, "flops": flops}
    log(f"[timing] {label} bf16 (device): kernel {ms:.4f} ms"
        + (f" (before the redesign, PERF.md: {earlier:.4f})" if earlier
           else "")
        + f", plain {plain_ms:.4f} ms, {lib_name}{sdpa_note} {lib_ms:.4f} "
        f"ms (kernel / {lib_name} {ms / lib_ms:.3f}); one eager call "
        f"{call_ms:.4f} ms; bound {bound:.5f} ms ({row['bound_by']}), "
        f"share {bound / ms:.3%}{note} | {card}")
    return row


def kernel_phases(sh, dev):
    """Parity (phase 2) in f32 and bf16, timing (phase 3) in bf16, the
    working dtype on the card. Returns {kernel: [per-shape rows]}."""
    card = card_line()
    rows = {name: [] for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 4):
            for label, kernel, run, plain, sdpa, nbytes, flops, layers in \
                    make_cases(sh, batch, dtype, dev):
                outs, refs = run(), plain()
                torch.cuda.synchronize()
                err = float((outs[0].float() - refs[0].float()).abs().max())
                tol = TOL[dtype]
                dt = str(dtype).replace("torch.", "")
                res = ""
                if len(outs) == 3:
                    # m and l (f32) as tests/test_torch_cuda.py holds them:
                    # |kernel - plain| <= tol + tol * |plain|
                    for name, a, b in zip("ml", outs[1:], refs[1:]):
                        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
                        res += (f", {name} max_abs_err="
                                f"{float((a - b).abs().max()):.3e}")
                log(f"[parity] {label} {dt}: max_abs_err={err:.3e}{res} "
                    f"(bound {tol:g})")
                if not err <= tol:
                    raise AssertionError(f"{kernel} {label} {dt}: error "
                                         f"{err} above {tol}")
                if dtype == torch.bfloat16:
                    rows[kernel].append(time_row(
                        label, dt, err, run, plain, sdpa, nbytes, flops,
                        layers, card))
    # the batched decode step: bf16 q (and output) over bf16 or fp8 caches;
    # the plain version takes the same max per chunk of the same plan and
    # the same rounding points
    tol = TOL[torch.bfloat16]
    for label, kernel, run, plain, sdpa, nbytes, flops, layers, note in \
            batched_cases(sh, dev):
        errs = []
        for layer in (0, layers - 1):
            out, ref = run(layer)[0], plain(layer)[0]
            torch.cuda.synchronize()
            errs.append(float((out.float() - ref.float()).abs().max()))
        err = max(errs)
        log(f"[parity] {label} bf16 (layers 0 and {layers - 1}): "
            f"max_abs_err={err:.3e} (bound {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: error {err} above {tol}")
        if label == KERNELS[kernel][2]:
            one_kernel_per_call(kernel, label, lambda: run(layers - 1))
        rows[kernel].append(time_row(label, "bfloat16", err, run, plain,
                                     sdpa, nbytes, flops, layers, card,
                                     note))
    # the slab-read probe: f32 sums of the same terms in another order;
    # its own time is phase 8's
    for label, run, plain, nbytes, layers in slab_cases(dev):
        out, ref = run(layers - 1), plain(layers - 1)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
        plain_ms = per_call_ms(plain, layers, PLAIN_ITERS)
        log(f"[parity] {label}: max_abs_err={err:.3e} (bound 1e-5 + "
            f"1e-5 relative); plain {plain_ms:.4f} ms (device) | {card}")
        if label == KERNELS["slab_reader"][2]:
            one_kernel_per_call("slab_reader", label,
                                lambda: run(layers - 1))
        rows["slab_reader"].append({
            "shape": label, "max_abs_err": err, "plain_ms": plain_ms,
            "library_ms": None, "bytes": nbytes})
    quant_kernel_rows(sh, dev, card, rows)
    ws_kernel_rows(sh, dev, card, rows)
    aligner_kernel_rows(sh, dev, card, rows)
    pool_kernel_rows(sh, dev, card, rows)
    stream_kernel_rows(sh, dev, card, rows)
    pool_kernel_rows(sh, dev, card, rows, group=True)
    spec_kernel_rows(sh, dev, card, rows)
    return rows


# -- phases 2 and 3: the kernels of the default configuration ---------------------

# (K, N) of the preset:1.7b decoder's projections and its tied lm_head,
# then the decoder's two grouped launches (one N a payload, one launch)
QGEMV_SHAPES = (("wq_wo", 2048, (2048,), "dec"),
                ("wk_wv", 2048, (1024,), "dec"),
                ("gate_up", 2048, (6144,), "dec"),
                ("down", 6144, (2048,), "dec"),
                ("lm_head", 2048, (151936,), "head"),
                ("qkv_group", 2048, (2048, 1024, 1024), "dec"),
                ("gate_up_group", 2048, (6144, 6144), "dec"))
QGEMV_ROWS = (1, 8, 16)
# Kernels A and C against their plain versions, by output dtype: (rtol,
# atol as a share of the largest |plain| value). Both sum in f32 in
# different orders (int4: each group's sum scaled, then added, in both);
# bf16 outputs may then round one ulp apart (rtol covers one bf16 ulp), f32
# logits differ only by the order of the sum.
QGEMV_TOL = {torch.bfloat16: (8e-3, 1e-4), torch.float32: (0.0, 1e-4)}
F32_FLOPS = 67e12                  # f32 CUDA-core peak (no tensor cores)


def qgemv_parity(label: str, outs, refs, kernel: str = "qgemv") -> float:
    """Kernel A's (or C's) outputs against its plain version's under
    ``QGEMV_TOL``: the largest error, or AssertionError."""
    err = 0.0
    for out, ref in zip(outs, refs):
        rtol, share = QGEMV_TOL[ref.dtype]
        atol = share * float(ref.float().abs().max())
        diff = (out.float() - ref.float()).abs()
        worst = float((diff - rtol * ref.float().abs()).max())
        err = max(err, float(diff.max()))
        if out.dtype != ref.dtype or not worst <= atol:
            raise AssertionError(f"{kernel} {label}: error "
                                 f"{float(diff.max())} outside rtol {rtol}, "
                                 f"atol {atol}")
    log(f"[parity] {kernel} {label}: max_abs_err={err:.3e} (bound "
        f"{QGEMV_TOL[refs[0].dtype][1]:g} x max|plain| + "
        f"{QGEMV_TOL[refs[0].dtype][0]:g} x |plain|, {refs[0].dtype})")
    return err


def quant_payloads(w: torch.Tensor, mode: str, head: bool):
    """(payload, row scales) of ``w`` (bf16, [..., in, out]; for the
    lm_head [V, H], quantized per vocab row as the tied embedding is), and
    the payload widened to bf16 without its scales (the library call's
    weight, [..., out, in])."""
    from qwen3_asr_tpu_torch.ops.qgemv import unpack_int4
    from qwen3_asr_tpu_torch.ops.quant import (quantize_array,
                                               quantize_embed, row_scales)
    leaf = quantize_embed(w, mode) if head else quantize_array(w, mode)
    q, s = leaf["q"], row_scales(leaf)
    wide = (unpack_int4(q) if q.dtype == torch.uint8 else q).to(
        torch.bfloat16)
    return q, s, wide


def payload_bytes(q: torch.Tensor, s: torch.Tensor) -> int:
    """Bytes of one layer's payload and scales (int4: half a byte a
    weight, and its group scales)."""
    return (q[0].numel() * q.element_size()
            + s[0].numel() * s.element_size())


def per_payload(fn, x, pays, out_dtype):
    """A call of ``fn(x, q, s, out_dtype=)`` on each payload of ``pays``
    at a layer: one output a payload."""
    return lambda layer: [fn(x, q[layer], s[layer], out_dtype=out_dtype)
                          for q, s in pays]


def quant_cases(dev, shapes, rows_of, layers, seed_mult, group, plain,
                earlier=None):
    """Cases of a quantized-product kernel (A or C) at each (name, K, Ns,
    where) of ``shapes`` and each row count of ``rows_of(where)``, int8,
    fp8 and int4 (the default group; G = 1 at the tied lm_head, where
    "head"), the weights a stack of ``layers`` (one for the head), each
    cold: (label, kernel call, plain call, library call, earlier call or
    None, bytes, flops, layers). ``group(x, pairs, out_dtype=)`` is the
    kernel's wrapper (one launch for all the payloads); ``plain`` and
    ``earlier`` (taken for int8/fp8 only) take one payload. Calls return a
    list of outputs. The library call is ONE ``F.linear`` on the payloads
    widened to bf16 (concatenated for a group)."""
    for mode in ("int8", "fp8", "int4"):
        for name, k, ns, where in shapes:
            gen = torch.Generator(device=dev).manual_seed(
                k + seed_mult * sum(ns))
            head = where == "head"
            n_layers = 1 if head else layers
            pays, wides = [], []
            for n in ns:
                w = (torch.randn((n, k) if head else (n_layers, k, n),
                                 generator=gen, device=dev) * 0.02).bfloat16()
                q, sc, wide = quant_payloads(w, mode, head)
                if head:
                    q, sc, wide = q[None], sc[None], wide[None]
                pays.append((q, sc))
                wides.append(wide)
                del w
            wide = torch.cat(wides, dim=1)
            del wides
            out_dtype = torch.float32 if head else torch.bfloat16
            out_size = 4 if head else 2
            n_all = sum(ns)
            nbytes = sum(payload_bytes(q, sc) for q, sc in pays)
            for m in rows_of(where):
                x = torch.randn((m, k), generator=gen,
                                device=dev).bfloat16()
                yield (f"{name}_m{m}_{mode}",
                       lambda layer, x=x, p=pays, o=out_dtype: group(
                           x, [(q[layer], s[layer]) for q, s in p],
                           out_dtype=o),
                       per_payload(plain, x, pays, out_dtype),
                       lambda layer, x=x, wide=wide: F.linear(x, wide[layer]),
                       None if earlier is None or mode == "int4" else
                       per_payload(earlier, x, pays, out_dtype),
                       nbytes + 2 * m * k + out_size * m * n_all,
                       2 * m * n_all * k, n_layers)
            del pays, wide


def qgemv_cases(sh, dev):
    """Kernel A at M = 1, 8 and 16 for each shape of ``QGEMV_SHAPES`` (a
    stack of the decoder's layers): plain ``qgemv_plain``, no earlier
    call."""
    from qwen3_asr_tpu_torch.ops.qgemv import qgemv_group, qgemv_plain
    return quant_cases(dev, QGEMV_SHAPES, lambda where: QGEMV_ROWS,
                       sh["layers"], 1, qgemv_group, qgemv_plain)


def qgemm_cases(sh, dev):
    """Kernel C at every shape of ``QGEMM_SHAPES`` (``tools_perf/
    step_ms.py``: kernel C's launches at preset:1.7b) and its row counts,
    the front graph's at B=1 (30 s) and B=8 (10 s), which must be
    ``QGEMM_ROWS``' (the rows step_ms.py times), and 32 decode rows at the
    lm_head: plain ``qgemm_plain`` (``widened_product`` for int8/fp8,
    JAX's grouped product restated for int4); earlier: the route kernel C
    replaced on the card, one ``widened_product`` a weight (int8/fp8 only:
    it never took int4)."""
    from qwen3_asr_tpu_torch.ops.qgemm import (qgemm_group, qgemm_plain,
                                               widened_product)
    from qwen3_asr_tpu_torch.tools_perf.step_ms import (QGEMM_LAYERS,
                                                        QGEMM_ROWS,
                                                        QGEMM_SHAPES)
    rows = {"dec": (sh["prompt_len"], sh["dec_rows_b8"]),
            "enc": (sh["enc_rows_b1"], sh["enc_rows_b8"]),
            "head": (32,)}
    if rows != QGEMM_ROWS:
        raise AssertionError(f"the front graph's rows {rows} are not "
                             f"step_ms.py's {QGEMM_ROWS}")
    return quant_cases(dev, QGEMM_SHAPES, rows.__getitem__, QGEMM_LAYERS, 3,
                       qgemm_group, qgemm_plain, widened_product)


def plan_note(kernel: str) -> dict:
    """Kernel C's plan of its last launch (x width, K splits, blocks), for
    the row and its log line; {} for other kernels."""
    if kernel != "qgemm":
        return {}
    from qwen3_asr_tpu_torch.ops.qgemm import qgemm
    p = qgemm.last_plan
    return {"plan": {"bm": p.bm, "splits": p.splits, "blocks": p.blocks}}


# The QK-norm + RoPE + KV-cache write against its plain chain: q and K
# within one ulp of their dtype, V's stored bytes equal (it is stored as
# it comes). The kernel sums the squares in the order of torch's own CUDA
# reduction, so the share of bit-equal values is expected at 100%.
QK_CACHES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn,
             "int4": torch.int4}
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float8_e4m3fn: torch.int8}


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their dtype, from the bits."""
    def key(x):
        bits = x.contiguous().view(_INT_VIEW[x.dtype]).long()
        mag = bits & ((1 << (8 * x.element_size() - 1)) - 1)
        return torch.where(bits < 0, -mag, mag)
    return (key(a) - key(b)).abs()


def qk_rope_kv_cases(sh, dev):
    """The QK-norm + RoPE + KV-cache write at the main path's shapes: a
    decode step (T=1, device position mid-cache) at B = 1, 8 (S=768) and
    96 (S=512), and the 30 s prefill (B=1, T=453 at host position 0),
    each into a stacked bf16, fp8 and int4 cache of 28 layers: (label,
    kernel call, plain call, the two caches, bytes, operations, layers).
    The calls take the layer and return q."""
    from qwen3_asr_tpu_torch.models.decoder import init_kv_cache, rope_cos_sin
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import (qk_rope_kv_write,
                                                    qk_rope_kv_write_plain)
    cfg = preset("1.7b").decoder
    nq, nkv, d, layers = sh["nq"], sh["nkv"], sh["d"], sh["layers"]
    for kv_name, kv in QK_CACHES.items():
        for batch, t, s_len in ((1, 1, sh["cache"]), (8, 1, sh["cache"]),
                                (96, 1, 512), (1, sh["prompt_len"],
                                               sh["cache"])):
            gen = torch.Generator(device=dev).manual_seed(batch + t)

            def rnd(*shape, scale=2.0, shift=0.0):
                return (torch.randn(shape, generator=gen, device=dev)
                        * scale + shift).bfloat16()

            q, k, v = (rnd(batch, t, n * d) for n in (nq, nkv, nkv))
            q_norm, k_norm = (rnd(d, scale=0.2, shift=1.0) for _ in range(2))
            cos, sin = rope_cos_sin(
                torch.randint(0, 4000, (batch, t), generator=gen,
                              device=dev), d, cfg.rope_theta)
            ours, ref = (init_kv_cache(cfg, batch, s_len, kv, dev)
                         for _ in range(2))
            pos = torch.tensor(s_len // 2, device=dev) if t == 1 else 0
            args = (q, k, v, q_norm, k_norm, cos, sin, cfg.rms_norm_eps)
            rows = batch * t
            stored = {"bf16": 2 * d, "fp8": d, "int4": d // 2 + 2}[kv_name]
            nbytes = (2 * rows * (nq + 2 * nkv) * d          # q, k, v
                      + 2 * 2 * d + 2 * 4 * rows * d          # norms, cos/sin
                      + (8 if t == 1 else 0)                  # the position
                      + 2 * rows * nq * d                     # q out
                      + 2 * rows * nkv * stored)              # K and V
            # per q/k element: square, add, two products for the norm, two
            # and an add for RoPE; per int4 element a divide, round, clip
            ops = (7 * rows * (nq + nkv) * d
                   + (4 * 2 * rows * nkv * d if kv_name == "int4" else 0))
            label = (f"qk_b{batch}_t{t}_{kv_name}" if t == 1
                     else f"qk_prefill_30s_{kv_name}")
            yield (label,
                   lambda layer, a=args, c=ours, p=pos: qk_rope_kv_write(
                       *a, c, layer, p),
                   lambda layer, a=args, c=ref, p=pos:
                       qk_rope_kv_write_plain(*a, c, layer, p),
                   ours, ref, nbytes, ops, layers)
            del ours, ref


def qk_parity(label: str, q, q_ref, ours, ref) -> float:
    """The kernel's q and cache against the plain chain's (rules above):
    returns q's largest absolute error, or AssertionError."""
    from qwen3_asr_tpu_torch.ops.kv_int4 import unpack
    q_ulps = ulps(q, q_ref)
    if ours.int4:
        k_n, k_ref = unpack(ours.k).int(), unpack(ref.k).int()
        k_ok = int((k_n - k_ref).abs().max()) <= 1 and int(
            ulps(ours.k_scale, ref.k_scale).max()) <= 1
        k_equal = float((k_n == k_ref).float().mean())
        v_ok = (torch.equal(ours.v, ref.v) and torch.equal(
            ours.v_scale.view(torch.int16), ref.v_scale.view(torch.int16)))
    else:
        k_ulps = ulps(ours.k, ref.k)
        k_ok, k_equal = int(k_ulps.max()) <= 1, float(
            (k_ulps == 0).float().mean())
        v_ok = torch.equal(ours.v.view(torch.uint8), ref.v.view(torch.uint8))
    err = float((q.float() - q_ref.float()).abs().max())
    log(f"[parity] qk_rope_kv {label}: q max_abs_err={err:.3e}, "
        f"{int(q_ulps.max())} ulp at most, bit-equal q "
        f"{float((q_ulps == 0).float().mean()):.4%}, K {k_equal:.4%}; V "
        f"{'byte-equal' if v_ok else 'DIFFERS'} (bound one ulp, nibbles "
        f"within 1; V exact)")
    if int(q_ulps.max()) > 1 or not k_ok or not v_ok:
        raise AssertionError(f"qk_rope_kv {label}: outside the bound")
    return err


def int4_batched_cases(sh, dev):
    """#3's int4 route at B=1 and B=8 (the 30 s cache, S=768, 570 live)
    and B=96 (S=512, 257 live): (label, kernel call, plain call, SDPA on a
    dequantized bf16 copy, bytes, flops, layers)."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched, decode_attention_batched_plain)
    from qwen3_asr_tpu_torch.ops.kv_int4 import dequantize_layer, pack
    nq, nkv, d, layers = sh["nq"], sh["nkv"], sh["d"], sh["layers"]
    vf30, vt30 = sh["valid_from"], sh["valid_from"] + 570
    for batch, s, vf0, vt0 in ((1, sh["cache"], vf30, vt30),
                               (8, sh["cache"], vf30, vt30),
                               (96, 512, 0, 257)):
        gen = torch.Generator(device=dev).manual_seed(batch + s)
        q = torch.randn((batch, nq, 1, d), generator=gen,
                        device=dev).bfloat16()
        lead = (layers, batch, nkv, s)
        k, v = (pack(torch.randint(-8, 8, lead + (d,), generator=gen,
                                   device=dev, dtype=torch.int8))
                for _ in range(2))
        ks, vs = ((torch.rand(lead + (1,), generator=gen, device=dev) * 0.3
                   + 0.01).bfloat16() for _ in range(2))
        kb = dequantize_layer(k, ks, torch.bfloat16)
        vb = dequantize_layer(v, vs, torch.bfloat16)
        vf = torch.full((batch,), vf0, dtype=torch.int32, device=dev)
        vt = torch.full((batch,), vt0, dtype=torch.int32, device=dev)
        mask = AttnSpec(valid_from=vf, valid_to=vt).dense_mask(batch, 1, s,
                                                               dev)
        live = vt0 - vf0
        yield (f"int4_b{batch}_s{s}",
               lambda layer, q=q, k=k, v=v, ks=ks, vs=vs, vf=vf, vt=vt: (
                   decode_attention_batched(q, k, v, layer_idx=layer,
                                            kv_valid_from=vf, kv_valid_to=vt,
                                            k_scale=ks, v_scale=vs),),
               lambda layer, q=q, k=k, v=v, ks=ks, vs=vs, vf=vf, vt=vt: (
                   decode_attention_batched_plain(
                       q, k, v, vf, vt, layer_idx=layer, sm_scale=d ** -0.5,
                       k_scale=ks, v_scale=vs),),
               lambda layer, q=q, kb=kb, vb=vb, mask=mask:
                   F.scaled_dot_product_attention(
                       q, kb[layer], vb[layer], attn_mask=mask[:, None],
                       enable_gqa=True),
               2 * batch * nq * d * 2 + 2 * batch * nkv * live * (d // 2 + 2)
               + 8 * batch, 4 * d * nq * batch * live, layers)
        del k, v, ks, vs, kb, vb


def same_bits(kernel: str, label: str, outs, again) -> None:
    """A repeat call's outputs must be the first call's bits (A's split-K
    combine and C add in a fixed order; neither has float atomics)."""
    if not all(torch.equal(a, b) for a, b in zip(outs, again)):
        raise AssertionError(f"{kernel} {label}: a repeat call changed the "
                             f"output bits")


def quant_kernel_rows(sh, dev, card, rows) -> None:
    """Parity (and repeat bits) and timing of kernels A and C, the
    QK-norm + RoPE + KV-cache write and #3's int4 route, each against its
    plain version; rows into ``rows``."""
    # one device kernel a call: each kernel's headline, a split-K call of
    # A (w_down at 16 rows: its combine is in the same launch) and grouped
    # calls, one-byte and int4 payloads
    one_call = {"qgemv": (KERNELS["qgemv"][2], "down_m16_int8",
                          "qkv_group_m8_int8", "lm_head_m1_int4",
                          "down_m16_int4", "gate_up_group_m8_int4"),
                "qgemm": (KERNELS["qgemm"][2], "gate_up_group_m453_int8",
                          "enc_fc1_m375_fp8", "lm_head_m32_int4")}
    for kernel, cases in (("qgemv", qgemv_cases(sh, dev)),
                          ("qgemm", qgemm_cases(sh, dev))):
        for label, run, plain, lib, earlier, nbytes, flops, layers in cases:
            last = layers - 1
            outs, refs = run(last), plain(last)
            torch.cuda.synchronize()
            note = plan_note(kernel)
            err = qgemv_parity(label, outs, refs, kernel=kernel)
            same_bits(kernel, label, outs, run(last))
            del outs, refs
            if label in one_call[kernel]:
                one_kernel_per_call(kernel, label, lambda: run(last))
            row = time_row(label, "bfloat16", err, run, plain, lib, nbytes,
                           flops, layers, card, " (bf16-widened weight)",
                           "F.linear",
                           f"; plan {note['plan']}" if note else "")
            row.update(note)
            row["earlier_ms"] = None
            if earlier is not None:
                row["earlier_ms"] = per_call_ms(earlier, layers,
                                                PLAIN_ITERS)
                log(f"[timing] {kernel} {label}: the route it replaced "
                    f"(widened_product: the payload widened, then cuBLAS) "
                    f"{row['earlier_ms']:.4f} ms; kernel / earlier "
                    f"{row['ms'] / row['earlier_ms']:.3f} | {card}")
            rows[kernel].append(row)
    for label, run, plain, ours, ref, nbytes, ops, layers in \
            qk_rope_kv_cases(sh, dev):
        q, q_ref = run(layers - 1), plain(layers - 1)
        torch.cuda.synchronize()
        err = qk_parity(label, q, q_ref, ours, ref)
        del q, q_ref
        if label == KERNELS["qk_rope_kv"][2]:
            one_kernel_per_call("qk_rope_kv", label,
                                lambda: run(layers - 1))
        ms = per_call_ms(run, layers)
        plain_ms = per_call_ms(plain, layers, PLAIN_ITERS)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        earlier = EARLIER_MS.get(label)
        log(f"[timing] qk_rope_kv {label} (device): kernel {ms:.4f} ms, "
            f"plain chain {plain_ms:.4f} ms (graph replays; kernel / plain "
            f"{ms / plain_ms:.3f})"
            + (f"; kernel B alone before the redesign, PERF.md: "
               f"{earlier:.4f} ms" if earlier else "")
            + f"; bound {bound:.6f} ms ({nbytes} bytes), share "
            f"{bound / ms:.2%}; no library call | {card}")
        rows["qk_rope_kv"].append({
            "shape": label, "dtype": "bfloat16", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes})
        del ours, ref
    tol = TOL[torch.bfloat16]
    for label, run, plain, sdpa, nbytes, flops, layers in \
            int4_batched_cases(sh, dev):
        errs = []
        for layer in (0, layers - 1):
            out, ref = run(layer)[0], plain(layer)[0]
            torch.cuda.synchronize()
            errs.append(float((out.float() - ref.float()).abs().max()))
        err = max(errs)
        log(f"[parity] decode_attention_batch int4 {label} (layers 0 and "
            f"{layers - 1}): max_abs_err={err:.3e} (bound {tol:g})")
        if not err <= tol:
            raise AssertionError(f"int4 {label}: error {err} above {tol}")
        if label == KERNELS["decode_attention_batch_int4"][2]:
            one_kernel_per_call("decode_attention_batch_int4", label,
                                lambda: run(layers - 1))
        rows["decode_attention_batch_int4"].append(time_row(
            label, "bfloat16", err, run, plain, sdpa, nbytes, flops, layers,
            card, " on a dequantized bf16 copy"))


# -- phases 2 and 3: the real-time path's shapes (resume) ---------------------------

def ws_bucket_shapes():
    """(prompt length, max_new, cache length) of preset:1.7b's 1 s and 6 s
    buckets: a WS tick's shortest and longest windows at the 6 s cap."""
    from qwen3_asr_tpu_torch.models.asr import PromptTemplate
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.encoder import encoder_output_length
    from qwen3_asr_tpu_torch.runtime.engine import (PREFIX_BUDGET,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.generate import cache_length
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    tok = preset_tokenizer(cfg.decoder.vocab_size)
    suffix = len(tok.encode(PromptTemplate().suffix_text()))
    chunk = cfg.encoder.n_window * 2
    out = {}
    for sec in (1, 6):
        frames = -(-sec * 100 // chunk) * chunk
        plen = (PREFIX_BUDGET + int(encoder_output_length(frames, chunk))
                + suffix)
        max_new = max_new_tokens_for(frames / 100)
        out[sec] = (plen, max_new, cache_length(plen, max_new))
    return out


def verify_flash_cases(sh, ws, dtype, dev):
    """Flash at resume's verify windows: T queries at q_offset = the
    prompt's length, causal over the whole cache, some rows left-padded
    further: T = 24 (a partial tile) and 32 (the 1 s bucket's max_new) at
    the 1 s prompt, 64 at the 6 s prompt; B = 1 and 4. make_cases' tuple."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    nq, nkv, d = sh["nq"], sh["nkv"], sh["d"]
    esize = torch.tensor([], dtype=dtype).element_size()
    vf0 = sh["valid_from"]
    for t, sec in ((24, 1), (ws[1][1], 1), (ws[6][1], 6)):
        plen, _, s = ws[sec]
        for batch in (1, 4):
            gen = torch.Generator(device=dev).manual_seed(t + batch)
            q = torch.randn((batch, nq, t, d), generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn((batch, nkv, s, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            vfs = [vf0, vf0 + 28, 0, vf0][:batch]
            vf = torch.tensor(vfs, dtype=torch.int32, device=dev)
            vt = torch.full((batch,), s, dtype=torch.int32, device=dev)
            qo = torch.full((batch,), plen, dtype=torch.int32, device=dev)
            mask = AttnSpec(causal=True, q_offset=qo, valid_from=vf
                            ).dense_mask(batch, t, s, dev)
            keys = sum(plen + t - x for x in vfs)
            yield (f"verify_t{t}_{sec}s_b{batch}", "flash_attention",
                   lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo:
                       flash_attention(q, k, v, causal=True, q_offset=qo,
                                       kv_valid_from=vf, kv_valid_to=vt,
                                       return_residuals=True),
                   lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo:
                       flash_attention_plain(q, k, v, vf, vt, qo, causal=True,
                                             window_block=0,
                                             sm_scale=d ** -0.5),
                   lambda q=q, k=k, v=v, mask=mask:
                       F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask[:, None],
                           enable_gqa=True),
                   (2 * batch * nq * t * d + 2 * nkv * keys * d) * esize
                   + 2 * 4 * batch * nq * t + 3 * 4 * batch,
                   4 * d * nq * int(mask.sum()), 0)


def qk_row_cases(sh, dev, shapes=None, caches=None):
    """Kernel B with one write position a row (the resume loop's
    continuation and a verify window): T=1 at B=8 (S=256, one row at S,
    which writes nothing) and B=96 (S=512), T=64 at B=4 (S=256), into
    bf16, fp8 and int4 caches of 28 layers, or the (B, T, S, positions)
    ``shapes`` into ``caches``: qk_rope_kv_cases' tuple."""
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.decoder import init_kv_cache, rope_cos_sin
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import (qk_rope_kv_write,
                                                    qk_rope_kv_write_plain)
    cfg = preset("1.7b").decoder
    nq, nkv, d, layers = sh["nq"], sh["nkv"], sh["d"], sh["layers"]
    shapes = shapes or (
        (8, 1, 256, [153, 160, 200, 17, 254, 255, 100, 256]),
        (96, 1, 512, [(37 * i) % 512 for i in range(96)]),
        (4, 64, 256, [153, 100, 192, 12]))
    for kv_name, kv in (caches or QK_CACHES).items():
        for batch, t, s_len, pos in shapes:
            gen = torch.Generator(device=dev).manual_seed(batch + t + 7)

            def rnd(*shape, scale=2.0, shift=0.0):
                return (torch.randn(shape, generator=gen, device=dev)
                        * scale + shift).bfloat16()

            q, k, v = (rnd(batch, t, n * d) for n in (nq, nkv, nkv))
            q_norm, k_norm = (rnd(d, scale=0.2, shift=1.0) for _ in range(2))
            where = torch.tensor(pos, dtype=torch.int64, device=dev)
            cos, sin = rope_cos_sin(
                where[:, None] + torch.arange(t, device=dev), d,
                cfg.rope_theta)
            ours, ref = (init_kv_cache(cfg, batch, s_len, kv, dev)
                         for _ in range(2))
            args = (q, k, v, q_norm, k_norm, cos, sin, cfg.rms_norm_eps)
            rows = batch * t
            stored = {"bf16": 2 * d, "fp8": d, "int4": d // 2 + 2}[kv_name]
            nbytes = (2 * rows * (nq + 2 * nkv) * d + 2 * 2 * d
                      + 2 * 4 * rows * d + 8 * batch + 2 * rows * nq * d
                      + 2 * rows * nkv * stored)
            ops = (7 * rows * (nq + nkv) * d
                   + (4 * 2 * rows * nkv * d if kv_name == "int4" else 0))
            yield (f"qk_rows_b{batch}_t{t}_{kv_name}",
                   lambda layer, a=args, c=ours, p=where: qk_rope_kv_write(
                       *a, c, layer, p),
                   lambda layer, a=args, c=ref, p=where:
                       qk_rope_kv_write_plain(*a, c, layer, p),
                   ours, ref, nbytes, ops, layers)
            del ours, ref


def row_valid_to_cases(sh, ws, dev):
    """#3 at a tick's continuation: B = 4 and 8 rows of the 6 s bucket's
    cache (S=256), each at its own frontier (valid_to per row), bf16 and
    int4 caches: (kernel, label, run, plain, SDPA, bytes, flops, layers,
    note)."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched, decode_attention_batched_plain)
    from qwen3_asr_tpu_torch.ops.kv_int4 import dequantize_layer, pack
    nq, nkv, d, layers = sh["nq"], sh["nkv"], sh["d"], sh["layers"]
    plen, _, s = ws[6]
    for batch in (4, 8):
        for kv in ("bf16", "int4"):
            gen = torch.Generator(device=dev).manual_seed(batch + 11)
            q = torch.randn((batch, nq, 1, d), generator=gen,
                            device=dev).bfloat16()
            lead = (layers, batch, nkv, s)
            vf0 = [sh["valid_from"], 0, 40, sh["valid_from"]] * 2
            vt0 = [plen + x for x in (1, 9, 30, 64, 5, 17, 48, 2)]
            vf = torch.tensor(vf0[:batch], dtype=torch.int32, device=dev)
            vt = torch.tensor(vt0[:batch], dtype=torch.int32, device=dev)
            live = sum(b - a for a, b in zip(vf0[:batch], vt0[:batch]))
            if kv == "int4":
                k, v = (pack(torch.randint(-8, 8, lead + (d,), generator=gen,
                                           device=dev, dtype=torch.int8))
                        for _ in range(2))
                ks, vs = ((torch.rand(lead + (1,), generator=gen,
                                      device=dev) * 0.3 + 0.01).bfloat16()
                          for _ in range(2))
                kb = dequantize_layer(k, ks, torch.bfloat16)
                vb = dequantize_layer(v, vs, torch.bfloat16)
                per_key = d // 2 + 2
            else:
                k, v = (torch.randn(lead + (d,), generator=gen,
                                    device=dev).bfloat16()
                        for _ in range(2))
                ks = vs = None
                kb, vb = k, v
                per_key = 2 * d
            mask = AttnSpec(valid_from=vf, valid_to=vt).dense_mask(
                batch, 1, s, dev)
            kernel = ("decode_attention_batch_int4" if kv == "int4"
                      else "decode_attention_batch")
            yield (kernel, f"rows_b{batch}_s{s}_{kv}",
                   lambda layer, q=q, k=k, v=v, ks=ks, vs=vs, vf=vf, vt=vt: (
                       decode_attention_batched(
                           q, k, v, layer_idx=layer, kv_valid_from=vf,
                           kv_valid_to=vt, k_scale=ks, v_scale=vs),),
                   lambda layer, q=q, k=k, v=v, ks=ks, vs=vs, vf=vf, vt=vt: (
                       decode_attention_batched_plain(
                           q, k, v, vf, vt, layer_idx=layer,
                           sm_scale=d ** -0.5, k_scale=ks, v_scale=vs),),
                   lambda layer, q=q, kb=kb, vb=vb, mask=mask:
                       F.scaled_dot_product_attention(
                           q, kb[layer], vb[layer], attn_mask=mask[:, None],
                           enable_gqa=True),
                   2 * batch * nq * d * 2 + 2 * nkv * live * per_key
                   + 8 * batch, 4 * d * nq * live, layers,
                   " on a dequantized bf16 copy" if kv == "int4" else "")
            del k, v, kb, vb


def ws_kernel_rows(sh, dev, card, rows) -> None:
    """Parity (phase 2) and timing (phase 3) of the kernels at the shapes
    the real-time path gives them: flash at the verify windows (f32 and
    bf16; bf16 timed), kernel B with a [B] write position (bit-equal share
    printed; a repeat call's bits), and #3 with per-row valid_to."""
    ws = ws_bucket_shapes()
    log(f"[shapes] WS buckets (prompt, max_new, cache): {ws}")
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        dt = str(dtype).replace("torch.", "")
        for label, kernel, run, plain, sdpa, nbytes, flops, layers in \
                verify_flash_cases(sh, ws, dtype, dev):
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            err = float((outs[0].float() - refs[0].float()).abs().max())
            for a, b in zip(outs[1:], refs[1:]):
                torch.testing.assert_close(a, b, atol=tol, rtol=tol)
            same_bits(kernel, label, outs, run())
            log(f"[parity] {label} {dt}: max_abs_err={err:.3e} (bound "
                f"{tol:g}); m and l within it; a repeat call's bits equal")
            if not err <= tol:
                raise AssertionError(f"{kernel} {label} {dt}: error {err} "
                                     f"above {tol}")
            if dtype == torch.bfloat16:
                if label == "verify_t64_6s_b4":
                    one_kernel_per_call(kernel, label, run)
                rows[kernel].append(time_row(label, dt, err, run, plain,
                                             sdpa, nbytes, flops, layers,
                                             card))
    qk_row_rows(qk_row_cases(sh, dev), card, rows,
                headline="qk_rows_b8_t1_int4")
    tol = TOL[torch.bfloat16]
    for kernel, label, run, plain, sdpa, nbytes, flops, layers, note in \
            row_valid_to_cases(sh, ws_bucket_shapes(), dev):
        errs = []
        for layer in (0, layers - 1):
            out, ref = run(layer)[0], plain(layer)[0]
            torch.cuda.synchronize()
            errs.append(float((out.float() - ref.float()).abs().max()))
        err = max(errs)
        same_bits(kernel, label, run(layers - 1), run(layers - 1))
        log(f"[parity] {kernel} {label} (per-row valid_to, layers 0 and "
            f"{layers - 1}): max_abs_err={err:.3e} (bound {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: error {err} above "
                                 f"{tol}")
        rows[kernel].append(time_row(label, "bfloat16", err, run, plain,
                                     sdpa, nbytes, flops, layers, card,
                                     note))


def qk_row_rows(cases, card, rows, headline=None, tag="") -> None:
    """Kernel B per row: each case against its plain chain (q and K within
    one ulp, V's bytes equal), a repeat call's bits, its device ms beside
    the plain chain's and the bound; ``headline`` also records one kernel
    per call."""
    for label, run, plain, ours, ref, nbytes, ops, layers in cases:
        q, q_ref = run(layers - 1), plain(layers - 1)
        torch.cuda.synchronize()
        err = qk_parity(label, q, q_ref, ours, ref)
        planes = [p.clone() for p in ours if p is not None]
        same_bits("qk_rope_kv", label, [q], [run(layers - 1)])
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(planes, (p for p in ours
                                            if p is not None))):
            raise AssertionError(f"qk_rope_kv {label}: a repeat call "
                                 f"changed the cache's bits")
        del q, q_ref, planes
        if label == headline:
            one_kernel_per_call("qk_rope_kv", label,
                                lambda: run(layers - 1),
                                also=("qk_rope_kv_per_row",))
        ms = per_call_ms(run, layers)
        plain_ms = per_call_ms(plain, layers, PLAIN_ITERS)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"[timing] qk_rope_kv {label}{tag} (device, one position a "
            f"row): kernel {ms:.4f} ms, plain chain {plain_ms:.4f} ms "
            f"(kernel / plain {ms / plain_ms:.3f}); bound {bound:.6f} ms "
            f"({nbytes} bytes), share {bound / ms:.2%}; no library call | "
            f"{card}")
        rows["qk_rope_kv"].append({
            "shape": label, "dtype": "bfloat16", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes})
        del ours, ref


POOL_WINDOWS = (8, 16, 32)      # the decode pool's window ladder at defaults


def pool_row_cases(sh, dev, group: bool = False):
    """#3 at the decode pool's segment: windows of 8, 16 and 32 rows of the
    pool cache (S = 768 at preset:1.7b), every row at its own place: rows
    of the 30, 15 and 10 s buckets in turn (their prompt lengths), each at
    its own point of its budget, with the left pads of two prompt
    prefixes; bf16 and fp8 caches: (kernel, label, run, plain, SDPA,
    bytes, flops, layers, note). With ``group``: the grouped WS mode's
    continuation instead, 8 slots of the 30 s cap's prompt (453), each
    row at its own frontier."""
    from qwen3_asr_tpu_torch.models.asr import PromptTemplate
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.encoder import encoder_output_length
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched, decode_attention_batched_plain)
    from qwen3_asr_tpu_torch.runtime.engine import (PREFIX_BUDGET,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    suffix = len(preset_tokenizer(cfg.decoder.vocab_size).encode(
        PromptTemplate().suffix_text()))
    chunk = cfg.encoder.n_window * 2
    nq, nkv, d, layers = sh["nq"], sh["nkv"], sh["d"], sh["layers"]
    s = sh["cache"]
    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    for batch in ((GROUP_SLOTS,) if group else POOL_WINDOWS):
        vf0, vt0 = [], []
        for r in range(batch):
            sec = 30 if group else (30, 15, 10)[r % 3]
            plen = (PREFIX_BUDGET + suffix
                    + int(encoder_output_length(sec * 100, chunk)))
            vf0.append(sh["valid_from"] - 6 * (r % 2))
            vt0.append(plen + 1 + (r * 37) % max_new_tokens_for(sec))
        live = sum(b - a for a, b in zip(vf0, vt0))
        for kv_dtype in (bf16, fp8):
            gen = torch.Generator(device=dev).manual_seed(batch + 23)
            q = torch.randn((batch, nq, 1, d), generator=gen,
                            device=dev).to(bf16)
            k, v = (torch.randn((layers, batch, nkv, s, d), generator=gen,
                                device=dev).to(kv_dtype) for _ in range(2))
            vf = torch.tensor(vf0, dtype=torch.int32, device=dev)
            vt = torch.tensor(vt0, dtype=torch.int32, device=dev)
            kb, vb = (k, v) if kv_dtype == bf16 else (k.to(bf16), v.to(bf16))
            mask = AttnSpec(valid_from=vf, valid_to=vt).dense_mask(
                batch, 1, s, dev)
            yield ("decode_attention_batch",
                   f"{'group' if group else 'pool'}_b{batch}_s{s}_"
                   f"{KV_NAMES[kv_dtype]}",
                   lambda layer, q=q, k=k, v=v, vf=vf, vt=vt: (
                       decode_attention_batched(q, k, v, layer_idx=layer,
                                                kv_valid_from=vf,
                                                kv_valid_to=vt),),
                   lambda layer, q=q, k=k, v=v, vf=vf, vt=vt: (
                       decode_attention_batched_plain(
                           q, k, v, vf, vt, layer_idx=layer,
                           sm_scale=d ** -0.5),),
                   lambda layer, q=q, kb=kb, vb=vb, mask=mask:
                       F.scaled_dot_product_attention(
                           q, kb[layer], vb[layer], attn_mask=mask[:, None],
                           enable_gqa=True),
                   2 * batch * nq * d * 2
                   + 2 * nkv * live * d * k.element_size() + 8 * batch,
                   4 * d * nq * live, layers,
                   "" if kv_dtype == bf16 else " on a bf16 copy of the cache")
            del k, v, kb, vb


def pool_kernel_rows(sh, dev, card, rows, group: bool = False) -> None:
    """Parity (phase 2) and timing (phase 3) of #3 at the decode pool's
    shapes (``pool_row_cases``), or with ``group`` at the grouped WS
    mode's."""
    tol = TOL[torch.bfloat16]
    for kernel, label, run, plain, sdpa, nbytes, flops, layers, note in \
            pool_row_cases(sh, dev, group):
        errs = []
        for layer in (0, layers - 1):
            out, ref = run(layer)[0], plain(layer)[0]
            torch.cuda.synchronize()
            errs.append(float((out.float() - ref.float()).abs().max()))
        err = max(errs)
        same_bits(kernel, label, run(layers - 1), run(layers - 1))
        log(f"[parity] {kernel} {label} (per-row valid_from and valid_to, "
            f"layers 0 and {layers - 1}): max_abs_err={err:.3e} (bound "
            f"{tol:g}); a repeat call's bits equal")
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: error {err} above "
                                 f"{tol}")
        rows[kernel].append(time_row(label, "bfloat16", err, run, plain,
                                     sdpa, nbytes, flops, layers, card,
                                     note))


ALIGNER_SECONDS = (60, 120, 300)    # the aligner's 30 s steps timed


def aligner_flash_cases(sh, dtype, dev):
    """Flash at the forced aligner's encoder: B=1, the encoder's 20 heads
    × 64, T = 25 tokens a 2 s chunk of mel (750, 1500 and 3750 at 60, 120
    and 300 s), windows of 50, ``valid_to`` = T. make_cases' tuple."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    h, d, w = sh["enc_heads"], sh["enc_d"], sh["window"]
    esize = torch.tensor([], dtype=dtype).element_size()
    for sec in ALIGNER_SECONDS:
        t = sh["t_enc"] * sec // 30
        gen = torch.Generator(device=dev).manual_seed(sec)
        q, k, v = (torch.randn((1, h, t, d), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        vt = torch.full((1,), t, dtype=torch.int32, device=dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        mask = AttnSpec(window_block=w, valid_to=vt).dense_mask(1, t, t, dev)
        yield (f"aligner_{sec}s", "flash_attention",
               lambda q=q, k=k, v=v, vt=vt, zero=zero: flash_attention(
                   q, k, v, q_offset=zero, kv_valid_from=zero,
                   kv_valid_to=vt, window_block=w, return_residuals=True),
               lambda q=q, k=k, v=v, vt=vt, zero=zero: flash_attention_plain(
                   q, k, v, zero, vt, zero, causal=False, window_block=w,
                   sm_scale=d ** -0.5),
               lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=mask[:, None]),
               4 * h * t * d * esize + 2 * 4 * h * t + 3 * 4,
               4 * d * h * int(mask.sum()), 0)


def aligner_kernel_rows(sh, dev, card, rows) -> None:
    """Parity (phase 2, f32 and bf16, a repeat call's bits) and timing
    (phase 3, bf16) of flash at the forced aligner's encoder lengths."""
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        dt = str(dtype).replace("torch.", "")
        for label, kernel, run, plain, sdpa, nbytes, flops, layers in \
                aligner_flash_cases(sh, dtype, dev):
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            err = float((outs[0].float() - refs[0].float()).abs().max())
            for a, b in zip(outs[1:], refs[1:]):
                torch.testing.assert_close(a, b, atol=tol, rtol=tol)
            same_bits(kernel, label, outs, run())
            del refs
            log(f"[parity] {label} {dt} (T={outs[0].shape[2]}): "
                f"max_abs_err={err:.3e} (bound {tol:g}); m and l within it; "
                f"a repeat call's bits equal")
            if not err <= tol:
                raise AssertionError(f"{kernel} {label} {dt}: error {err} "
                                     f"above {tol}")
            if dtype == torch.bfloat16:
                if label == "aligner_300s":
                    one_kernel_per_call(kernel, label, run)
                rows[kernel].append(time_row(label, dt, err, run, plain,
                                             sdpa, nbytes, flops, layers,
                                             card))
            del outs
            torch.cuda.empty_cache()


STREAM_SEGMENTS = (64, 389)     # segment prefills timed: T at the 30 s cap
GROUP_SLOTS = 8                 # the grouped mode's default slots


def stream_flash_cases(sh, dtype, dev):
    """Flash at the prefix mode's shapes (``runtime/stream.py``, a 30 s
    cap): the segment prefill, T = 64 (a tail tick, q_offset = 389) and
    T = 389 (a rebuild from 64), causal at q_offset = P - T over the whole
    cache (S=768), left-padded from valid_from; and one encoder block,
    [1, 20, 50, 64] and the last, half block [1, 20, 25, 64], windows of
    50. make_cases' tuple."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    nq, nkv, d, s, plen = (sh["nq"], sh["nkv"], sh["d"], sh["cache"],
                           sh["prompt_len"])
    esize = torch.tensor([], dtype=dtype).element_size()
    vf0 = sh["valid_from"]
    for t in STREAM_SEGMENTS:
        gen = torch.Generator(device=dev).manual_seed(t)
        q = torch.randn((1, nq, t, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((1, nkv, s, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        off = plen - t
        vf = torch.full((1,), vf0, dtype=torch.int32, device=dev)
        vt = torch.full((1,), s, dtype=torch.int32, device=dev)
        qo = torch.full((1,), off, dtype=torch.int32, device=dev)
        mask = AttnSpec(causal=True, q_offset=off, valid_from=vf
                        ).dense_mask(1, t, s, dev)
        yield (f"segment_prefill_t{t}", "flash_attention",
               lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo: flash_attention(
                   q, k, v, causal=True, q_offset=qo, kv_valid_from=vf,
                   kv_valid_to=vt, return_residuals=True),
               lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo:
                   flash_attention_plain(q, k, v, vf, vt, qo, causal=True,
                                         window_block=0, sm_scale=d ** -0.5),
               lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask[:, None], enable_gqa=True),
               (2 * nq * t * d + 2 * nkv * (plen - vf0) * d) * esize
               + 2 * 4 * nq * t + 3 * 4,
               4 * d * nq * int(mask.sum()), 0)
        del k, v
    # the grouped mode's segment prefill: every slot's row from one rung,
    # B=8, each row left-padded from its own prefix's valid_from
    batch = GROUP_SLOTS
    for t in STREAM_SEGMENTS:
        gen = torch.Generator(device=dev).manual_seed(t + batch)
        q = torch.randn((batch, nq, t, d), generator=gen,
                        device=dev).to(dtype)
        k, v = (torch.randn((batch, nkv, s, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        off = plen - t
        rows_vf = [vf0 - 6 * (r % 2) - 9 * (r % 3 == 2) for r in range(batch)]
        vf = torch.tensor(rows_vf, dtype=torch.int32, device=dev)
        vt = torch.full((batch,), s, dtype=torch.int32, device=dev)
        qo = torch.full((batch,), off, dtype=torch.int32, device=dev)
        mask = AttnSpec(causal=True, q_offset=off, valid_from=vf
                        ).dense_mask(batch, t, s, dev)
        yield (f"group_segment_prefill_b{batch}_t{t}", "flash_attention",
               lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo: flash_attention(
                   q, k, v, causal=True, q_offset=qo, kv_valid_from=vf,
                   kv_valid_to=vt, return_residuals=True),
               lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo:
                   flash_attention_plain(q, k, v, vf, vt, qo, causal=True,
                                         window_block=0, sm_scale=d ** -0.5),
               lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask[:, None], enable_gqa=True),
               (2 * batch * nq * t * d
                + 2 * nkv * sum(plen - x for x in rows_vf) * d) * esize
               + 2 * 4 * batch * nq * t + 3 * 4 * batch,
               4 * d * nq * int(mask.sum()), 0)
        del k, v
    h, d, w = sh["enc_heads"], sh["enc_d"], sh["window"]
    for t in (w, w // 2):
        gen = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn((1, h, t, d), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        vt = torch.full((1,), t, dtype=torch.int32, device=dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        mask = AttnSpec(window_block=w, valid_to=vt).dense_mask(1, t, t, dev)
        yield (f"encoder_block_t{t}", "flash_attention",
               lambda q=q, k=k, v=v, vt=vt, zero=zero: flash_attention(
                   q, k, v, q_offset=zero, kv_valid_from=zero,
                   kv_valid_to=vt, window_block=w, return_residuals=True),
               lambda q=q, k=k, v=v, vt=vt, zero=zero: flash_attention_plain(
                   q, k, v, zero, vt, zero, causal=False, window_block=w,
                   sm_scale=d ** -0.5),
               lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(q, k, v,
                                                  attn_mask=mask[:, None]),
               4 * h * t * d * esize + 2 * 4 * h * t + 3 * 4,
               4 * d * h * int(mask.sum()), 0)


def stream_kernel_rows(sh, dev, card, rows) -> None:
    """Parity (phase 2, f32 and bf16, a repeat call's bits) and timing
    (phase 3, bf16) of flash at the prefix mode's shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[dtype]
        dt = str(dtype).replace("torch.", "")
        for label, kernel, run, plain, sdpa, nbytes, flops, layers in \
                stream_flash_cases(sh, dtype, dev):
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            err = float((outs[0].float() - refs[0].float()).abs().max())
            for a, b in zip(outs[1:], refs[1:]):
                torch.testing.assert_close(a, b, atol=tol, rtol=tol)
            same_bits(kernel, label, outs, run())
            log(f"[parity] {label} {dt}: max_abs_err={err:.3e} (bound "
                f"{tol:g}); m and l within it; a repeat call's bits equal")
            if not err <= tol:
                raise AssertionError(f"{kernel} {label} {dt}: error {err} "
                                     f"above {tol}")
            if dtype == torch.bfloat16:
                if label == "segment_prefill_t64":
                    one_kernel_per_call(kernel, label, run)
                rows[kernel].append(time_row(label, dt, err, run, plain,
                                             sdpa, nbytes, flops, layers,
                                             card))
            del outs, refs


# -- phase 4 ---------------------------------------------------------------------

@contextlib.contextmanager
def serving(manager):
    """The port's HTTP server for ``manager`` on 127.0.0.1 (an ephemeral
    port); yields the transcription URL, and stops both afterwards."""
    from qwen3_asr_tpu_torch.serving.server import build_server
    manager.start()
    server = build_server(manager, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield (f"http://127.0.0.1:{server.server_address[1]}"
               "/v1/audio/transcriptions")
    finally:
        server.shutdown()
        server.server_close()
        manager.stop()
        thread.join(timeout=30)


def post_all(url: str, bodies):
    """POST every body at once, one thread each: ([response], [wall s])."""
    def one(data):
        t0 = time.perf_counter()
        body = post(url, data)
        return body, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        out = list(pool.map(one, bodies))
    return [b for b, _ in out], [w for _, w in out]


def real_text_phase(dev):
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
    from qwen3_asr_tpu_torch.serving.server import merge_results
    from qwen3_asr_tpu_torch.text.repetition import detect_and_fix_repetitions
    ckpt = os.path.join(DATA, "trained_ckpt")
    gpu = load_engine(ckpt, device=dev, dtype=torch.float32)
    cpu = load_engine(ckpt, device="cpu")
    counter = PathLaunches(gpu)
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))
    wavs, refs = [], []
    for path in clips:
        with open(path, "rb") as f:
            wavs.append(f.read())
        audio, sr = decode_audio(wavs[-1])
        ours = gpu.transcribe(audio, sr)[0]
        refs.append(cpu.transcribe(audio, sr))
        ref = refs[-1][0]
        with open(path[:-4] + ".txt", encoding="utf-8") as f:
            want = f.read().strip()
        if ours.token_ids != ref.token_ids or ours.text != want:
            raise AssertionError(f"{os.path.basename(path)}: card "
                                 f"{ours.text!r} vs cpu {ref.text!r} vs "
                                 f"reference {want!r}")
    launches, eager = counter.read()
    log(f"[real] trained_ckpt f32: {len(clips)}/{len(clips)} clips "
        f"token-identical to the CPU and equal to the transcripts; launches "
        f"{launches} ({eager} of them eager: the warm-up runs of "
        f"{len(gpu.executables)} keys built on first use)")
    if not (launches["flash_attention"] and launches["decode_attention"]
            and launches["qk_rope_kv"]):
        raise AssertionError("a kernel was not launched on the real-text run")

    # All 12 at once: through the server (texts), then straight through
    # the batcher the server calls (token ids), each against the CPU solo.
    manager = ModelManager(gpu)
    manager.batcher = MicroBatcher(manager, window_ms=500, max_batch=8)
    with serving(manager) as url:
        bodies, _ = post_all(url, wavs)
        by_http = manager.batcher.dispatches
        futures = [manager.batcher.transcribe(*decode_audio(w), None)
                   for w in wavs]
        batched = [f.result(timeout=600)[0] for f in futures]
        direct = manager.batcher.dispatches - by_http
    wants = []
    for path, body, res, ref in zip(clips, bodies, batched, refs):
        text, lang = merge_results(ref)
        want = {"text": detect_and_fix_repetitions(text), "language": lang}
        wants.append(want)
        if body != want or res.token_ids != ref[0].token_ids:
            raise AssertionError(f"{os.path.basename(path)} at batch: "
                                 f"{body} / {res.token_ids} vs cpu solo "
                                 f"{want} / {ref[0].token_ids}")
    log(f"[real] {len(clips)} clips at once through the server, then "
        f"straight through the batcher: texts and token ids equal to the "
        f"CPU's solo ones, in {by_http} and {direct} dispatches")
    if max(by_http, direct) >= len(clips):
        raise AssertionError(f"{by_http}/{direct} dispatches for "
                             f"{len(clips)} clips: nothing batched")
    check_records(gpu, "trained_ckpt f32")
    # for phase 12 (a): the engine, the uploads, their answers and ids
    return gpu, wavs, wants, [ref[0].token_ids for ref in refs]


# -- phase 5 ---------------------------------------------------------------------

def full_width_model(dev):
    """preset:1.7b in bf16 with random weights from seed 0."""
    from qwen3_asr_tpu_torch.models.asr import AsrModel
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
    from qwen3_asr_tpu_torch.models.encoder import init_encoder_params
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {
        "encoder": init_encoder_params(cfg.encoder, gen, dev, torch.bfloat16),
        "decoder": init_decoder_params(cfg.decoder, gen, dev, torch.bfloat16)}
    return AsrModel(cfg, params, preset_tokenizer(cfg.decoder.vocab_size))


def full_width_engine(dev):
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    return TranscriptionEngine(full_width_model(dev), device=dev,
                               dtype=torch.bfloat16)


def real_audio():
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    parts = []
    for path in sorted(glob.glob(os.path.join(DATA, "real", "*.wav"))):
        with open(path, "rb") as f:
            parts.append(decode_audio(f.read())[0])
    return np.concatenate(parts)


def upload_bodies():
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    real = os.path.join(DATA, "real")

    def read(name):
        with open(os.path.join(real, name), "rb") as f:
            return f.read()

    long = real_audio()[:int(29.5 * 16000)]
    return [("chinese_02.wav", read("chinese_02.wav")),
            ("japanese_02.wav", read("japanese_02.wav")),
            ("concat_29.5s.wav", encode_wav(long, 16000))]


def post(url: str, data: bytes) -> dict:
    bnd = uuid.uuid4().hex
    body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\n\r\n").encode() + data + \
        f"\r\n--{bnd}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={bnd}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"HTTP {r.status}")
        return json.loads(r.read())


class PathLaunches:
    """Each kernel's launches while the main path runs. The engines run
    captured CUDA graphs, and a replay moves no wrapper counter: a kernel's
    launches are the counters' (eager launches) plus, for every graph of
    ``engines`` (engines with their stream graphs, or decode pools), what
    its capture recorded times its replays. A graph
    built inside the window (a key's first request) has added its
    capture's recording to the counters, which launched nothing: that is
    taken out, and its warm-up run before the capture stays, as eager.
    Building one sets every counter and every replay count to 0."""

    def __init__(self, *engines):
        from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
        from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
            decode_attention_batched)
        from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
        from qwen3_asr_tpu_torch.ops.qgemm import qgemm, widened_product
        from qwen3_asr_tpu_torch.ops.qgemv import qgemv
        from qwen3_asr_tpu_torch.ops.qk_rope_kv import qk_rope_kv_write
        from qwen3_asr_tpu_torch.ops.quant import w8a8
        from qwen3_asr_tpu_torch.ops.slab_reader import slab_read
        # kernel -> (wrapper, the attribute that counts its launches)
        self.counters = {
            "flash_attention": (flash_attention, "launches"),
            "decode_attention": (decode_attention, "launches"),
            "decode_attention_batch": (decode_attention_batched, "launches"),
            "decode_attention_batch_int4": (decode_attention_batched,
                                            "launches_int4"),
            "qgemv": (qgemv, "launches"),
            "qgemm": (qgemm, "launches"),
            # not kernels of the port: the W8A8 products (torch._int_mm)
            # and the widened route, which the card's path never calls
            "w8a8": (w8a8, "calls"),
            "widened_product": (widened_product, "cuda_calls"),
            "qk_rope_kv": (qk_rope_kv_write, "launches"),
            "qk_rope_kv_per_row": (qk_rope_kv_write, "launches_per_row"),
            "slab_reader": (slab_read, "launches"),
            "slab_reader_int4": (slab_read, "launches_int4")}
        self.engines = engines
        for w, attr in self.counters.values():
            setattr(w, attr, 0)
        for g in self._graphs():
            g.replays = 0
        self.known = set(map(id, self._graphs()))

    def _graphs(self):
        """The engines' graphs, and a decode pool's (``graphs()``)."""
        return [g for e in self.engines
                for g in (e.graphs() if hasattr(e, "graphs") else
                          [g for x in e.executables.values()
                           for g in (x.front, x.chunk)]
                          + e.stream_graphs())]

    def read(self):
        """(launches, eager launches) of each kernel since construction."""
        from qwen3_asr_tpu_torch.runtime.graphs import launches
        eager = {k: getattr(w, attr)
                 for k, (w, attr) in self.counters.items()}
        for g in self._graphs():
            if id(g) not in self.known:
                for k, n in g.recorded.items():
                    eager[k] -= n
        return launches(self._graphs(), eager), eager


def check_records(engine, name: str) -> None:
    """Every captured graph of ``engine`` records the QK-norm + RoPE +
    KV-cache write once a layer: the front (the prefill) ``layers`` times,
    a decode chunk ``layers`` times a step."""
    from qwen3_asr_tpu_torch.runtime.generate import DECODE_CHUNK
    layers = engine.model.cfg.decoder.num_hidden_layers
    got = {key: (exe.front.recorded.get("qk_rope_kv"),
                 exe.chunk.recorded.get("qk_rope_kv"))
           for key, exe in engine.executables.items()}
    # a resume key's front writes twice a layer: the prompt, the verify
    want = {key: ((2 if exe.resume else 1) * layers, DECODE_CHUNK * layers)
            for key, exe in engine.executables.items()}
    log(f"[graphs] {name}: qk_rope_kv recorded (front, chunk) per key "
        f"{list(got.values())} (want ({layers} or {2 * layers} with "
        f"resume, {DECODE_CHUNK * layers}))")
    if not got or got != want:
        raise AssertionError(f"{name}: qk_rope_kv records {got}")


def step_kernels(exe, name: str, card: str, plain: bool = False) -> None:
    """The CUDA kernels one decode step records (torch.profiler, CUDA
    activity, over DECODE_CHUNK steps after the front's reset): a chunk
    replay and the chunk's function run eagerly; with ``plain`` (phase 7
    only: each count is a profiled run of several seconds), also the same
    with the plain chain (rms_norm, apply_rope, the cache's indexed write)
    in the kernel's place, which is what the step ran before it."""
    from qwen3_asr_tpu_torch.models import decoder
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import qk_rope_kv_write_plain
    from qwen3_asr_tpu_torch.runtime.generate import DECODE_CHUNK

    def count(fn):
        exe.front()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.inference_mode():
                fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA
                   ) / DECODE_CHUNK

    graph, eager = count(exe.chunk), count(exe.chunk.fn)
    line = (f"[kernels] {name}: CUDA kernels a decode step: {graph:.1f} in "
            f"a chunk replay, {eager:.1f} eager")
    if plain:
        kernel = decoder.qk_rope_kv_write
        decoder.qk_rope_kv_write = qk_rope_kv_write_plain
        try:
            chain = count(exe.chunk.fn)
        finally:
            decoder.qk_rope_kv_write = kernel
        line += (f"; {chain:.1f} eager with the plain chain in the kernel's "
                 f"place ({chain - eager:+.1f})")
    log(f"{line} | {card}")


def key_report(engine, name: str, card: str) -> None:
    """Capture seconds of each of ``engine``'s keys (the warm-up run and
    the capture of both graphs)."""
    for key, exe in engine.executables.items():
        bf, max_new, batch, kv = key[:4]
        log(f"[graphs] {name} key (bucket {bf} frames, max_new {max_new}, "
            f"B={batch}, {str(kv).replace('torch.', '')}"
            f"{', resume' if exe.resume else ''}): built in "
            f"{exe.front.capture_s + exe.chunk.capture_s:.3f} s (front "
            f"{exe.front.capture_s:.3f}, chunk {exe.chunk.capture_s:.3f}); "
            f"recorded front {exe.front.recorded}, chunk "
            f"{exe.chunk.recorded} | {card}")


def ladder_kv_bytes(engine) -> int:
    """KV cache bytes of every key of the whole ladder at B = 1, 2, 4, 8
    (each key owns its cache)."""
    from qwen3_asr_tpu_torch.runtime.engine import (AUDIO_BUCKETS_S,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.generate import cache_length
    dec = engine.model.cfg.decoder
    per_key = 0
    for sec in AUDIO_BUCKETS_S:
        bf, bs = engine.bucket_frames(int(16000 * sec))
        per_key += cache_length(engine.prompt_length(bf),
                                max_new_tokens_for(bs))
    return (per_key * (1 + 2 + 4 + 8) * 2 * dec.num_hidden_layers
            * dec.num_key_value_heads * dec.head_dim
            * torch.tensor([], dtype=engine.cache_dtype).element_size())


def graph_vs_eager(engine, clips, name: str, card: str,
                   turns=("graph", "eager", "eager", "graph")) -> None:
    """One request of ``clips`` through its key's graphs and through the
    same functions run eagerly, in ``turns``: the walls, host copies in and
    out included, and the token ids, which must be the same bits in every
    run."""
    from qwen3_asr_tpu_torch.runtime.engine import max_new_tokens_for
    bf, bs = engine.bucket_frames(max(len(c) for c in clips))
    exe, _ = engine.executable(bf, max_new_tokens_for(bs), len(clips))
    inputs = engine.bucket_inputs(clips, bf, None)
    walls = {"graph": [], "eager": []}
    first = None
    for mode in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = exe.run(*inputs, eager=mode == "eager")
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        first = first or res
        if not (torch.equal(res.tokens, first.tokens)
                and res.steps == first.steps):
            raise AssertionError(f"{name}: the {mode} run's tokens differ")
    n = int(first.lengths.sum())
    log(f"[graphs] {name}: graph {', '.join(f'{w:.3f}' for w in walls['graph'])}"
        f" s, eager {', '.join(f'{w:.3f}' for w in walls['eager'])} s "
        f"(eager / graph {min(walls['eager']) / min(walls['graph']):.2f}x); "
        f"{n} tokens, {first.steps} steps, {first.steps_run} computed; "
        f"token ids bit-identical in all {len(turns)} runs | {card}")


def main_path_phase(engine, uploads, dev):
    """Three uploads one after another: each runs at B=1 (bf16 cache, the
    single-token decode kernel) as replays of keys warmed when the manager
    started. Returns (launches, B=1 figure of the 10 s upload)."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    card = card_line()
    # the full-width encoder and prompt: finite and of the expected shape
    audio = torch.zeros((1, 3000 * 160), device=dev)
    prefix = torch.from_numpy(engine.padded_prefix(None)[0]).to(dev)
    with torch.inference_mode():
        embeds = engine.prompt_embeds(audio, prefix, 3000)
    sh = main_path_shapes()
    if tuple(embeds.shape) != (1, sh["prompt_len"], 2048) or \
            not bool(torch.isfinite(embeds).all()):
        raise AssertionError(f"bad prompt embeddings {tuple(embeds.shape)}")
    del embeds

    first = None
    layers = engine.model.cfg.decoder.num_hidden_layers
    per_request = layers + engine.model.cfg.encoder.encoder_layers
    want_decode = want_qk = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    with serving(ModelManager(engine)) as url:
        warm_s = time.perf_counter() - t0
        # what stays reserved once the allocator's free blocks are
        # released: the keys' caches and state, and their graph pool
        torch.cuda.empty_cache()
        log(f"[graphs] warmup of buckets {SMOKE_BUCKETS} s at B=1: "
            f"{len(engine.executables)} keys in {warm_s:.1f} s; they hold "
            f"{(torch.cuda.memory_reserved() - held[1]) / 2**30:.3f} GiB, "
            f"{(torch.cuda.memory_allocated() - held[0]) / 2**30:.3f} GiB "
            f"of it KV caches and loop state | {card}")
        key_report(engine, "preset:1.7b bf16", card)
        log(f"[graphs] the whole ladder (USE_CUDA_GRAPHS=true, "
            f"ASR_WARMUP_BATCH_SHAPES=2,4,8) would hold "
            f"{ladder_kv_bytes(engine) / 2**30:.3f} GiB of bf16 KV cache "
            f"(from shapes)")
        counter = PathLaunches(engine)
        for name, data in uploads:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            body = post(url, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not isinstance(body.get("text"), str) or "language" not in body:
                raise AssertionError(f"{name}: bad response {body}")
            run = engine.last_run
            if run["capture_s"]:
                raise AssertionError(f"{name}: its key was not warm")
            want_decode += layers * run["steps_run"]
            want_qk += layers * (1 + run["steps_run"])
            first = first or (wall, run["generated"])
            MEASURED["phase 5, 30 s upload at B=1"] = (wall, dict(run))
            log(f"[serve] preset:1.7b bf16 {name}: {wall:.3f} s wall, "
                f"{run['generated']} tokens generated, {run['steps']} steps "
                f"({run['steps_run']} computed), {run['replays']} replays, "
                f"prompt {run['prompt_len']}, cache {run['cache_len']}, "
                f"bucket {run['bucket_frames']} frames, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        launches, eager = counter.read()
    log(f"[serve] launches on the main path: {launches}, eager {eager} "
        f"(want flash {per_request * len(uploads)}, decode {want_decode} = "
        f"{layers} x steps_run, qk_rope_kv {want_qk} = {layers} x (1 + "
        f"steps_run) a request, none eager)")
    if (launches["flash_attention"] != per_request * len(uploads)
            or launches["decode_attention"] != want_decode
            or launches["qk_rope_kv"] != want_qk
            or any(eager.values())):
        raise AssertionError(f"launches {launches}, eager {eager}: want "
                             f"flash {per_request * len(uploads)}, decode "
                             f"{want_decode} and qk_rope_kv {want_qk} from "
                             f"replays only")
    check_records(engine, "preset:1.7b bf16")
    graph_vs_eager(engine, [decode_audio(uploads[-1][1])[0]],
                   "30 s upload, B=1, bf16 (kernel #2)", card)
    return launches, first


# -- phase 6 ---------------------------------------------------------------------

def batch_phase(engine, dev, solo):
    """8 concurrent uploads of the 10 s bucket with a bf16 KV cache and
    with fp8, in turns (bf16, fp8, fp8, bf16) so that the two compare
    within one call, on one engine per cache dtype warmed at B=8: each run
    must come back from ONE dispatch at B=8, every decode step through the
    batched kernel, from replays only. Returns its launches and the bf16
    engine."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    card = card_line()
    audio = real_audio()
    seg = int(9.5 * 16000)
    clips = [audio[i * seg:(i + 1) * seg] for i in range(8)]
    bodies = [encode_wav(c, 16000) for c in clips]
    total = {}
    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    managers = {kv: ModelManager(TranscriptionEngine(
        engine.model, device=dev, dtype=torch.bfloat16, cache_dtype=kv))
        for kv in (bf16, fp8)}
    os.environ.update(ASR_WARMUP_BUCKETS="10", ASR_WARMUP_BATCH_SHAPES="8")
    try:
        for kv, manager in managers.items():
            manager.start()        # warms, once per manager
            manager.stop()
            key_report(manager.engine, f"KV {KV_NAMES[kv]}", card)
    finally:
        os.environ["ASR_WARMUP_BUCKETS"] = SMOKE_BUCKETS
        del os.environ["ASR_WARMUP_BATCH_SHAPES"]
    for kv in (bf16, fp8, fp8, bf16):
        manager = managers[kv]
        eng = manager.engine
        manager.batcher = MicroBatcher(manager, window_ms=1000, max_batch=8)
        with serving(manager) as url:
            torch.cuda.reset_peak_memory_stats()
            counter = PathLaunches(eng)
            t0 = time.perf_counter()
            replies, walls = post_all(url, bodies)
            torch.cuda.synchronize()
            batch_wall = time.perf_counter() - t0
            launches, eager = counter.read()
        run = eng.last_run
        name = KV_NAMES[kv]
        if kv == bf16:
            MEASURED["phase 6, 8 uploads at B=8, bf16 KV"] = (
                min(batch_wall, MEASURED.get(
                    "phase 6, 8 uploads at B=8, bf16 KV",
                    (batch_wall,))[0]), dict(run))
        for body in replies:
            if not isinstance(body.get("text"), str) or "language" not in body:
                raise AssertionError(f"{name}: bad response {body}")
        layers = eng.model.cfg.decoder.num_hidden_layers
        want = layers * run["steps_run"]
        want_qk = layers * (1 + run["steps_run"])
        log(f"[batch] preset:1.7b bf16, KV cache {name}: 8 uploads at once "
            f"-> {manager.batcher.dispatches} dispatch, batch {run['batch']},"
            f" {run['generated']} tokens in {batch_wall:.3f} s = "
            f"{run['generated'] / batch_wall:.1f} tokens/s (B=1 phase 5: "
            f"{solo[1]} tokens in {solo[0]:.3f} s = "
            f"{solo[1] / solo[0]:.1f} tokens/s); {run['steps']} steps "
            f"({run['steps_run']} computed), {run['replays']} replays; "
            f"request walls {', '.join(f'{w:.3f}' for w in walls)} s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{launches}, eager {eager} | {card}")
        if (manager.batcher.dispatches != 1 or run["batch"] != 8
                or launches["decode_attention_batch"] != want
                or launches["qk_rope_kv"] != want_qk
                or launches["decode_attention"] or any(eager.values())
                or not launches["flash_attention"]):
            raise AssertionError(f"{name}: {manager.batcher.dispatches} "
                                 f"dispatches, batch {run['batch']}, "
                                 f"launches {launches}, eager {eager}, want "
                                 f"batched {want} and qk_rope_kv {want_qk} "
                                 f"from replays only")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    for kv, manager in managers.items():
        check_records(manager.engine, f"KV {KV_NAMES[kv]}, B=8")
        graph_vs_eager(manager.engine, clips,
                       f"8 uploads, B=8, KV {KV_NAMES[kv]} (kernel #3)", card)
    return total, managers[bf16].engine


# -- phase 7 ---------------------------------------------------------------------

def profile_phase(engine, wav: bytes, top: int = 12) -> None:
    """One more transcription of ``wav`` through the warm engine under
    torch.profiler (CUDA activity only): wall, device busy time (sum of
    CUDA kernel time) and its share of the wall, the kernels that took the
    most device time, and one single-token decode kernel per layer and
    computed decode step, counted from the capture (recorded x replays)
    and, as far as the profiler keeps every record, from the profile;
    no ``index_copy_`` or int4-write kernel; then the kernels a decode step
    records (``step_kernels``). Graph replays make ~500k kernel records
    in ~1.5 s, and the profiler loses some of them (8 to 922 of the decode
    kernel's 7168 in four runs), so the count is the capture's and the
    profile's is only logged (``profile_verdict``)."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    audio, sr = decode_audio(wav)
    card = card_line()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    counter = PathLaunches(engine)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.transcribe(audio, sr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    run = engine.last_run
    captured = counter.read()[0]["decode_attention"]
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    log(f"[profile] {len(audio) / sr:.2f} s upload under torch.profiler: "
        f"{wall:.3f} s wall, {run['generated']} tokens, {run['replays']} "
        f"replays, device busy {busy:.3f} s = {busy / wall:.1%} of the wall "
        f"| {card}")
    if not kernels:
        log("[profile] the profiler recorded no device time")
    for e in sorted(kernels, key=lambda e: e.device_time_total,
                    reverse=True)[:top]:
        log(f"[profile] {e.device_time_total / 1e3:10.3f} ms "
            f"{e.count:7d} calls  {e.key[:90]} "
            f"({e.device_time_total / 1e6 / busy:.1%} of busy)")
    stale = [e.key[:60] for e in kernels
             if "index_copy" in e.key or "kv_int4_write" in e.key]
    if stale:
        raise AssertionError(f"the request ran {stale}: the cache is written "
                             f"by qk_rope_kv alone")
    decoded = [(e.key[:60], e.count) for e in kernels
               if "decode_split_kernel" in e.key]
    want = engine.model.cfg.decoder.num_hidden_layers * run["steps_run"]
    log(f"[profile] decode kernels: {decoded} (want one name, {want} calls); "
        f"from the capture: {captured}; {sum(e.count for e in kernels)} "
        f"kernel records in all")
    log(f"[profile] {profile_verdict(captured, want, decoded)}")
    exe = next(x for key, x in engine.executables.items()
               if key[0] == run["bucket_frames"] and key[2] == run["batch"]
               and not x.resume)
    step_kernels(exe, f"{len(audio) / sr:.1f} s upload, B={run['batch']}, "
                 f"{str(engine.cache_dtype).replace('torch.', '')} KV", card,
                 plain=True)
    # for phase 19 (b)
    MEASURED["phase 7 graph nodes"] = (exe.front.nodes, exe.chunk.nodes)


def profile_verdict(captured: int, want: int, decoded: list) -> str:
    """Phase 7's (and 9's) decision on the decode kernel's launches in a
    profiled request: the count from the capture (recorded x replays,
    exact) must be ``want``, and the profile must name one decode kernel.
    The profiler's own count (``decoded``: (name, records) pairs) is
    reported as records kept or lost, since it drops records whose buffers
    it does not drain in time; it fails only above ``want``, which would
    mean launches outside the capture. Returns the line to log; raises
    AssertionError."""
    if captured != want:
        raise AssertionError(f"{captured} decode launches from the capture, "
                             f"want {want}")
    if len(decoded) > 1:
        raise AssertionError(f"decode kernels {decoded}: want one name")
    if not decoded:
        return ("the profiler reports no decode kernel launched from a "
                f"graph: {want} counted from the capture")
    kept = decoded[0][1]
    if kept > want:
        raise AssertionError(f"the profiler saw {kept} decode launches, "
                             f"the capture {want}: launches outside it")
    return (f"the profiler kept {kept} of the decode kernel's {want} "
            f"records ({want - kept} lost); {want} counted from the capture")


# -- phase 8 ---------------------------------------------------------------------

# the batched decode case (kernel #3) at each probe shape's B and dtype
PROBE_TWIN = {"engine_b8_s768_bf16": "batched_b8_s768_bf16",
              "engine_b8_s768_fp8": "batched_b8_s768_fp8",
              "jax_default_b96_s512_fp8": "batched_b96_s512_fp8",
              "engine_b8_s768_int4": "int4_b8_s768",
              "jax_default_b96_s512_int4": "int4_b96_s512"}


def probe_phase(batched_rows):
    """The KV read-rate probe at its shapes, each beside kernel #3's read
    rate at the same B and cache dtype (phase 3; its int4 route's rows
    for the int4 shapes). Returns its rows and the launches."""
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import probe
    card = card_line()
    counter = PathLaunches()
    rows = probe()
    launches = counter.read()[0]
    for r in rows:
        twin = next(x for x in batched_rows
                    if x["shape"] == PROBE_TWIN[r["shape"]])
        rate = twin["bytes"] / twin["ms"] / 1e6
        earlier = EARLIER_MS.get(r["shape"])
        log(f"[probe] {r['shape']}: {r['ms']:.4f} ms per layer "
            f"({r['bytes'] / 1e6:.1f} MB), {r['gb_s']:.0f} GB/s = "
            f"{r['share']:.1%} of 3.35 TB/s"
            + (f" (before the redesign, PERF.md: {earlier:.4f} ms)"
               if earlier else "") + "; kernel #3 "
            f"{twin['shape']} "
            f"reads {rate:.0f} GB/s = {rate / r['gb_s']:.1%} of the probe's "
            f"rate | {card}")
    if not launches["slab_reader"] or not launches["slab_reader_int4"]:
        raise AssertionError(f"the probe launched no slab read (or no int4 "
                             f"one): {launches}")
    return rows, launches


# -- phase 9 ---------------------------------------------------------------------

DEFAULT_ENV = {"QUANTIZE": "int8", "ASR_KV_CACHE_DTYPE": "int4",
               "ASR_INT8_ACT": "true"}
INT4_ENV = {"QUANTIZE": "int4", "ASR_KV_CACHE_DTYPE": "int4",
            "ASR_INT8_ACT": ""}


def replay_ms(graph, replays: int = 5) -> float:
    """Device ms of one replay of ``graph``, between CUDA events."""
    graph()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def front_and_step_ms(exe) -> tuple:
    """Device ms of ``exe``'s front graph (frontend, encoder, prompt,
    prefill, first token) and of one decode step (a chunk replay is
    DECODE_CHUNK predicated steps, all computed, after the front's reset)."""
    from qwen3_asr_tpu_torch.runtime.generate import DECODE_CHUNK
    front = replay_ms(exe.front)
    exe.front()
    return front, replay_ms(exe.chunk) / DECODE_CHUNK


def quantized_engine(dev, env: dict, card: str, name: str):
    """preset:1.7b (seed 0, bf16) quantized and cached as ``env`` says,
    through the lifecycle's own readers of QUANTIZE and ASR_KV_CACHE_DTYPE;
    logs the weight bytes before and after."""
    from qwen3_asr_tpu_torch.ops.quant import param_bytes
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu_torch.runtime.lifecycle import (
        kv_cache_dtype_from_env, quantize_mode_from_env, quantize_model)
    os.environ.update(env)
    model = full_width_model(dev)
    before = param_bytes(model.params)
    quantize_model(model, quantize_mode_from_env())
    after = param_bytes(model.params)
    torch.cuda.synchronize()
    log(f"[default] {name}: weights {before / 2**30:.3f} GiB -> "
        f"{after / 2**30:.3f} GiB ({after / before:.1%}) | {card}")
    return TranscriptionEngine(model, device=dev, dtype=torch.bfloat16,
                               cache_dtype=kv_cache_dtype_from_env()), after


def front_products(engine, front_rows, min_rows: int) -> dict:
    """The launches of the quantized products front graphs of
    ``front_rows`` (the rows of the prompt and of the encoder, one pair a
    front) make on the card: W8A8 where int8 rows reach ``min_rows`` (0:
    off), one a product; else kernel C, four launches a layer (q/k/v as
    one, wo, gate/up as one or fc1, w_down or fc2)."""
    dec = engine.model.cfg.decoder.num_hidden_layers
    enc = engine.model.cfg.encoder.encoder_layers
    want = {"qgemm": 0, "w8a8": 0}
    int8 = engine.model.params["decoder"]["layers"]["wq"]["q"].dtype \
        == torch.int8
    for dec_rows, enc_rows in front_rows:
        for rows, layers, products in ((dec_rows, dec, 7),
                                       (enc_rows, enc, 6)):
            if int8 and min_rows and rows >= min_rows:
                want["w8a8"] += products * layers
            else:
                want["qgemm"] += 4 * layers
    return want


def serve_quantized(engine, name, sh, long_wav, clips, bodies, card):
    """The quantized ``engine`` warmed (10 and 30 s buckets, B=1 and 8) and
    served through the port's server: the 30 s upload at B=1, then the 8
    uploads at once (one dispatch at B=8), each from replays only, with
    every decode product through kernel A, the QK-norm + RoPE + int4 write
    and #3's int4 route, and every front-graph product through kernel C
    (or W8A8); then the B=8 run against its eager run bit for bit.
    Returns the launches."""
    from qwen3_asr_tpu_torch.ops.quant import int8_act_min_rows
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    os.environ.update(ASR_WARMUP_BUCKETS="10,30", ASR_WARMUP_BATCH_SHAPES="8")
    manager = ModelManager(engine)
    t0 = time.perf_counter()
    with serving(manager) as url:
        log(f"[default] {name}: warmup {len(engine.executables)} keys in "
            f"{time.perf_counter() - t0:.1f} s")
        key_report(engine, name, card)
        counter = PathLaunches(engine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        body = post(url, long_wav)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        run1 = dict(engine.last_run)
        # the 8 uploads wait for each other (the solo one above took the
        # default window)
        manager.batcher = MicroBatcher(manager, window_ms=1000, max_batch=8)
        t0 = time.perf_counter()
        replies, walls = post_all(url, bodies)
        torch.cuda.synchronize()
        wall8 = time.perf_counter() - t0
        run8 = dict(engine.last_run)
        launches, eager = counter.read()
    for b in [body] + replies:
        if not isinstance(b.get("text"), str) or "language" not in b:
            raise AssertionError(f"{name}: bad response {b}")
    layers = engine.model.cfg.decoder.num_hidden_layers
    steps = run1["steps_run"] + run8["steps_run"]
    enc_layers = engine.model.cfg.encoder.encoder_layers
    want = {"flash_attention": 2 * (layers + enc_layers),
            "decode_attention_batch_int4": layers * steps,
            "qk_rope_kv": layers * (2 + steps),
            # q/k/v and gate/up one grouped launch each, wo, w_down, the
            # logits; and each request's first token
            "qgemv": 2 + (4 * layers + 1) * steps,
            # the prompt's and the encoder's products: kernel C, or W8A8
            **front_products(engine, ((sh["prompt_len"], sh["enc_rows_b1"]),
                                      (sh["dec_rows_b8"], sh["enc_rows_b8"])),
                             int8_act_min_rows()),
            "widened_product": 0, "decode_attention": 0,
            "decode_attention_batch": 0}
    log(f"[default] {name}, 30 s upload, B=1: {wall1:.3f} s wall, "
        f"{run1['generated']} tokens, {run1['steps_run']} steps computed, "
        f"{run1['replays']} replays | {card}")
    log(f"[default] {name}, 8 uploads at once -> batch {run8['batch']}: "
        f"{run8['generated']} tokens in {wall8:.3f} s = "
        f"{run8['generated'] / wall8:.1f} tokens/s, {run8['replays']} "
        f"replays; request walls {', '.join(f'{w:.3f}' for w in walls)} s "
        f"| {card}")
    log(f"[default] {name}: launches {launches}, eager {eager} (want "
        f"{want}, none eager)")
    if (run1["batch"] != 1 or run8["batch"] != 8 or run1["capture_s"]
            or run8["capture_s"] or any(eager.values())
            or any(launches[k] != n for k, n in want.items())):
        raise AssertionError(f"{name}: runs {run1} / {run8}, launches "
                             f"{launches}, eager {eager}, want {want}")
    check_records(engine, name)
    # one turn, at B=8 (phases 5 and 6 time four; B=1 is the card tests'
    # test_int8_int4_graph_replay_equals_eager and
    # test_int4_weights_graph_replay_equals_eager)
    graph_vs_eager(engine, clips, f"{name}, 8 uploads, B=8", card,
                   ("graph", "eager"))
    return launches


def front_step_report(engines, card: str) -> None:
    """The front graph's ms, ms per decode step and CUDA kernels a step of
    each (engine, name)'s 30 s B=1 and 10 s B=8 keys it has built."""
    from qwen3_asr_tpu_torch.runtime.engine import max_new_tokens_for
    done = set()
    for eng, name in engines:
        for sec, batch in ((30, 1), (10, 8)):
            bf, bs = eng.bucket_frames(16000 * sec)
            key = (bf, max_new_tokens_for(bs), batch, eng.cache_dtype)
            # a configuration's key once (phases 5 and 6 both hold the
            # bf16 B=8 key)
            if key in eng.executables and (name, key) not in done:
                done.add((name, key))
                exe = eng.executables[key]
                front, step = front_and_step_ms(exe)
                log(f"[default] {name}, {sec} s bucket, B={batch}: front "
                    f"graph {front:.4f} ms, {step:.4f} ms per decode step "
                    f"(device, graph replays) | {card}")
                step_kernels(exe, f"{name}, {sec} s bucket, B={batch}", card)


def default_config_phase(dev, sh, bf16_engine, bf16_b8_engine, uploads):
    """The JAX package's default serving configuration (QUANTIZE=int8,
    ASR_KV_CACHE_DTYPE=int4, ASR_INT8_ACT=true), then QUANTIZE=int4 with
    an int4 KV cache, at preset:1.7b, each served by ``serve_quantized``;
    the front graph's ms, ms per decode step and kernels a decode step at
    B=1 (30 s) and B=8 (10 s) of both beside the bf16 engines'
    (``bf16_engine`` from phase 5, ``bf16_b8_engine`` from phase 6); then
    one B=1 request with QUANTIZE=fp8. Returns each kernel's launches over the
    phase's three served configurations."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    card = card_line()
    saved = {k: os.environ.get(k) for k in (*DEFAULT_ENV,
                                            "ASR_WARMUP_BUCKETS",
                                            "ASR_WARMUP_BATCH_SHAPES")}
    audio = real_audio()
    seg = int(9.5 * 16000)
    clips = [audio[i * seg:(i + 1) * seg] for i in range(8)]
    bodies = [encode_wav(c, 16000) for c in clips]
    long_wav = uploads[-1][1]
    try:
        engine, _ = quantized_engine(dev, DEFAULT_ENV, card,
                                     "int8 + int4 KV + W8A8")
        total = serve_quantized(engine, "default config", sh, long_wav,
                                clips, bodies, card)
        int4, _ = quantized_engine(dev, INT4_ENV, card, "int4 + int4 KV")
        got = serve_quantized(int4, "int4 weights", sh, long_wav, clips,
                              bodies, card)
        total = {k: total[k] + got[k] for k in total}
        front_step_report(((bf16_engine, "bf16 weights, bf16 KV"),
                           (bf16_b8_engine, "bf16 weights, bf16 KV"),
                           (engine, "int8 weights, int4 KV"),
                           (int4, "int4 weights, int4 KV")), card)
        del int4, engine
        torch.cuda.empty_cache()

        fp8, _ = quantized_engine(dev, dict(DEFAULT_ENV, QUANTIZE="fp8"),
                                  card, "fp8 + int4 KV")
        os.environ.update(ASR_WARMUP_BUCKETS="10", ASR_WARMUP_BATCH_SHAPES="")
        with serving(ModelManager(fp8)) as url:
            counter = PathLaunches(fp8)
            t0 = time.perf_counter()
            body = post(url, uploads[0][1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = fp8.last_run
            got, eager = counter.read()
        layers = fp8.model.cfg.decoder.num_hidden_layers
        enc_layers = fp8.model.cfg.encoder.encoder_layers
        log(f"[default] fp8 weights, {uploads[0][0]} at B=1: {wall:.3f} s "
            f"wall, {run['generated']} tokens, launches {got}, eager "
            f"{eager} | {card}")
        if (not isinstance(body.get("text"), str) or run["capture_s"]
                or any(eager.values()) or got["qgemv"] != 1 + (
                    4 * layers + 1) * run["steps_run"]
                or got["qk_rope_kv"] != layers * (1 + run["steps_run"])
                or got["qgemm"] != 4 * (layers + enc_layers)
                or got["widened_product"] or got["w8a8"]
                or not got["decode_attention_batch_int4"]):
            raise AssertionError(f"fp8 weights: {body}, {run}, {got}, "
                                 f"{eager}")
        return {k: total[k] + got[k] for k in total}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- phase 10 --------------------------------------------------------------------

# the tick batches phase 10 serves: a group of 3 or 4 sessions pads to 4
WS_ENV = {"ASR_WS_TICK_MIN_SESSIONS": "3", "ASR_WS_TICK_MAX_BATCH": "4",
          "ASR_WARMUP_BUCKETS": "", "ASR_WARMUP_BATCH_SHAPES": ""}
VAD_TOL = 1e-4


def vad_phase(dev, card: str) -> None:
    """The VAD on the card against its plain version on the CPU (the same
    torch code, on CPU tensors), both backends, on 10 real clips: the
    probabilities within VAD_TOL and ``is_speech`` equal on every clip."""
    from qwen3_asr_tpu_torch.audio import vad, vad_model
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))[:10]
    worst = {"learned": 0.0, "spectral": 0.0}
    walls = {"learned": [], "spectral": []}
    fns = {"learned": vad_model.speech_probability,
           "spectral": vad.spectral_probability}
    for path in clips:
        with open(path, "rb") as f:
            x = decode_audio(f.read())[0].astype(np.float32)
        x = x[-int(6.6 * 16000):]        # a flush window's length at most
        for name, fn in fns.items():
            fn(x, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_card = fn(x, dev)
            walls[name].append(time.perf_counter() - t0)
            p_cpu = fn(x, "cpu")
            worst[name] = max(worst[name], abs(p_card - p_cpu))
            if (p_card >= 0.5) != (p_cpu >= 0.5) or \
                    abs(p_card - p_cpu) > VAD_TOL:
                raise AssertionError(f"VAD {name} {os.path.basename(path)}: "
                                     f"card {p_card} vs CPU {p_cpu}")
    log(f"[vad] {len(clips)} real clips (their last 6.6 s), card vs CPU: "
        f"learned max |dp| {worst['learned']:.2e}, spectral "
        f"{worst['spectral']:.2e} (bound {VAD_TOL:g}); is_speech equal on "
        f"every clip; active backend {vad.active_backend()}, flush debounce "
        f"{vad.default_flush_ticks()} tick(s); one call on the card "
        f"{np.median(walls['learned']) * 1e3:.2f} ms learned, "
        f"{np.median(walls['spectral']) * 1e3:.2f} ms spectral (host wall, "
        f"median) | {card}")


@contextlib.contextmanager
def ws_serving(manager):
    """The port's server for ``manager``; yields its ws:// base URL. The
    session's ``_transcribe_with_context`` is wrapped to record each call
    (a partial or a flush, its wall and its text) in ``manager.ws_calls``."""
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    from qwen3_asr_tpu_torch.serving.server import build_server
    orig = ws_mod._transcribe_with_context
    manager.ws_calls = []

    def recorded(mgr, audio_bytes, pad_silence, *a, **k):
        t0 = time.perf_counter()
        out = orig(mgr, audio_bytes, pad_silence, *a, **k)
        manager.ws_calls.append(("flush" if pad_silence else "partial",
                                 time.perf_counter() - t0, out[0]))
        return out

    ws_mod._transcribe_with_context = recorded
    manager.start()
    server = build_server(manager, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"ws://127.0.0.1:{server.server_address[1]}/ws/transcribe"
    finally:
        ws_mod._transcribe_with_context = orig
        server.shutdown()
        server.server_close()
        manager.stop()
        thread.join(timeout=30)


def ws_stream(url: str, pcm: bytes, query: str = "") -> list:
    """One session: the PCM in 450 ms binary messages, a flush, then a
    reset whose answer ends it; returns every message received."""
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    ws = ws_mod.connect(url + query, timeout=600)
    msgs = [ws.receive_json(timeout=600)]
    if msgs[0].get("status") != "connected":
        raise AssertionError(f"WS greeting {msgs[0]}")
    tick = ws_mod.WS_BUFFER_SIZE
    for i in range(0, len(pcm), tick):
        ws.send_bytes(pcm[i:i + tick])
    ws.send_json({"action": "flush"})
    ws.send_json({"action": "reset"})
    while msgs[-1] != {"status": "buffer_reset"}:
        msgs.append(ws.receive_json(timeout=600))
    ws.close()
    return msgs


def real_pcm(name: str) -> bytes:
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    with open(os.path.join(DATA, "real", name), "rb") as f:
        audio = decode_audio(f.read())[0]
    return np.round(audio * 32768.0).astype("<i2").tobytes()


def percentiles(walls) -> str:
    return (f"p50 {np.percentile(walls, 50) * 1e3:.1f} ms, p90 "
            f"{np.percentile(walls, 90) * 1e3:.1f} ms over {len(walls)}")


def solo_ws_phase(dev, card: str) -> dict:
    """(a) trained_ckpt in f32 on the card through the server: one real
    clip in 450 ms messages, server VAD on, then a flush. Every partial's
    token ids equal a plain run of its window on the same engine, and the
    final is the clip's transcript. Returns the launches."""
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
    name = "english_02"
    engine = load_engine(os.path.join(DATA, "trained_ckpt"), device=dev,
                         dtype=torch.float32)
    manager = ModelManager(engine)
    calls = []
    orig_sync = manager.transcribe_sync

    def sync(audio, sr, lang, ts=False, use_fast=False, context="",
             resume_tokens=None):
        out = orig_sync(audio, sr, lang, ts, use_fast, context,
                        resume_tokens)
        calls.append((audio, lang, resume_tokens, out[0].token_ids,
                      dict(engine.last_run)))
        return out

    manager.transcribe_sync = sync
    with ws_serving(manager) as url:
        counter = PathLaunches(engine)
        msgs = ws_stream(url, real_pcm(name + ".wav"))
        launches, eager = counter.read()
    with open(os.path.join(DATA, "real", name + ".txt"),
              encoding="utf-8") as f:
        want = f.read().strip()
    finals = [m["text"] for m in msgs if m.get("is_final")]
    partials = [m["text"] for m in msgs if m.get("is_partial")]
    rows = []
    for audio, lang, draft, ids, run in calls:
        plain = engine.transcribe(audio, 16000, lang)[0]
        prun = engine.last_run
        if plain.token_ids != ids:
            raise AssertionError(f"a tick's tokens {ids} differ from the "
                                 f"plain run's {plain.token_ids}")
        rows.append((len(audio) / 16000, run["resume"],
                     run.get("accepted", [0])[0], run["steps"], prun["steps"]))
    ticks = [r for r in rows if r[1]]
    log(f"[ws] (a) trained_ckpt f32, {name} in 450 ms messages, VAD on: "
        f"{len(partials)} partials, {len(finals)} final(s); {len(calls)} "
        f"transcriptions, every one's token ids equal to a plain run of its "
        f"window | {card}")
    for sec, resume, acc, steps, plain_steps in rows:
        log(f"[ws]   window {sec:.2f} s: "
            + (f"resume, {acc} draft tokens accepted, {steps[0]} decode "
               f"steps past them" if resume else "plain (no draft)")
            + f"; plain greedy: {plain_steps} steps")
    if ticks:
        log(f"[ws] (a) per resumed tick: accepted "
            f"{np.mean([t[2] for t in ticks]):.2f} draft tokens and "
            f"{np.mean([t[3][0] for t in ticks]):.2f} decode steps on "
            f"average, against {np.mean([t[4] for t in ticks]):.2f} steps "
            f"of plain greedy on the same windows")
    log(f"[ws] (a) final {finals[-1]!r}; launches {launches}, eager {eager}")
    if not finals or finals[-1] != want or not ticks or not partials:
        raise AssertionError(f"(a): final {finals} vs {want!r}; "
                             f"{len(ticks)} resumed ticks")
    if not (launches["flash_attention"] and launches["decode_attention"]
            and launches["qk_rope_kv"]) or any(eager.values()):
        raise AssertionError(f"(a): launches {launches}, eager {eager}")
    del engine, manager
    torch.cuda.empty_cache()
    return launches


def tick_sessions(engine, manager, card: str, name: str, clips) -> tuple:
    """Two idle sessions, then one streaming session a clip, all at once,
    server VAD off, through ``manager``'s server: the streaming sessions
    are admitted at 3 or more live sessions, so in mode ``tick``. Checks
    that ticks coalesce (dispatches < ticks), that each tick's tokens are
    its window's solo resume run's, and that the run replayed graphs
    only. Returns (launches, partial walls, the recorded ticks)."""
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    batcher = manager.tick_batcher
    ticks = []
    orig = batcher.transcribe_tick

    def record(audio, language, resume_tokens, use_fast):
        fut = orig(audio, language, resume_tokens, use_fast)
        ticks.append((audio, language, resume_tokens, fut))
        return fut

    batcher.transcribe_tick = record
    with ws_serving(manager) as url:
        holders = [ws_mod.connect(url, timeout=600) for _ in range(2)]
        for h in holders:
            h.receive_json(timeout=600)
        counter = PathLaunches(engine)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(clips)) as pool:
            out = list(pool.map(
                lambda c: ws_stream(url, real_pcm(c),
                                    "?use_server_vad=false"), clips))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, eager = counter.read()
        for h in holders:
            h.close()
        calls = list(manager.ws_calls)
    dispatches = batcher.dispatches
    groups = dict(batcher.groups)
    partial_walls = [w for kind, w, _ in calls if kind == "partial"]
    flush_walls = [w for kind, w, _ in calls if kind == "flush"]
    # every tick against its window's solo resume run (B=1) and its plain
    # greedy run: in f32 the three are equal (phase 10 (a), the CPU
    # tests); in bf16 a row of a batch and a verify window round apart
    # from a B=1 decode step, so a near-tie can flip a token. Counted,
    # with the share of each tick's tokens before the first difference.
    # (every fourth tick against its solo resume run, every eighth
    # against the plain run)
    vocab = engine.model.cfg.decoder.vocab_size
    same = {"solo resume": 0, "plain": 0}
    prefix = {"solo resume": [], "plain": []}
    for i, (audio, lang, draft, fut) in enumerate(ticks):
        _, ids = fut.result()
        if any(not 0 <= t < vocab for t in ids):
            raise AssertionError(f"{name}: token ids {ids} outside the "
                                 f"vocabulary")
        refs = []
        if i % 4 == 0:
            refs.append(("solo resume", dict(resume_tokens=draft)))
        if i % 8 == 0:
            refs.append(("plain", {}))
        for kind, kw in refs:
            ref = engine.transcribe(audio, 16000, lang, **kw)[0].token_ids
            same[kind] += ref == ids
            n = next((i for i, (a, b) in enumerate(zip(ids, ref))
                      if a != b), min(len(ids), len(ref)))
            prefix[kind].append(n / max(len(ids), len(ref), 1))
    errors = [t for _, _, t in calls
              if t == "[timeout]" or t.startswith("[error: ")]
    log(f"[ws] {name}: {len(clips)} sessions (+2 idle) in mode tick, "
        f"{len(ticks)} ticks in {dispatches} dispatches (groups by size "
        f"{groups}), {len(flush_walls)} finals; {wall:.2f} s wall; partial "
        f"ticks {percentiles(partial_walls)}, finals "
        f"{percentiles(flush_walls)} (server wall a call) | {card}")
    for kind in same:
        log(f"[ws] {name}: ticks whose tokens equal their window's {kind} "
            f"run at B=1: {same[kind]}/{len(prefix[kind])}; tokens before "
            f"the first difference {np.mean(prefix[kind]):.1%} on average")
    log(f"[ws] {name}: launches {launches}, eager {eager}")
    if (errors or not ticks or dispatches >= len(ticks)
            or any(eager.values()) or not launches["qk_rope_kv_per_row"]
            or any(len(m) < 3 for m in out)):
        raise AssertionError(f"{name}: errors {errors[:3]}, {dispatches} "
                             f"dispatches for {len(ticks)} ticks, eager "
                             f"{eager}, launches {launches}")
    return launches, partial_walls, ticks


def warm_ws(engine, card: str, name: str):
    """The engine's keys for the WS path (``ws_warmup_profile``: each
    bucket's plain and resume keys, the tick batches' resume keys, the
    flush bucket's batches), warmed by the manager's start; logs their
    capture seconds and the memory they hold."""
    from qwen3_asr_tpu_torch.config import ws_warmup_profile
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    manager = ModelManager(engine)
    t0 = time.perf_counter()
    manager.start()
    manager.stop()
    warm_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    capture = sum(x.front.capture_s + x.chunk.capture_s
                  for x in engine.executables.values())
    resume = sum(x.resume for x in engine.executables.values())
    log(f"[ws] {name}: modes {[m.name for m in ws_warmup_profile()]}, "
        f"{len(engine.executables)} keys ({resume} resume) warmed in "
        f"{warm_s:.1f} s, {capture:.1f} s of it capture; they hold "
        f"{(torch.cuda.memory_reserved() - held[1]) / 2**30:.3f} GiB, "
        f"{(torch.cuda.memory_allocated() - held[0]) / 2**30:.3f} GiB of "
        f"it KV caches and state | {card}")
    manager.warmed = True
    return manager


def tick_busy_share(engine, ticks, card: str, name: str) -> dict:
    """One tick batch of the run's last four windows (6 s bucket, B=4,
    their drafts) under torch.profiler: wall, device busy time and share;
    and the device ms of the key's front and chunk graphs."""
    windows = ticks[-4:]
    clips = [a for a, _, _, _ in windows]
    rows = [d for _, _, d, _ in windows]
    langs = [lang for _, lang, _, _ in windows]
    bf, bs = engine.bucket_frames(max(len(c) for c in clips))
    engine._run_bucket(clips, bf, bs, None, resume_rows=rows,
                       language_rows=langs)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine._run_bucket(clips, bf, bs, None, resume_rows=rows,
                           language_rows=langs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    run = dict(engine.last_run)
    busy = sum(e.device_time_total for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    key = next(k for k, x in engine.executables.items()
               if x.resume and k[0] == bf and k[2] == len(clips))
    exe = engine.executables[key]
    # the tick's graphs against the same functions run eagerly: bit for bit
    audio, _, _ = engine.bucket_inputs(clips, bf, None)
    prefix, valid_from = engine.padded_prefix_rows(langs)
    prev = np.full((len(clips), run["max_new"]), engine.model.pad_id,
                   np.int32)
    prev_len = np.zeros(len(clips), np.int32)
    for i, r in enumerate(rows):
        usable = list(r or [])[:run["max_new"]]
        prev[i, :len(usable)], prev_len[i] = usable, len(usable)
    outs = [exe.run(audio, prefix, valid_from, eager=e, prev=prev,
                    prev_len=prev_len) for e in (False, True, False)]
    if not all(torch.equal(o.tokens, outs[0].tokens)
               and torch.equal(o.steps, outs[0].steps) for o in outs):
        raise AssertionError(f"{name}: the tick's graphs and its eager run "
                             f"differ")
    front = replay_ms(exe.front)
    exe.front()
    chunk = replay_ms(exe.chunk)
    log(f"[ws] {name}: one tick at B={len(clips)} (bucket {bf} frames, "
        f"max_new {run['max_new']}) under torch.profiler: {wall * 1e3:.2f} "
        f"ms wall, device busy {busy * 1e3:.2f} ms = {busy / wall:.1%}; "
        f"accepted {run['accepted']}, steps {run['steps']}, "
        f"{run['steps_run']} computed; graph = eager bit for bit; front "
        f"graph {front:.3f} ms, a chunk {chunk:.3f} ms (device, replays) | "
        f"{card}")
    return {"exe": exe, "front_ms": front, "chunk_ms": chunk, "run": run}


def f32_tick_check(dev, bf16_model, ticks, card: str) -> None:
    """The same tick batch at full width in f32 (the bf16 weights
    widened): each row's tokens must equal its window's plain greedy run
    at B=1, as in the CPU tests and phase 10 (a). In bf16 they may not:
    a verify window's products and a row of a batch round apart from a
    B=1 decode step's, and the random weights' logits are flat enough
    that such a rounding flips a token."""
    import copy
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    model = copy.copy(bf16_model)
    model.params = cast_tree(bf16_model.params, torch.float32)
    engine = TranscriptionEngine(model, device=dev, dtype=torch.float32)
    windows = ticks[-4:]
    clips = [a for a, _, _, _ in windows]
    rows = [d for _, _, d, _ in windows]
    langs = [lang for _, lang, _, _ in windows]
    bf, bs = engine.bucket_frames(max(len(c) for c in clips))
    _, ids = engine._run_bucket(clips, bf, bs, None, resume_rows=rows,
                                language_rows=langs)
    run = dict(engine.last_run)
    plain = [engine.transcribe(c, 16000, lang)[0].token_ids
             for c, lang in zip(clips, langs)]
    log(f"[ws] preset:1.7b f32, one tick at B={len(clips)} (bucket {bf} "
        f"frames, the bf16 run's last windows and drafts): accepted "
        f"{run['accepted']}, steps {run['steps']}; rows equal to their "
        f"plain greedy run at B=1: {sum(a == b for a, b in zip(ids, plain))}"
        f"/{len(clips)} | {card}")
    if ids != plain:
        raise AssertionError(f"f32 tick rows {ids} differ from plain "
                             f"{plain}")


def cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def realtime_phase(dev, bf16_model) -> dict:
    """Phase 10: real-time transcription over WS /ws/transcribe (resume
    decoding, tick batching, the server VAD). Returns the kernels' launches
    over its runs."""
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    card = card_line()
    saved = {k: os.environ.get(k) for k in (*WS_ENV, *DEFAULT_ENV)}
    clips = ["english_01.wav", "chinese_01.wav", "japanese_01.wav",
             "hindi_01.wav"]
    total = {}

    def add(got):
        for k, n in got.items():
            total[k] = total.get(k, 0) + n

    try:
        os.environ.update(WS_ENV)
        vad_phase(dev, card)
        add(solo_ws_phase(dev, card))
        # (b) preset:1.7b bf16, tick mode
        engine = TranscriptionEngine(bf16_model, device=dev,
                                     dtype=torch.bfloat16)
        manager = warm_ws(engine, card, "(b) preset:1.7b bf16")
        launches, _, ticks = tick_sessions(engine, manager, card,
                                           "(b) preset:1.7b bf16", clips)
        if not launches["decode_attention_batch"]:
            raise AssertionError("(b): #3 was not launched")
        add(launches)
        tick_busy_share(engine, ticks, card, "(b) preset:1.7b bf16")
        del engine, manager
        torch.cuda.empty_cache()
        f32_tick_check(dev, bf16_model, ticks, card)
        del ticks
        torch.cuda.empty_cache()
        # (c) the JAX package's default serving row
        engine, _ = quantized_engine(dev, DEFAULT_ENV, card,
                                     "(c) int8 + int4 KV + W8A8")
        manager = warm_ws(engine, card, "(c) int8 + int4 KV + W8A8")
        verify = {}
        for key, exe in engine.executables.items():
            if exe.resume:
                plain = engine.executables.get(key[:4])
                if plain is not None:
                    verify[key[:3]] = (exe.front.recorded["qgemm"]
                                       - plain.front.recorded["qgemm"])
        log(f"[ws] (c): kernel C launches the verify window adds to a "
            f"front graph, by (bucket, max_new, B): {verify}")
        launches, _, ticks = tick_sessions(engine, manager, card,
                                           "(c) int8 + int4 KV + W8A8",
                                           clips)
        if not (launches["decode_attention_batch_int4"]
                and launches["qgemm"] and launches["qgemv"]) or \
                launches["widened_product"] or not any(verify.values()):
            raise AssertionError(f"(c): launches {launches}, verify "
                                 f"products {verify}")
        add(launches)
        del engine, manager, ticks
        torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    from qwen3_asr_tpu_torch.audio import vad
    log(f"[ws] phase 10 launches: {total}; VAD failures counted "
        f"{vad.failures}")
    if vad.failures:
        raise AssertionError(f"the VAD failed {vad.failures} time(s) and "
                             f"answered speech")
    return total


# -- phase 11 --------------------------------------------------------------------

SIDECAR_CLIPS = ("english_01", "chinese_02", "japanese_01")
EDGE_TOL = 1e-3        # word edges, the card (f32) against the CPU
# the SSE phase: 4 streams of a 20 s clip in 5 s chunks stepping 4 s
SSE_STREAMS, SSE_CLIP_S = 4, 20


def post_form(url: str, data: bytes, fields=(), timeout: float = 600,
              headers=None):
    """POST a multipart upload with form ``fields`` (and ``headers``):
    (status, response headers, body bytes), whatever the status."""
    bnd = uuid.uuid4().hex
    body = b"".join(
        f"--{bnd}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
        f"{v}\r\n".encode() for k, v in dict(fields).items())
    body += (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
             f"filename=\"a.wav\"\r\n\r\n").encode() + data + \
        f"\r\n--{bnd}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={bnd}",
                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


class FakeLLM:
    """An OpenAI-compatible chat endpoint on 127.0.0.1 (standard library):
    records each request body; answers "[n] translated" (n: the prompt's
    length), the SRT it was sent in a markdown fence, or HTTP 500 with
    ``fail``."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.bodies, self.fail = [], False
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                fake.bodies.append(body)
                user = body["messages"][1]["content"]
                content = ("```srt\n" + user.split("SRT Content:\n", 1)[1]
                           + "\n```" if "SRT Content:" in user
                           else f"[{len(user)}] translated")
                data = json.dumps({"choices": [{"message": {
                    "content": content}}]}).encode()
                self.send_response(500 if fake.fail else 200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/v1"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


class AlignerCalls:
    """Wraps an aligner's ``encode``: the mel frames of each call and the
    flash launches made inside them."""

    def __init__(self, aligner):
        from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
        self.frames, self.flash = [], 0
        encode = aligner.encode

        def counted(audio):
            n = flash_attention.launches
            out = encode(audio)
            self.flash += flash_attention.launches - n
            self.frames.append(aligner.mel_frames(len(audio)))
            return out

        aligner.encode = counted


def srt_events(srt: str) -> list:
    """(index, start s, end s, text) of each SRT event."""
    out = []
    for block in filter(None, srt.strip().split("\n\n")):
        lines = block.split("\n")
        times = []
        for stamp in lines[1].split(" --> "):
            h, m, rest = stamp.split(":")
            sec, ms = rest.split(",")
            times.append(int(h) * 3600 + int(m) * 60 + int(sec)
                         + int(ms) / 1000)
        out.append((int(lines[0]), times[0], times[1], "\n".join(lines[2:])))
    return out


def same_words(name: str, ours: list, ref: list, tol: float) -> float:
    """Word dicts (or SRT events) equal in text and within ``tol`` s at
    every edge: the largest difference, or AssertionError."""
    key = (lambda w: w["word"]) if ours and isinstance(ours[0], dict) \
        else (lambda e: (e[0], e[3]))
    edges = (lambda w: (w["start"], w["end"])) if ours and \
        isinstance(ours[0], dict) else (lambda e: e[1:3])
    if [key(w) for w in ours] != [key(w) for w in ref] or not ours:
        raise AssertionError(f"{name}: words {ours} vs the CPU's {ref}")
    worst = max(abs(a - b) for x, y in zip(ours, ref)
                for a, b in zip(edges(x), edges(y)))
    if worst > tol:
        raise AssertionError(f"{name}: an edge {worst} s from the CPU's")
    return worst


def sidecar_f32_phase(dev, card: str) -> dict:
    """(a) trained_ckpt in f32 on the card, ``FORCED_ALIGNER_ID`` at the
    same checkpoint, its aligner on the card in f32: ``return_timestamps``
    and accurate SRTs of real clips through the server equal the port's on
    the CPU (words equal, edges within EDGE_TOL; SRT times within
    EDGE_TOL plus their ms rounding); (d) translations (json, srt) through
    a fake LLM on 127.0.0.1, and its failure as 502. Returns the launches
    and the flash launches inside alignments."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
    from qwen3_asr_tpu_torch.serving.server import (merge_results,
                                                    merge_timestamps)
    from qwen3_asr_tpu_torch.sidecars import subtitle
    from qwen3_asr_tpu_torch.sidecars.aligner import AlignerEngine
    from qwen3_asr_tpu_torch.text.repetition import detect_and_fix_repetitions
    ckpt = os.path.join(DATA, "trained_ckpt")
    subtitle.FORCED_ALIGNER_ID = ckpt
    wavs = {}
    for name in SIDECAR_CLIPS:
        with open(os.path.join(DATA, "real", name + ".wav"), "rb") as f:
            wavs[name] = f.read()
    # the CPU's answers: the same port on CPU tensors
    cpu = load_engine(ckpt, device="cpu")
    subtitle.unload_aligner()
    subtitle.load_aligner("cpu")
    want = {}
    for name, data in wavs.items():
        audio, sr = decode_audio(data)
        res = cpu.transcribe(audio, sr, None, True)
        text, lang = merge_results(res)
        for r in res:
            r.text = detect_and_fix_repetitions(r.text)
        want[name] = ({"text": detect_and_fix_repetitions(text),
                       "language": lang, "timestamps": merge_timestamps(res)},
                      subtitle.generate_srt_from_results(res, audio, sr,
                                                         "accurate"))
    subtitle.unload_aligner()
    del cpu
    gpu = load_engine(ckpt, device=dev, dtype=torch.float32)
    # the aligner of FORCED_ALIGNER_ID in f32 on the card (bf16 is the
    # default there): the server's own load then finds it loaded
    subtitle._aligner = AlignerEngine.load(ckpt, dev, torch.float32)
    calls = AlignerCalls(subtitle._aligner)
    llm = FakeLLM()
    saved = os.environ.get("OPENAI_BASE_URL")
    os.environ["OPENAI_BASE_URL"] = llm.url
    worst = {"timestamps": 0.0, "srt": 0.0}
    try:
        with serving(ModelManager(gpu)) as url:
            base = url.rsplit("/v1/", 1)[0]
            counter = PathLaunches(gpu)
            for name, data in wavs.items():
                st, _, raw = post_form(url, data,
                                       {"return_timestamps": "true"})
                body, (ref, ref_srt) = json.loads(raw), want[name]
                if st != 200 or (body["text"], body["language"]) != \
                        (ref["text"], ref["language"]):
                    raise AssertionError(f"(a) {name}: {st} {body} vs the "
                                         f"CPU's {ref}")
                worst["timestamps"] = max(worst["timestamps"], same_words(
                    name, body["timestamps"], ref["timestamps"], EDGE_TOL))
                st, hdr, srt = post_form(base + "/v1/audio/subtitles", data,
                                         {"mode": "accurate"})
                if st != 200 or "subtitles.srt" not in \
                        hdr["Content-Disposition"]:
                    raise AssertionError(f"(a) {name} subtitles: {st}")
                worst["srt"] = max(worst["srt"], same_words(
                    name + " SRT", srt_events(srt.decode()),
                    srt_events(ref_srt), EDGE_TOL + 1e-3))
            launches, eager = counter.read()
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                state = json.loads(r.read())["aligner"]
            # (d) translations of a real clip through the fake LLM
            data = wavs["english_01"]
            st, _, raw = post_form(base + "/v1/audio/translations", data,
                                   {"language": "zh"})
            jbody = json.loads(raw)
            st2, hdr, srt = post_form(base + "/v1/audio/translations", data,
                                      {"response_format": "srt"})
            llm.fail = True
            st3, _, err = post_form(base + "/v1/audio/translations", data)
    finally:
        llm.close()
        if saved is None:
            os.environ.pop("OPENAI_BASE_URL", None)
        else:
            os.environ["OPENAI_BASE_URL"] = saved
    log(f"[sidecar] (a) trained_ckpt f32, FORCED_ALIGNER_ID=trained_ckpt, "
        f"aligner f32 on the card: {len(wavs)} real clips' "
        f"return_timestamps and accurate SRTs equal the CPU's (words equal; "
        f"largest edge difference {worst['timestamps']:.2e} s in the "
        f"timestamps, {worst['srt']:.2e} s in the SRTs, bound {EDGE_TOL:g}); "
        f"/health aligner {state}; aligner calls {len(calls.frames)} (mel "
        f"frames {sorted(set(calls.frames))}), flash launches inside them "
        f"{calls.flash}; launches {launches}, eager {eager} | {card}")
    if state != "loaded" or not calls.flash:
        raise AssertionError(f"(a): aligner {state}, flash launches in "
                             f"alignments {calls.flash}")
    ok = (st == st2 == 200 and jbody["language"] == "zh"
          and jbody["text"].endswith("translated") and b"-->" in srt
          and not srt.startswith(b"```")
          and "translated_subtitles.srt" in hdr["Content-Disposition"]
          and st3 == 502
          and json.loads(err)["code"] == "TRANSLATION_FAILED"
          and [b["temperature"] for b in llm.bodies] == [0.3, 0.1, 0.3])
    log(f"[sidecar] (d) translations through a fake LLM on 127.0.0.1: json "
        f"{st} {jbody}, srt {st2} ({len(srt)} bytes, fence stripped), LLM "
        f"down {st3} {json.loads(err)['code']}; temperatures "
        f"{[b['temperature'] for b in llm.bodies]}")
    if not ok:
        raise AssertionError("(d): translations")
    del gpu
    torch.cuda.empty_cache()
    return launches, calls.flash


def read_sse(url: str, data: bytes, t_start: float):
    """One SSE stream: (events, seconds from ``t_start`` to the first event
    and to the end)."""
    import http.client
    from urllib.parse import urlsplit
    bnd = uuid.uuid4().hex
    body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\n\r\n").encode() + data + \
        f"\r\n--{bnd}--\r\n".encode()
    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    conn.request("POST", u.path, body,
                 {"Content-Type": f"multipart/form-data; boundary={bnd}"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"SSE: HTTP {resp.status}")
    events, first = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            first = first or time.perf_counter() - t_start
            events.append(json.loads(line[6:]))
    conn.close()
    return events, first, time.perf_counter() - t_start


def sidecar_bf16_phase(engine, card: str) -> tuple:
    """(b) preset:1.7b bf16 (phase 5's engine) with its aligner on the same
    weights (``AlignerEngine(engine.model)``, no second copy): accurate
    SRTs of a 120 s and a 330 s upload through the server (the 330 s one
    in a 300 s and a 30 s aligner call), or, when the random weights
    transcribe to nothing, ``generate_srt_from_results`` on the same audio
    with a fixed English transcript (1.5 words a second), on the device
    thread; the aligner's encoder at 30/60/120/300 s. (c) SSE: 4
    concurrent streams of a 20 s real clip. Returns (launches, flash
    launches inside alignments)."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    from qwen3_asr_tpu_torch.sidecars import subtitle
    from qwen3_asr_tpu_torch.sidecars.aligner import AlignerEngine
    audio = real_audio()
    long = np.tile(audio, -(-330 * 16000 // len(audio)))[:330 * 16000]
    words = []
    for name in ("english_01", "english_02"):
        with open(os.path.join(DATA, "real", name + ".txt"),
                  encoding="utf-8") as f:
            words += f.read().split()

    class Fixed:
        language = "en"

        def __init__(self, seconds):
            n = int(1.5 * seconds)
            self.text = " ".join(words[i % len(words)] for i in range(n))

    aligner = AlignerEngine(engine.model)
    calls = AlignerCalls(aligner)
    manager = ModelManager(engine)
    with serving(manager) as url:
        subtitle._aligner = aligner
        base = url.rsplit("/v1/", 1)[0]
        counter = PathLaunches(engine)
        for sec in (120, 330):
            clip = long[:sec * 16000]
            n0 = len(calls.frames)
            t0 = time.perf_counter()
            st, _, srt = post_form(base + "/v1/audio/subtitles",
                                   encode_wav(clip, 16000),
                                   {"mode": "accurate"})
            wall = time.perf_counter() - t0
            srt, how = srt.decode(), "the server's transcript"
            if st != 200:
                raise AssertionError(f"(b) {sec} s subtitles: {st} {srt}")
            if not srt.strip():
                how = f"a fixed transcript of {int(1.5 * sec)} words"
                t0 = time.perf_counter()
                srt = manager.queue.submit(
                    lambda clip=clip, sec=sec:
                        subtitle.generate_srt_from_results(
                            [Fixed(sec)], clip, 16000, "accurate")
                ).result(timeout=600)
                wall = time.perf_counter() - t0
            events = srt_events(srt)
            frames = calls.frames[n0:]
            want = [30000, 3000] if sec == 330 else [12000]
            log(f"[sidecar] (b) preset:1.7b bf16, accurate SRT of {sec} s "
                f"({how}): {len(events)} events, last ends "
                f"{events[-1][2] if events else None} s; aligner calls of "
                f"{frames} mel frames; {wall:.3f} s wall | {card}")
            if not events or frames != want or events[-1][2] > sec + 1:
                raise AssertionError(f"(b) {sec} s: {len(events)} events, "
                                     f"aligner frames {frames}")
        flash = calls.flash
        sse_phase(url.rsplit("/v1/", 1)[0], manager, card)
        launches, eager = counter.read()
    log(f"[sidecar] (b)+(c) launches {launches}, eager {eager}; flash "
        f"launches inside alignments {flash}")
    aligner_encoder_ms(aligner, long, card)
    return launches, flash


def aligner_encoder_ms(aligner, audio: np.ndarray, card: str) -> None:
    """The aligner's encoder at 30, 60, 120 and 300 s of ``audio``: the
    host wall of ``encode`` (mel, the encoder's eager launches, the tokens
    copied to the host; median of 5, every length warmed first) beside
    ``encoder_forward``'s device time (CUDA-graph replays)."""
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import device_ms
    lengths = (30, 60, 120, 300)
    for sec in lengths:
        aligner.encode(audio[:sec * 16000])
    rows = []
    for sec in lengths:
        clip = audio[:sec * 16000]
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aligner.encode(clip)
            walls.append(time.perf_counter() - t0)
        frames = aligner.mel_frames(len(clip))
        padded = torch.zeros((1, frames * 160), device=aligner.device)
        padded[0, :len(clip)] = torch.from_numpy(clip).to(aligner.device)
        with torch.inference_mode():
            mel = aligner.frontend(padded)[0].to(aligner.dtype)
            lens = torch.full((1,), frames, dtype=torch.int32,
                              device=aligner.device)
            ms = device_ms(lambda: encoder_forward(
                aligner.model.params["encoder"], aligner.model.cfg.encoder,
                mel, lens), iters=5, reps=2)
        rows.append(f"{sec} s {np.median(walls) * 1e3:.1f} ms wall, "
                    f"{ms:.2f} ms device")
        del mel, padded
        torch.cuda.empty_cache()
    log(f"[sidecar] (b) the aligner's encoder "
        f"({aligner.model.cfg.encoder.encoder_layers} layers) by seconds "
        f"of audio: " + "; ".join(rows) + f" | {card}")


def sse_phase(base: str, manager, card: str) -> None:
    """(c) ``SSE_STREAMS`` concurrent streams of a ``SSE_CLIP_S`` s real
    clip, after the keys their batches can reach (B = 1, 2 and 4 at the
    chunks' 6 s bucket and the last one's 4 s) are built on the device
    thread, then once more, timed, building no key. Every stream's events
    in order (chunk_index 0.., the last final), then ``done``; fewer
    dispatches than chunks."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    url = base + "/v1/audio/transcriptions/stream"
    data = encode_wav(real_audio()[:SSE_CLIP_S * 16000], 16000)
    engine = manager.engine

    def warm():
        for sec in (5, 4):
            clip = np.zeros(sec * 16000, np.float32)
            bf, bs = engine.bucket_frames(len(clip))
            for batch in (1, 2, 4):
                engine._run_bucket([clip] * batch, bf, bs, None)

    manager.queue.submit(warm).result(timeout=600)

    def streams():
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SSE_STREAMS) as pool:
            return list(pool.map(lambda _: read_sse(url, data, t0),
                                 range(SSE_STREAMS)))

    before = manager.batcher.dispatches
    keys = engine.executable_count
    out = streams()
    dispatches = manager.batcher.dispatches - before
    if engine.executable_count != keys:
        raise AssertionError("(c): the timed streams built a key")
    chunks = 0
    for events, _, _ in out:
        body = events[:-1]
        chunks += len(body)
        if events[-1] != {"done": True} or not body or \
                [e.get("chunk_index") for e in body] != \
                list(range(len(body))) or not body[-1]["is_final"] or \
                any(e["is_final"] for e in body[:-1]):
            raise AssertionError(f"(c) SSE events {events}")
    firsts = [f for _, f, _ in out]
    totals = [t for _, _, t in out]
    log(f"[sidecar] (c) SSE: {SSE_STREAMS} concurrent streams of a "
        f"{SSE_CLIP_S} s real clip, their keys built: {chunks} chunks in "
        f"{dispatches} "
        f"dispatches; first event {np.median(firsts):.3f} s (median), "
        f"{max(firsts):.3f} s (max); whole stream {np.median(totals):.3f} s "
        f"(median), {max(totals):.3f} s (max); events in order, then done "
        f"| {card}")
    if dispatches >= chunks:
        raise AssertionError(f"(c): {dispatches} dispatches for {chunks} "
                             f"chunks")


def sidecar_phase(dev, engine) -> dict:
    """Phase 11: word timestamps and the forced aligner, SRT subtitles,
    SSE streaming and translations. Returns the kernels' launches over its
    runs; fails unless flash launched inside alignments and no alignment
    or VAD failure was counted."""
    from qwen3_asr_tpu_torch.audio import vad
    from qwen3_asr_tpu_torch.sidecars import subtitle
    card = card_line()
    saved = os.environ.get("SKIP_WARMUP")
    os.environ["SKIP_WARMUP"] = "true"     # keys are built on first use
    total = {}
    try:
        for launches, flash in (sidecar_f32_phase(dev, card),
                                sidecar_bf16_phase(engine, card)):
            if not flash:
                raise AssertionError("flash did not launch in alignments")
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
    finally:
        subtitle.unload_aligner()
        if saved is None:
            os.environ.pop("SKIP_WARMUP", None)
        else:
            os.environ["SKIP_WARMUP"] = saved
    log(f"[sidecar] phase 11 launches {total}; failures counted: alignments "
        f"{subtitle.failures}, VAD {vad.failures}")
    if subtitle.failures or vad.failures:
        raise AssertionError(f"alignment failures {subtitle.failures}, VAD "
                             f"failures {vad.failures}")
    return total


# -- phase 12 --------------------------------------------------------------------

# the waves of phase 12: 8 uploads of each bucket's seconds at once, the
# waves WAVE_GAP_S apart, longest first (the window climbs 8 -> 16 -> 32)
POOL_WAVES = (30, 15, 10)
WAVE_GAP_S = 0.25
POOL_ENV = {"ASR_CONTINUOUS_BATCHING": "true"}


@contextlib.contextmanager
def environ(**values):
    """``os.environ`` updated with ``values`` while it is open."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def transcription_url(ws_url: str) -> str:
    return ws_url.replace("ws://", "http://").replace(
        "/ws/transcribe", "/v1/audio/transcriptions")


class WindowTrace:
    """The pool's window, sampled every 2 ms while it is open: the sequence
    of the values it took."""

    def __init__(self, pool):
        self.pool, self.seq = pool, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            if not self.seq or self.seq[-1] != self.pool.window:
                self.seq.append(self.pool.window)
            time.sleep(0.002)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


@contextlib.contextmanager
def generated_tokens(engine, pool=None):
    """A one-item list counting the tokens generated while it is open: the
    pool's rows at their retirement, or the engine's bucket runs."""
    count = [0]
    if pool is not None:
        retire = pool._retire

        def counted(slot):
            count[0] += len(pool._tokens[slot])
            retire(slot)
        pool._retire = counted
    else:
        from qwen3_asr_tpu_torch.runtime.engine import max_new_tokens_for
        run_bucket = engine._run_bucket

        def counted(clips, bucket_frames, bucket_s, *a, **k):
            texts, ids = run_bucket(clips, bucket_frames, bucket_s, *a, **k)
            # a row's tokens, its EOS included; not the batch's pad rows
            # (the 0.1 s silent clips of _pad_pow2)
            budget = max_new_tokens_for(bucket_s)
            count[0] += sum(min(len(i) + 1, budget)
                            for c, i in zip(clips, ids)
                            if len(c) != 1600 or c.any())
            return texts, ids
        engine._run_bucket = counted
    try:
        yield count
    finally:
        if pool is not None:
            del pool._retire
        else:
            del engine._run_bucket


def wave_clips():
    """POOL_WAVES' clips: for each wave, 8 cuts of the real clips joined,
    each 0.5 s short of its bucket, from distinct offsets."""
    audio = real_audio()
    return [[audio[(3 * i + w) * 16000:(3 * i + w) * 16000
                   + int((sec - 0.5) * 16000)] for i in range(8)]
            for w, sec in enumerate(POOL_WAVES)]


def send_waves(url: str, waves) -> tuple:
    """Each wave's bodies at once (a thread each), the waves WAVE_GAP_S
    apart: ({(wave, i): (body, wall s)}, the run's wall s)."""
    results = {}

    def one(key, data):
        t0 = time.perf_counter()
        body = post(url, data)
        results[key] = (body, time.perf_counter() - t0)

    threads = []
    t0 = time.perf_counter()
    for w, wave in enumerate(waves):
        for i, data in enumerate(wave):
            threads.append(threading.Thread(target=one, args=((w, i), data)))
            threads[-1].start()
        if w + 1 < len(waves):
            time.sleep(WAVE_GAP_S)
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(results) != sum(map(len, waves)):
        raise AssertionError(f"{len(results)} of {sum(map(len, waves))} "
                             f"uploads answered")
    for body, _ in results.values():
        if not isinstance(body.get("text"), str) or "language" not in body:
            raise AssertionError(f"bad response {body}")
    return results, wall


def pool_ids(manager, clips, under_lock: bool = False) -> list:
    """Token ids of ``clips`` through ``manager``'s pool, all submitted at
    once; ``under_lock``: while holding the pool's lock, so that its drive
    thread takes them in one admission round (a fixed schedule)."""
    pool = manager.pool
    out, done = {}, threading.Event()

    def cb(i):
        def ok(text, ids):
            out[i] = ids
            if len(out) == len(clips):
                done.set()

        def err(e):
            out[i] = e
            done.set()
        return ok, err

    with (pool._cv if under_lock else contextlib.nullcontext()):
        for i, clip in enumerate(clips):
            pool.submit(clip, None, *cb(i))
    if not done.wait(timeout=600):
        raise AssertionError("the pool did not answer in 600 s")
    bad = [o for o in out.values() if isinstance(o, Exception)]
    if bad:
        raise bad[0]
    return [out[i] for i in range(len(clips))]


def agreement(ours, ref) -> str:
    """Requests with equal ids, and the share of tokens before each
    request's first difference."""
    same = sum(a == b for a, b in zip(ours, ref))
    total = sum(max(len(a), len(b)) for a, b in zip(ours, ref))
    prefix = 0
    for a, b in zip(ours, ref):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        prefix += n
    return (f"{same}/{len(ref)} requests equal, {prefix / max(total, 1):.1%} "
            f"of tokens before the first difference")


def pool_report(pool, name: str, card: str) -> None:
    """The pool's graphs (capture seconds, what each recorded) and the
    memory it holds."""
    layers = pool.model.cfg.decoder.num_hidden_layers
    for w, g in pool._decode_fns.items():
        log(f"[pool] {name} segment graph, window {w}: captured in "
            f"{g.capture_s:.3f} s, recorded {g.recorded} | {card}")
        per_step = {k: n / (layers * pool.segment)
                    for k, n in g.recorded.items() if n}
        if (g.recorded.get("qk_rope_kv_per_row") != layers * pool.segment
                or g.recorded.get("qk_rope_kv") != layers * pool.segment):
            raise AssertionError(f"{name} window {w}: recorded {g.recorded},"
                                 f" want kernel B's per-row route once a "
                                 f"layer and step")
        attn = ("decode_attention" if per_step.get("decode_attention")
                else "decode_attention_batch")
        if g.recorded.get(attn) != layers * pool.segment:
            raise AssertionError(f"{name} window {w}: {attn} recorded "
                                 f"{g.recorded.get(attn)}, want one a layer "
                                 f"and step")
    for bf, p in pool._prefill_fns.items():
        log(f"[pool] {name} prefill graph, bucket {bf} frames (prompt "
            f"{p.prompt_len}, cache {p.s_pad}): captured in "
            f"{p.graph.capture_s:.3f} s, recorded {p.graph.recorded}")
    log(f"[pool] {name}: {pool.base}..{pool.max_slots} slots (windows "
        f"{pool._sizes}), S={pool.s_pool}, "
        f"{str(pool.cache_dtype).replace('torch.', '')} cache; holds "
        f"{pool.held_bytes() / 2**30:.3f} GiB (cache, state, prefill "
        f"buffers); its {len(pool.graphs())} graphs captured in "
        f"{sum(g.capture_s for g in pool.graphs()):.2f} s | {card}")


def segment_ms(pool, name: str, card: str) -> None:
    """Device ms of one segment at each window, every row live at its own
    position (as mid-traffic), between CUDA events; the pool is idle and
    its rows are inactive again afterwards."""
    n = pool.max_slots
    with torch.inference_mode():
        for w in pool._sizes:
            pool.pos.copy_(torch.tensor([460 + (r * 37) % 200
                                         for r in range(n)]))
            pool.valid_from.fill_(0)
            pool.limit.fill_(pool.s_pool - 1)
            pool.last.fill_(1000)
            pool.active.fill_(True)
            ms = replay_ms(pool._decode_fns[w], replays=3)
            log(f"[pool] {name} segment at window {w}: {ms:.3f} ms device "
                f"({ms / pool.segment:.3f} ms a step of {w} rows) | {card}")
        pool.active.fill_(False)
        torch.cuda.synchronize()


def pool_f32_phase(real, card: str) -> dict:
    """(a) trained_ckpt in f32 on the card with ``ASR_POOL_SLOTS=4`` (the
    prefill graphs captured as buckets come): the 12 real clips at once
    through the server answer phase 4's bodies and, straight through the
    batcher, its token ids, all through the pool; a WS session with
    ``ASR_POOL_WS=true`` sends its partials and final through the pool;
    no fused key is built."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    gpu, wavs, want_bodies, want_ids = real
    manager = ModelManager(gpu)
    keys = len(gpu.executables)
    with environ(ASR_CONTINUOUS_BATCHING="true", ASR_POOL_SLOTS="4",
                 ASR_POOL_WS="true", SKIP_WARMUP="true"):
        with ws_serving(manager) as ws_url:
            pool = manager.pool
            counter = PathLaunches(gpu, pool)
            t0 = time.perf_counter()
            bodies, walls = post_all(transcription_url(ws_url), wavs)
            wall = time.perf_counter() - t0
            futures = [manager.batcher.transcribe(*decode_audio(w), None)
                       for w in wavs]
            ids = [f.result(timeout=600)[0].token_ids for f in futures]
            admitted = pool.admitted
            msgs = ws_stream(ws_url, real_pcm("english_02.wav"),
                             "?use_server_vad=false")
            ws_admitted = pool.admitted - admitted
            launches, eager = counter.read()
            pool_report(pool, "trained_ckpt f32", card)
    kinds = [("final" if m.get("is_final") else "partial")
             for m in msgs if "text" in m]
    log(f"[pool] (a) trained_ckpt f32, 4..16 slots: 12 uploads at once in "
        f"{wall:.3f} s ({percentiles(walls)}), bodies equal to phase 4's: "
        f"{bodies == want_bodies}; 12 through the batcher, token ids equal "
        f"to phase 4's (the CPU's): {ids == want_ids}; {admitted} admitted; "
        f"WS: {kinds.count('partial')} partials and {kinds.count('final')} "
        f"final, {ws_admitted} transcriptions admitted to the pool of "
        f"{len(manager.ws_calls)}; final {msgs[-2].get('text')!r}; fused "
        f"keys built {len(gpu.executables) - keys}; launches {launches}, "
        f"eager {eager} (the prefills captured as buckets came) | {card}")
    if bodies != want_bodies or ids != want_ids:
        bad = [i for i, (a, b) in enumerate(zip(ids, want_ids)) if a != b]
        raise AssertionError(f"(a): the pool's answers differ from phase "
                             f"4's at clips {bad}")
    if (admitted != 2 * len(wavs) or "partial" not in kinds
            or kinds[-1] != "final" or ws_admitted != len(manager.ws_calls)
            or len(gpu.executables) != keys):
        raise AssertionError(f"(a): {admitted} admitted, WS {kinds}, "
                             f"{ws_admitted} of {len(manager.ws_calls)} "
                             f"through the pool, {len(gpu.executables) - keys}"
                             f" fused keys built")
    for name in ("flash_attention", "decode_attention", "qk_rope_kv",
                 "qk_rope_kv_per_row"):
        if not launches[name]:
            raise AssertionError(f"(a) launched no {name}")
    return launches


def pool_bf16_phase(engine, card: str) -> dict:
    """(b) preset:1.7b bf16 (phase 5's engine, its keys warm), the pool at
    its defaults (8 -> 32 slots, segments of 16): the waves through the
    server with the pool and through the micro-batcher with it off, in
    turns (pool, batcher, batcher, pool): walls p50/p90 and tokens/s; a
    45 s upload (long-form, fused) during a fifth run, through the pool,
    equals its solo run; replays only; each segment graph records #3 and kernel B's
    per-row route once a layer and step; a fixed schedule of 16 requests
    (a compaction and re-layouts on the way) through the graphs and
    eagerly gives the same bits; the agreement of the pool's tokens with
    the micro-batcher's; the segment's device ms at windows 8, 16, 32."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    waves = wave_clips()
    bodies = [[encode_wav(c, 16000) for c in wave] for wave in waves]
    flat = [c for wave in waves for c in wave]
    long_form = real_audio()[:45 * 16000]
    solo = [r.token_ids for r in engine.transcribe(long_form, 16000)]
    # the micro-batcher's keys at B=8 for the three buckets
    for sec in POOL_WAVES:
        bf, bs = engine.bucket_frames(int(sec * 16000))
        engine._run_bucket([np.zeros(1600, np.float32)] * 8, bf, bs, None)
    # phase 5 warmed the engine's keys: neither manager warms them again
    # (the pool still captures its prefills for the warmup buckets)
    batched, pooled = ModelManager(engine), ModelManager(engine)
    batched.warmed = pooled.warmed = True
    batched.batcher = MicroBatcher(batched, window_ms=200, max_batch=8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    out = {}
    with ws_serving(batched) as batch_url, environ(**POOL_ENV), \
            ws_serving(pooled) as pool_url:
        pool = pooled.pool
        torch.cuda.empty_cache()
        log(f"[pool] preset:1.7b bf16: the pool and its graphs take "
            f"{(torch.cuda.memory_reserved() - reserved) / 2**30:.3f} GiB "
            f"more reserved | {card}")
        pool_report(pool, "preset:1.7b bf16", card)
        runs = {"pool": [], "batcher": []}
        # in turns, then once more through the pool with the 45 s upload
        for turn, mode in enumerate(("pool", "batcher", "batcher", "pool",
                                     "pool")):
            mgr = pooled if mode == "pool" else batched
            url = transcription_url(pool_url if mode == "pool"
                                    else batch_url)
            side = {}
            if turn == 4:
                side["thread"] = threading.Thread(target=lambda: side.update(
                    ids=[r.token_ids for r in mgr.batcher.transcribe(
                        long_form, 16000, None).result(timeout=600)]))
            counter = PathLaunches(engine, pool)
            dispatches = batched.batcher.dispatches
            with generated_tokens(engine, pool if mode == "pool" else None) \
                    as n, WindowTrace(pool) as trace:
                if "thread" in side:
                    side["thread"].start()
                results, wall = send_waves(url, bodies)
                if "thread" in side:
                    side["thread"].join(timeout=600)
            launches, eager = counter.read()
            walls = [w for _, w in results.values()]
            if turn < 4:
                runs[mode].append((n[0] / wall, walls))
            log(f"[pool] preset:1.7b bf16, {mode} run {turn + 1}"
                + (" with the 45 s upload" if turn == 4 else "")
                + f": 24 uploads "
                f"({'/'.join(map(str, POOL_WAVES))} s waves of 8, "
                f"{WAVE_GAP_S} s apart) in {wall:.3f} s, {n[0]} tokens = "
                f"{n[0] / wall:.1f} tokens/s; request walls "
                f"{percentiles(walls)}"
                + (f"; windows {trace.seq}" if mode == "pool" else
                   f"; {batched.batcher.dispatches - dispatches} dispatches")
                + f"; launches {launches}, eager {eager} | {card}")
            if mode == "pool":
                if any(eager.values()):
                    raise AssertionError(f"pool run: eager launches {eager}")
                if 32 not in trace.seq or trace.seq[-1] != 8:
                    raise AssertionError(f"pool windows {trace.seq}: want "
                                         f"8 -> 16 -> 32 and back to 8")
                if turn < 4 and (launches["decode_attention"]
                                 or not launches["decode_attention_batch"]):
                    raise AssertionError(f"pool run: launches {launches}")
                for k, v in launches.items():
                    out[k] = out.get(k, 0) + v
            if "ids" in side:
                log(f"[pool] the 45 s upload (long-form, {len(solo)} "
                    f"segments, fused) during the pool run: token ids equal"
                    f" to its solo run: {side['ids'] == solo}")
                if side["ids"] != solo:
                    raise AssertionError("the 45 s upload served beside the "
                                         "pool differs from its solo run")
        for mode, got in runs.items():
            rates = [r for r, _ in got]
            walls = [w for _, ws in got for w in ws]
            log(f"[pool] preset:1.7b bf16, {mode}: {', '.join(f'{r:.1f}' for r in rates)} "
                f"tokens/s; request walls {percentiles(walls)} | {card}")

        # a fixed schedule: 8 cuts of the 10 s wave (rows 0-7) and 8 of the
        # 30 s (rows 8-15) taken in one round, through the graphs and then
        # eagerly: the 10 s rows retire first, the 30 s ones are compacted
        # into rows 0-7 and the window shrinks 16 -> 8
        fixed = waves[2] + waves[0]
        got = {}
        for mode in ("graph", "eager"):
            pool.eager = mode == "eager"
            try:
                with WindowTrace(pool) as trace:
                    t0 = time.perf_counter()
                    ids = pool_ids(pooled, fixed, under_lock=True)
                    wall = time.perf_counter() - t0
            finally:
                pool.eager = False
            got.setdefault("ids", ids)
            log(f"[pool] fixed schedule, {mode}: {wall:.3f} s, windows "
                f"{trace.seq}, rows moved so far {pool.moved}; ids equal to"
                f" the first run's: {ids == got['ids']} | {card}")
            if ids != got["ids"] or trace.seq[-1] != 8 or 16 not in trace.seq:
                raise AssertionError(f"fixed schedule, {mode}: ids differ or"
                                     f" windows {trace.seq}")
        if not pool.moved:
            raise AssertionError("the fixed schedule compacted no row")

        # the pool's tokens against the micro-batcher's, in bf16
        ours = pool_ids(pooled, flat)
        futures = [batched.batcher.transcribe(c, 16000, None) for c in flat]
        ref = [f.result(timeout=600)[0].token_ids for f in futures]
        log(f"[pool] bf16 agreement, pool against the micro-batcher (B=8) "
            f"on the 24 clips: {agreement(ours, ref)} | {card}")
        segment_ms(pool, "preset:1.7b bf16", card)
    return out


def pool_quantized_phase(dev, card: str) -> dict:
    """(c) the waves with QUANTIZE=int8 ASR_KV_CACHE_DTYPE=int4
    ASR_INT8_ACT=true: the pool cache is fp8; a warm-up pass of the waves
    captures the prefills, then a timed pass from replays only: kernel A
    on windows of at most 16 rows, C at 32 and on the prompts, no W8A8."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    waves = wave_clips()
    bodies = [[encode_wav(c, 16000) for c in wave] for wave in waves]
    with environ(**DEFAULT_ENV, **POOL_ENV, SKIP_WARMUP="true"):
        engine, _ = quantized_engine(dev, DEFAULT_ENV, card,
                                     "int8 + int4 KV + W8A8, pooled")
        manager = ModelManager(engine)
        launches = pool_quantized_waves(engine, manager, bodies, card)
    del engine, manager
    torch.cuda.empty_cache()
    return launches


def pool_quantized_waves(engine, manager, bodies, card: str) -> dict:
    """(c)'s runs on ``manager``'s pool: the warm-up pass, then the timed
    one and the segment's device ms. Returns the timed pass's launches."""
    with ws_serving(manager) as url:
        pool = manager.pool
        url = transcription_url(url)
        if pool.cache_dtype != torch.float8_e4m3fn:
            raise AssertionError(f"int4 engine's pool cache "
                                 f"{pool.cache_dtype}")
        send_waves(url, bodies)
        counter = PathLaunches(engine, pool)
        with generated_tokens(engine, pool) as n, WindowTrace(pool) as trace:
            results, wall = send_waves(url, bodies)
        launches, eager = counter.read()
        walls = [w for _, w in results.values()]
        log(f"[pool] int8 + int4 KV (fp8 pool cache): 24 uploads in "
            f"{wall:.3f} s, {n[0]} tokens = {n[0] / wall:.1f} tokens/s; "
            f"request walls {percentiles(walls)}; windows {trace.seq}; "
            f"launches {launches}, eager {eager} | {card}")
        pool_report(pool, "int8 + int4 KV", card)
        by_window = {w: g.recorded for w, g in pool._decode_fns.items()}
        if (any(eager.values()) or 32 not in trace.seq
                or launches["w8a8"] or launches["widened_product"]
                or launches["decode_attention_batch_int4"]
                or not launches["decode_attention_batch"]
                or any(by_window[w].get("qgemm") for w in (8, 16))
                or any(by_window[w].get("qgemv") for w in (32,))
                or not by_window[32].get("qgemm")):
            raise AssertionError(f"(c): launches {launches}, eager {eager}, "
                                 f"windows {trace.seq}, recorded {by_window}")
        segment_ms(pool, "int8 + int4 KV", card)
    return launches


def pool_phase(dev, bf16_engine, real) -> dict:
    """Phase 12: continuous batching (``runtime/pool.py``), (a)-(c). Returns
    each kernel's launches over the phase's runs, each counted from 0."""
    card = card_line()
    total = {}
    for got in (pool_f32_phase(real, card), pool_bf16_phase(bf16_engine, card),
                pool_quantized_phase(dev, card)):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    log(f"[pool] phase 12 launches {total}")
    return total


# -- phase 13 --------------------------------------------------------------------

STREAM_CAP_F32 = 8.5      # (a): pins trained_ckpt's 10 s bucket, 5 blocks
STREAM_CAP_S = 30.0       # (b), (c): pins the 30 s bucket, 8 blocks
STREAM_SECONDS = 20.0     # (b) and (c): the real clips' first 20 s, unpaced
# a lone session: no batched flush keys to warm, and the cap's bucket
STREAM_ENV = {"ASR_WS_STREAM_MODE": "prefix", "WS_WINDOW_MAX_S": "30",
              "ASR_WS_TICK_MAX_BATCH": "1", "ASR_WARMUP_BUCKETS": "30",
              "ASR_WARMUP_BATCH_SHAPES": ""}


@contextlib.contextmanager
def ws_cap(cap_s: float):
    """The WS route's window cap (module constants read at its import)."""
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    saved = ws_mod.WS_WINDOW_MAX_S, ws_mod.WS_WINDOW_MAX_BYTES
    ws_mod.WS_WINDOW_MAX_S = cap_s
    ws_mod.WS_WINDOW_MAX_BYTES = int(cap_s * 16000 * 2)
    try:
        yield
    finally:
        ws_mod.WS_WINDOW_MAX_S, ws_mod.WS_WINDOW_MAX_BYTES = saved


def stream_windows(audio: np.ndarray, cap_s: float, chunk: int) -> list:
    """The partial windows of a WS session: 450 ms appends, trimmed at the
    cap in ``chunk``-sample steps."""
    cap, tick = int(cap_s * 16000), int(0.45 * 16000)
    window, out = np.zeros(0, np.float32), []
    for off in range(0, len(audio), tick):
        window = np.concatenate([window, audio[off:off + tick]])
        if len(window) > cap:
            window = window[-(-(len(window) - cap) // chunk) * chunk:]
        out.append(window)
    return out


class TickTimer:
    """Each session tick's stream time (CUDA events around
    ``StreamSession._run``, which ends on its one host read) and kind:
    ``full`` (from position 0), ``redo`` (the clamp max proven wrong),
    ``tail@<rung>``."""

    def __init__(self):
        from qwen3_asr_tpu_torch.runtime.stream import StreamSession
        self.cls, self.orig, self.ticks = StreamSession, \
            StreamSession._run, []
        timer = self

        def timed(sess, window, changed, clamp, seg_start):
            redo = sess.stats["redo"] > getattr(sess, "_timer_redo", 0)
            sess._timer_redo = sess.stats["redo"]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = timer.orig(sess, window, changed, clamp, seg_start)
            end.record()
            end.synchronize()
            kind = ("redo" if redo else "full" if seg_start == 0
                    else f"tail@{seg_start}")
            timer.ticks.append((kind, len(changed),
                                sess.last_run["chunks"],
                                start.elapsed_time(end)))
            return out

        StreamSession._run = timed

    def close(self) -> None:
        self.cls._run = self.orig

    def report(self, name: str, card: str) -> dict:
        kinds = {}
        for kind, changed, chunks, ms in self.ticks:
            kinds.setdefault(kind, []).append((changed, chunks, ms))
        out = {}
        for kind, rows in sorted(kinds.items()):
            ms = [r[2] for r in rows]
            out[kind] = float(np.median(ms))
            log(f"[stream] {name}: {kind}: {len(rows)} tick(s), stream ms "
                f"median {np.median(ms):.2f} (min {min(ms):.2f}, max "
                f"{max(ms):.2f}), blocks encoded {np.mean([r[0] for r in rows]):.1f}, "
                f"chunks of 8 steps {np.mean([r[1] for r in rows]):.1f} | "
                f"{card}")
        return out


def session_launch_check(name: str, launches: dict, want) -> None:
    missing = [k for k in want if not launches.get(k)]
    if missing or launches.get("widened_product"):
        raise AssertionError(f"{name}: no launch of {missing} (launches "
                             f"{launches})")


def stream_f32_phase(dev, card: str) -> dict:
    """(a) trained_ckpt f32, cap 8.5 s: a quiet real clip then a loud one
    in 450 ms ticks with chunk trims; every tick's ids equal the fused
    resume path's at the pinned bucket on the card and the CPU session's;
    tail, full and redo ticks; two interleaved sessions give their solo
    ids; graph = eager bit for bit. Returns the session's launches."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    ckpt = os.path.join(DATA, "trained_ckpt")
    gpu = load_engine(ckpt, device=dev, dtype=torch.float32)
    cpu = load_engine(ckpt, device="cpu")

    def clip(name):
        with open(os.path.join(DATA, "real", name), "rb") as f:
            return decode_audio(f.read())[0]

    chunk = gpu.model.cfg.encoder.n_window * 2 * 160
    audio_a = np.concatenate([0.3 * clip("english_01.wav"),
                              3.0 * clip("english_02.wav")[:48000]])
    audio_b = 0.5 * clip("chinese_01.wav")
    wins_a = stream_windows(audio_a.astype(np.float32), STREAM_CAP_F32, chunk)
    wins_b = stream_windows(audio_b.astype(np.float32), STREAM_CAP_F32, chunk)
    frames, bucket_s = gpu.bucket_frames(int(STREAM_CAP_F32 * 16000))

    def solo(engine, wins, lang, eager=False):
        sess = engine.stream_session(STREAM_CAP_F32, lang)
        sess.eager = eager
        ids = [sess.update(w)[1] for w in wins]
        return sess, ids

    from qwen3_asr_tpu_torch.runtime.stream import warm_stream_keys
    warm_stream_keys(gpu, STREAM_CAP_F32)
    counter = PathLaunches(gpu)
    sess_a, ids_a = solo(gpu, wins_a, "en")
    launches, eager = counter.read()
    work = sess_a.work
    plen = sess_a.prompt_len
    snap = [x[:, :, :, :plen].clone() for x in work.loop.cache[:2]]
    snap.append(work.audio.clone())
    stats = dict(sess_a.stats)
    sess_a.release()
    fused, prev = [], []
    for w in wins_a:
        prev = gpu._run_bucket([w], frames, bucket_s, "en",
                               resume_tokens=list(prev))[1][0]
        fused.append(prev)
    cpu_sess, cpu_ids = solo(cpu, wins_a, "en")
    same_fused = sum(a == b for a, b in zip(ids_a, fused))
    same_cpu = sum(a == b for a, b in zip(ids_a, cpu_ids))
    log(f"[stream] (a) trained_ckpt f32, cap {STREAM_CAP_F32} s: "
        f"{len(wins_a)} ticks, stats {stats}; token ids equal to the "
        f"fused resume path on the card at the pinned bucket on "
        f"{same_fused}/{len(wins_a)} ticks and to the CPU session on "
        f"{same_cpu}/{len(wins_a)}; CPU stats {cpu_sess.stats}; launches "
        f"{launches} ({eager} eager) | {card}")
    if same_fused != len(wins_a) or same_cpu != len(wins_a) or not (
            stats["tail"] and stats["full"] and stats["redo"]):
        raise AssertionError(f"(a): fused {same_fused}, CPU {same_cpu} of "
                             f"{len(wins_a)} ticks; stats {stats}")
    # two sessions in turns against their solo runs
    sess_b, ids_b = solo(gpu, wins_b, "zh")
    sess_b.release()
    before = work.handovers
    a, b = gpu.stream_session(STREAM_CAP_F32, "en"), gpu.stream_session(
        STREAM_CAP_F32, "zh")
    got_a, got_b = [], []
    for i in range(max(len(wins_a), len(wins_b))):
        if i < len(wins_a):
            got_a.append(a.update(wins_a[i])[1])
        if i < len(wins_b):
            got_b.append(b.update(wins_b[i])[1])
    handovers = work.handovers - before
    log(f"[stream] (a) two sessions in turns: {handovers} hand-overs of "
        f"the working buffers ({work.state_bytes() / 1e6:.2f} MB each "
        f"way); each equal to its solo run: {got_a == ids_a} / "
        f"{got_b == ids_b} | {card}")
    if got_a != ids_a or got_b != ids_b or not handovers:
        raise AssertionError("(a): interleaved sessions differ from their "
                             "solo runs")
    a.release()
    b.release()
    # graph = eager, bit for bit: the ids of every tick, the prompt's keys
    # and the audio tokens after the last
    sess_e, ids_e = solo(gpu, wins_a, "en", eager=True)
    state = [x[:, :, :, :plen] for x in work.loop.cache[:2]] + [work.audio]
    bits = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(snap, state))
    log(f"[stream] (a) eager run of the same ticks: ids equal "
        f"{ids_e == ids_a}, the prompt's keys and audio tokens bit-equal "
        f"{bits}")
    if ids_e != ids_a or not bits:
        raise AssertionError("(a): graphs and eager differ")
    sess_e.release()
    session_launch_check("(a)", launches, ("flash_attention",
                                           "decode_attention", "qk_rope_kv"))
    if any(eager.values()):
        raise AssertionError(f"(a): eager launches {eager}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def stream_session_ws(engine, name: str, pcm: bytes, card: str,
                      warm: bool = True):
    """A prefix-mode session over WS at the 30 s cap (``STREAM_ENV``):
    the manager's warmup (timed: stream keys, capture seconds, memory),
    then one session streaming ``pcm`` unpaced, its ticks timed by kind.
    Returns (launches, partial walls, the session)."""
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    manager = ModelManager(engine)
    manager.warmed = not warm
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    manager.start()
    manager.stop()
    manager.warmed = True
    warm_s = time.perf_counter() - t0
    graphs = engine.stream_graphs()
    log(f"[stream] {name}: warmup {warm_s:.1f} s, the stream keys "
        f"{engine.stream_warmup.get('keys')} in "
        f"{engine.stream_warmup.get('seconds', 0):.1f} s ({len(graphs)} "
        f"graphs, {sum(g.capture_s for g in graphs):.2f} s of capture); "
        f"{(torch.cuda.memory_allocated() - held) / 2**30:.3f} GiB more "
        f"allocated | {card}")
    sessions = []
    orig = engine.stream_session

    def keep(*a, **k):
        sessions.append(orig(*a, **k))
        return sessions[-1]

    engine.stream_session = keep
    failures = ws_mod.prefix_bind_failures
    built = len(engine.stream_graphs())
    timer = TickTimer()
    try:
        with ws_serving(manager) as url:
            counter = PathLaunches(engine)
            msgs = ws_stream(url, pcm, "?use_server_vad=false")
            launches, eager = counter.read()
    finally:
        timer.close()
        del engine.stream_session
    walls = [w for kind, w, _ in manager.ws_calls if kind == "partial"]
    errors = [m for m in msgs if "[error" in m.get("text", "")]
    if len(sessions) != 1 or errors or \
            ws_mod.prefix_bind_failures != failures:
        raise AssertionError(f"{name}: {len(sessions)} sessions bound, "
                             f"errors {errors[:2]}, bind failures "
                             f"{ws_mod.prefix_bind_failures - failures}")
    sess = sessions[0]
    work = engine._stream_fns[("state", sess.prompt_len, sess.max_new,
                               sess.cache_dtype)]
    log(f"[stream] {name}: one session, {sess.stats}, partial wall "
        f"{percentiles(walls)}; session cache {sess.cache_dtype}, its "
        f"state {work.state_bytes() / 1e6:.1f} MB in the working buffers "
        f"(workspace {work.nbytes() / 1e6:.1f} MB), {sess.held_bytes()} "
        f"bytes of its own; {work.handovers} hand-overs; launches "
        f"{launches} ({eager} eager: the warm-up runs of the keys the "
        f"final's segments built, the 30.6 s window split at its quietest "
        f"frame); bind failures 0 | {card}")
    timer.report(name, card)
    # every tick from replays: no stream graph was built during the run
    if len(engine.stream_graphs()) != built or work.handovers:
        raise AssertionError(f"{name}: {len(engine.stream_graphs()) - built}"
                             f" stream graphs built while streaming, "
                             f"{work.handovers} hand-overs")
    return launches, walls, sess, work


def handover_ms(work, card: str) -> float:
    """Device ms of one hand-over's copies (the owner's state out, the new
    one's in) at this workspace's shapes, between CUDA events."""
    state = work.state_tensors()
    out = [torch.empty_like(x) for x in state]
    inn = [torch.empty_like(x) for x in state]

    def copy():
        for d, s_ in zip(out, state):
            d.copy_(s_)
        for d, s_ in zip(state, inn):
            d.copy_(s_)

    copy()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        copy()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10
    nbytes = 2 * 2 * work.state_bytes()     # each way read and written
    log(f"[stream] a hand-over at {work.cache_dtype}: "
        f"{2 * work.state_bytes() / 1e6:.1f} MB copied, {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s read + written) | {card}")
    return ms


def stream_graph_ms(engine, work, name: str, card: str) -> None:
    """Device ms of each stream graph (an encoder block, each rung's
    front, a chunk of 8 continuation steps), replayed between CUDA events
    on the working buffers (no session owns them by now)."""
    parts = []
    for key, fn in engine._stream_fns.items():
        if key[0] == "encode":
            parts.append(f"encode {key[1]} frames {replay_ms(fn.graph):.3f}")
    for seg_start, g in sorted(work.fronts.items()):
        parts.append(f"front@{seg_start} {replay_ms(g):.3f}")
    parts.append(f"chunk {replay_ms(work.chunk):.3f}")
    log(f"[stream] {name}: device ms a replay: {'; '.join(parts)} | {card}")


def stream_phase(dev, engine, f32: bool = True) -> dict:
    """Phase 13: WS prefix caching (``runtime/stream.py``); ``f32=False``
    leaves (a) out. Returns the kernels' launches over its session
    runs."""
    from qwen3_asr_tpu_torch.audio import vad
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    card = card_line()
    total = {}

    def add(got):
        for k, n in got.items():
            total[k] = total.get(k, 0) + n

    if f32:
        add(stream_f32_phase(dev, card))
    pcm = np.round(real_audio()[:int(STREAM_SECONDS * 16000)]
                   * 32768.0).astype("<i2").tobytes()
    with environ(**STREAM_ENV), ws_cap(STREAM_CAP_S):
        # (b) preset:1.7b bf16, phase 5's engine: prefix, then solo
        launches, walls, sess, work = stream_session_ws(
            engine, "(b) preset:1.7b bf16 prefix", pcm, card)
        session_launch_check("(b)", launches, (
            "flash_attention", "decode_attention", "qk_rope_kv"))
        add(launches)
        stream_graph_ms(engine, work, "(b) preset:1.7b bf16", card)
        handover_ms(work, card)
        del sess, work
        with environ(ASR_WS_STREAM_MODE="solo"):
            # the resume keys of every bucket a growing window meets
            t0 = time.perf_counter()
            for sec in (1, 2, 4, 6, 10, 15, 20, 30):
                bf, bs = engine.bucket_frames(int(sec * 16000))
                engine._run_bucket([np.zeros(int(sec * 16000), np.float32)],
                                   bf, bs, "en", resume_tokens=[])
            log(f"[stream] (b) solo: the resume keys up to 30 s warm in "
                f"{time.perf_counter() - t0:.1f} s")
            manager = ModelManager(engine)
            manager.warmed = True
            with ws_serving(manager) as url:
                counter = PathLaunches(engine)
                ws_stream(url, pcm, "?use_server_vad=false")
                solo_launches, _ = counter.read()
            solo_walls = [w for kind, w, _ in manager.ws_calls
                          if kind == "partial"]
        log(f"[stream] (b) the same {STREAM_SECONDS:.0f} s in mode "
            f"solo (resume, the whole window re-encoded every tick): "
            f"partial wall {percentiles(solo_walls)}; prefix over the same "
            f"ticks: {percentiles(walls[:len(solo_walls)])}; launches "
            f"{solo_launches} | {card}")
        del manager
        torch.cuda.empty_cache()
        # (c) the JAX package's default serving row: an fp8 session cache
        saved = {k: os.environ.get(k) for k in DEFAULT_ENV}
        try:
            qeng, _ = quantized_engine(dev, DEFAULT_ENV, card,
                                       "(c) int8 + int4 KV + W8A8")
            launches, walls_c, sess, work = stream_session_ws(
                qeng, "(c) int8 + int4 KV + W8A8 prefix", pcm, card)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if sess.cache_dtype != torch.float8_e4m3fn:
            raise AssertionError(f"(c): session cache {sess.cache_dtype}")
        session_launch_check("(c)", launches, (
            "flash_attention", "decode_attention_batch", "qgemv", "qgemm",
            "qk_rope_kv"))
        add(launches)
        stream_graph_ms(qeng, work, "(c) int8 + int4 KV", card)
        handover_ms(work, card)
        del qeng, sess, work
        torch.cuda.empty_cache()
    log(f"[stream] phase 13 launches {total}; bind failures "
        f"{ws_mod.prefix_bind_failures}, VAD failures {vad.failures}")
    if ws_mod.prefix_bind_failures or vad.failures:
        raise AssertionError("phase 13: a bind or VAD failure was counted")
    return total


# -- phase 14: the grouped WS mode ------------------------------------------------

GROUP_SECONDS = 20.0      # (b): each session's audio, the real clips tiled
GROUP_SESSIONS = 4        # (b): WS sessions at once
# 30 s cap, the default 8 slots; no batched tick keys to warm
GROUP_ENV = {"ASR_WS_STREAM_MODE": "grouped", "WS_WINDOW_MAX_S": "30",
             "ASR_WS_TICK_MAX_BATCH": "1", "ASR_WARMUP_BUCKETS": "30",
             "ASR_WARMUP_BATCH_SHAPES": "",
             "ASR_WS_GROUP_SLOTS": str(GROUP_SLOTS)}


class DispatchTimer:
    """Each group dispatch's device time (CUDA events around
    ``StreamGroup._dispatch``: the rows' inputs, the front, the chunks and
    the one host read that ends it), by the rung it ran from."""

    def __init__(self):
        from qwen3_asr_tpu_torch.runtime.stream_group import StreamGroup
        self.cls, self.orig, self.rows = StreamGroup, \
            StreamGroup._dispatch, []
        timer = self

        def timed(group, seg_start, reqs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = timer.orig(group, seg_start, reqs)
            end.record()
            end.synchronize()
            timer.rows.append((seg_start, len(reqs),
                               group.last_run["live"],
                               group.last_run["chunks"],
                               start.elapsed_time(end)))
            return out

        StreamGroup._dispatch = timed

    def close(self) -> None:
        self.cls._dispatch = self.orig

    def report(self, name: str, card: str) -> dict:
        by = {}
        for seg, ticking, live, chunks, ms in self.rows:
            by.setdefault(seg, []).append((ticking, live, chunks, ms))
        out = {}
        for seg, rows in sorted(by.items()):
            ms = [r[3] for r in rows]
            out[seg] = float(np.median(ms))
            log(f"[group] {name}: dispatch from {seg}: {len(rows)}, device "
                f"ms median {np.median(ms):.2f} (min {min(ms):.2f}, max "
                f"{max(ms):.2f}); ticking rows "
                f"{np.mean([r[0] for r in rows]):.2f}, live rows "
                f"{np.mean([r[1] for r in rows]):.2f}, chunks of 8 steps "
                f"{np.mean([r[2] for r in rows]):.1f} | {card}")
        return out


def group_schedule(engine, cap_s: float, plan: list, slots: int,
                   eager: bool = False):
    """Direct ``StreamGroup.tick`` calls on a fixed schedule. ``plan``:
    [(name, language, audio, join cadence, leave cadence or None)]; each
    member's window grows by 450 ms a cadence and is trimmed at the cap
    in encoder-chunk steps; a member leaves (its slot free for the next)
    before its leave cadence. Returns (the group, [{name: ids}] a cadence,
    {name: [windows]}, {name: row}, the members left, by name)."""
    from qwen3_asr_tpu_torch.runtime.stream_group import StreamGroup
    group = StreamGroup(engine, cap_s, slots)
    group.eager = eager
    chunk = engine.model.cfg.encoder.n_window * 2 * 160
    cap, tick = int(cap_s * 16000), int(0.45 * 16000)
    last = max(j + -(-len(a) // tick) if lv is None else lv
               for _, _, a, j, lv in plan)
    members, wins, rows, out = {}, {}, {}, []
    for cadence in range(last):
        for name, lang, audio, join, leave in plan:
            if leave == cadence and name in members:
                members.pop(name).release()
            if join == cadence:
                members[name] = group.attach_or_raise(lang)
                rows[name] = members[name].row
                wins[name] = []
        reqs = []
        for name, lang, audio, join, leave in plan:
            k = cadence - join
            if name not in members or k * tick >= len(audio):
                continue
            w = audio[:(k + 1) * tick]
            w = w[max(0, -(-(len(w) - cap) // chunk) * chunk):] \
                if len(w) > cap else w
            wins[name].append(w)
            reqs.append((name, w))
        res = group.tick([(members[n], w) for n, w in reqs]) if reqs else []
        out.append({n: ids for (n, _), (_, ids) in zip(reqs, res)})
    return group, out, wins, rows, members


def release_all(members) -> None:
    for m in members.values():
        m.release()


def group_f32_phase(dev, card: str) -> dict:
    """(a) trained_ckpt f32, 4 slots, cap 8.5 s, direct group ticks: a
    quiet then loud clip from the first cadence, a Chinese clip joining
    two cadences late, one leaving early and a fourth taking its slot;
    every tick's ids equal a solo session's on the card (and, for the
    first member, the fused resume path's) and the same schedule's on the
    CPU; graph = eager. Returns the group's launches."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    ckpt = os.path.join(DATA, "trained_ckpt")
    gpu = load_engine(ckpt, device=dev, dtype=torch.float32)
    cpu = load_engine(ckpt, device="cpu")

    def clip(name, scale=1.0):
        with open(os.path.join(DATA, "real", name), "rb") as f:
            return (scale * decode_audio(f.read())[0]).astype(np.float32)

    plan = [("a", "en", np.concatenate([clip("english_01.wav", 0.3),
                                        clip("english_02.wav", 3.0)[:48000]]
                                       ).astype(np.float32), 0, None),
            ("b", "zh", clip("chinese_01.wav", 0.5), 2, None),
            ("c", "en", clip("english_02.wav"), 0, 8),
            ("d", "ja", clip("japanese_01.wav"), 11, None)]
    from qwen3_asr_tpu_torch.runtime.stream import warm_stream_keys
    warm_stream_keys(gpu, STREAM_CAP_F32, 4)
    counter = PathLaunches(gpu)
    group, ids, wins, rows, left = group_schedule(gpu, STREAM_CAP_F32, plan,
                                                  4)
    launches, eager = counter.read()
    stats = {n: dict(m.stats) for n, m in left.items()}
    release_all(left)
    ticks = sum(len(c) for c in ids)
    per = {n: [c[n] for c in ids if n in c] for n in wins}
    # a solo session on the card fed each member's windows
    solo_eq = 0
    for name, lang, *_ in plan:
        sess = gpu.stream_session(STREAM_CAP_F32, lang)
        solo_eq += sum(sess.update(w)[1] == got
                       for w, got in zip(wins[name], per[name]))
        sess.release()
    frames, bucket_s = gpu.bucket_frames(int(STREAM_CAP_F32 * 16000))
    fused_eq, prev = 0, []
    for w, got in zip(wins["a"], per["a"]):
        prev = gpu._run_bucket([w], frames, bucket_s, "en",
                               resume_tokens=list(prev))[1][0]
        fused_eq += prev == got
    _, cpu_ids, _, _, cpu_left = group_schedule(cpu, STREAM_CAP_F32, plan, 4)
    release_all(cpu_left)
    _, eager_ids, _, _, eager_left = group_schedule(gpu, STREAM_CAP_F32, plan,
                                                    4, eager=True)
    release_all(eager_left)
    cpu_eq = sum(a == b for a, b in zip(ids, cpu_ids))
    log(f"[group] (a) trained_ckpt f32, cap {STREAM_CAP_F32} s, 4 slots: "
        f"{len(ids)} cadences, {ticks} ticks in {group.dispatches} "
        f"dispatches, rows {rows} (d reuses c's), stats {stats}; ids "
        f"equal to a solo session on the card on {solo_eq}/{ticks} ticks, "
        f"to the fused resume path on {fused_eq}/{len(per['a'])} of a's, "
        f"to the CPU group on {cpu_eq}/{len(ids)} cadences; eager run "
        f"equal {eager_ids == ids}; launches {launches} ({eager} eager) | "
        f"{card}")
    if (solo_eq != ticks or fused_eq != len(per["a"]) or cpu_eq != len(ids)
            or eager_ids != ids or rows["d"] != rows["c"]
            or not stats["a"]["redo"]):
        raise AssertionError("(a): the group differs from its references")
    session_launch_check("(a)", launches, ("flash_attention",
                                           "decode_attention", "qk_rope_kv"))
    if any(eager.values()):
        raise AssertionError(f"(a): eager launches {eager}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def group_fixed_schedule(engine, name: str, card: str) -> tuple:
    """A fixed schedule of direct ticks at the 30 s cap, 8 slots: two
    members from the first cadence, a third joining at the second (a
    rebuild from position 0 for every row), through the graphs (graph =
    eager is tests/test_torch_cuda.py's
    ``test_stream_group_graphs_equal_eager``, bf16 and int8 weights).
    Returns (launches of the run, the workspace)."""
    audio = real_audio()
    plan = [("a", "en", audio[:int(0.9 * 16000)], 0, None),
            ("b", "en", audio[int(40 * 16000):int(40.9 * 16000)], 0, None),
            ("c", "zh", audio[int(80 * 16000):int(80.45 * 16000)], 1, None)]
    counter = PathLaunches(engine)
    t0 = time.perf_counter()
    group, ids, _, _, left = group_schedule(engine, STREAM_CAP_S, plan,
                                               GROUP_SLOTS)
    graph_s = time.perf_counter() - t0
    launches, eager = counter.read()
    release_all(left)
    log(f"[group] {name}: fixed schedule ({sum(len(c) for c in ids)} ticks "
        f"in {group.dispatches} dispatches) through the graphs "
        f"{graph_s:.2f} s; launches {launches} ({eager} eager) | {card}")
    if any(eager.values()):
        raise AssertionError(f"{name}: eager launches {eager}")
    return launches, group.work


def group_records(work, name: str, layers: int) -> None:
    """Every front records flash and kernel B twice a layer (the segment
    prefill and the verify window), the chunk kernel B's per-row route and
    the decode kernel once a layer and step."""
    from qwen3_asr_tpu_torch.runtime.generate import DECODE_CHUNK
    fronts = {s: (g.recorded.get("flash_attention"),
                  g.recorded.get("qk_rope_kv"))
              for s, g in sorted(work.fronts.items())}
    chunk = {k: n for k, n in work.chunk.recorded.items() if n}
    log(f"[group] {name}: recorded (flash, kernel B) a front {fronts}; a "
        f"chunk {chunk}")
    want_chunk = DECODE_CHUNK * layers
    if (any(v != (2 * layers, 2 * layers) for v in fronts.values())
            or chunk.get("qk_rope_kv_per_row") != want_chunk
            or chunk.get("decode_attention_batch") != want_chunk):
        raise AssertionError(f"{name}: records {fronts} {chunk}")


def group_ws(engine, card: str, pcms) -> tuple:
    """(b) the WS sessions through the server at ``GROUP_ENV``: the
    manager's warmup (timed), then every session streaming at once,
    unpaced. Returns (launches, partial walls, the batcher)."""
    from qwen3_asr_tpu_torch.runtime.batcher import GroupTickBatcher
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    manager = ModelManager(engine)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    manager.start()
    manager.stop()
    manager.warmed = True
    keys = [k for k in engine.stream_warmup.get("keys", [])
            if k[0] in ("gstate", "gtick")]
    capture = sum(g.capture_s for k in keys if k[0] == "gstate"
                  for g in engine._stream_fns[k].graphs())
    log(f"[group] (b) warmup {time.perf_counter() - t0:.1f} s: the group "
        f"keys {keys} ({capture:.2f} s of capture); "
        f"{(torch.cuda.memory_allocated() - held) / 2**30:.3f} GiB more "
        f"allocated | {card}")
    # unpaced sessions land their ticks together: dispatch when all have
    # landed, waiting at most 200 ms for a straggler
    manager.group_tick_batcher = GroupTickBatcher(
        manager, window_ms=200, max_batch=len(pcms))
    groups = []
    orig = engine.stream_group_member

    def keep(*a, **k):
        member = orig(*a, **k)
        groups.append(member.group)
        return member

    engine.stream_group_member = keep
    failures = ws_mod.prefix_bind_failures
    built = len(engine.stream_graphs())
    timer = DispatchTimer()
    try:
        with ws_serving(manager) as url:
            counter = PathLaunches(engine)
            with concurrent.futures.ThreadPoolExecutor(len(pcms)) as pool:
                msgs = list(pool.map(
                    lambda p: ws_stream(url, p, "?use_server_vad=false"),
                    pcms))
            launches, eager = counter.read()
    finally:
        timer.close()
        del engine.stream_group_member
    walls = [w for kind, w, _ in manager.ws_calls if kind == "partial"]
    errors = [m for ms in msgs for m in ms if "[error" in m.get("text", "")]
    batcher = manager.group_tick_batcher
    group = groups[0] if groups else None
    log(f"[group] (b) {len(pcms)} sessions over WS, {GROUP_SECONDS} s each "
        f"unpaced: {batcher.ticks} ticks in {batcher.dispatches} "
        f"dispatches of the group tick batcher, group sizes "
        f"{batcher.groups}; the group's dispatches (redos included) "
        f"{group.dispatches if group else None}; partial wall "
        f"{percentiles(walls)}; bind failures "
        f"{ws_mod.prefix_bind_failures - failures}; group cache "
        f"{group.cache_dtype if group else None}, "
        f"{group.work.state_bytes() / 1e6 if group else 0:.1f} MB of state "
        f"(workspace {group.work.nbytes() / 1e6 if group else 0:.1f} MB), "
        f"{group.work.handovers if group else 0} hand-overs; launches "
        f"{launches} ({eager} eager: the warm-up runs of the keys the "
        f"finals built) | {card}")
    timer.report("(b) preset:1.7b bf16", card)
    if (len(groups) != len(pcms) or any(g is not group for g in groups)
            or errors or ws_mod.prefix_bind_failures != failures
            or not any(size >= 2 for size in batcher.groups)
            or len(engine.stream_graphs()) != built):
        raise AssertionError(
            f"(b): {len(set(map(id, groups)))} groups for "
            f"{len(groups)} binds, errors {errors[:2]}, bind failures "
            f"{ws_mod.prefix_bind_failures - failures}, group sizes "
            f"{batcher.groups}, "
            f"{len(engine.stream_graphs()) - built} graphs built")
    return launches, walls, batcher


def group_phase(dev, engine, f32: bool = True) -> dict:
    """Phase 14: the grouped WS mode (``runtime/stream_group.py``);
    ``f32=False`` leaves (a) out. Returns the kernels' launches over its
    main-path runs."""
    from qwen3_asr_tpu_torch.audio import vad
    from qwen3_asr_tpu_torch.serving import ws as ws_mod
    card = card_line()
    total = {}

    def add(got):
        for k, n in got.items():
            total[k] = total.get(k, 0) + n

    if f32:
        add(group_f32_phase(dev, card))
    audio = real_audio()
    step = int(GROUP_SECONDS * 16000)
    pcms = [np.round(np.roll(audio, -i * step)[:step] * 32768.0)
            .astype("<i2").tobytes() for i in range(GROUP_SESSIONS)]
    layers = engine.model.cfg.decoder.num_hidden_layers
    with environ(**GROUP_ENV), ws_cap(STREAM_CAP_S):
        # (b) preset:1.7b bf16, phase 5's engine
        launches, walls, _ = group_ws(engine, card, pcms)
        session_launch_check("(b)", launches, (
            "flash_attention", "decode_attention_batch", "qk_rope_kv"))
        add(launches)
        fixed, work = group_fixed_schedule(engine, "(b) preset:1.7b bf16",
                                           card)
        add(fixed)
        group_records(work, "(b)", layers)
        log(f"[group] (b) device ms a replay: front@64 "
            f"{replay_ms(work.fronts[64]):.3f}, front@389 "
            f"{replay_ms(work.fronts[389]):.3f}, a chunk of 8 steps at "
            f"{work.rows} rows {replay_ms(work.chunk):.3f} | {card}")
        del work
        torch.cuda.empty_cache()
        # (c) the JAX package's default serving row: an fp8 group cache
        saved = {k: os.environ.get(k) for k in DEFAULT_ENV}
        try:
            qeng, _ = quantized_engine(dev, DEFAULT_ENV, card,
                                       "(c) int8 + int4 KV + W8A8")
            from qwen3_asr_tpu_torch.runtime.stream import warm_stream_keys
            warm_stream_keys(qeng, STREAM_CAP_S, GROUP_SLOTS)
            fixed, work = group_fixed_schedule(
                qeng, "(c) int8 + int4 KV + W8A8", card)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if work.cache_dtype != torch.float8_e4m3fn:
            raise AssertionError(f"(c): group cache {work.cache_dtype}")
        session_launch_check("(c)", fixed, (
            "flash_attention", "decode_attention_batch", "qgemv", "qgemm",
            "qk_rope_kv"))
        group_records(work, "(c)", layers)
        log(f"[group] (c) device ms a replay: front@64 "
            f"{replay_ms(work.fronts[64]):.3f}, front@389 "
            f"{replay_ms(work.fronts[389]):.3f}, a chunk of 8 steps at "
            f"{work.rows} rows {replay_ms(work.chunk):.3f} | {card}")
        add(fixed)
        del qeng, work
        torch.cuda.empty_cache()
    log(f"[group] phase 14 launches {total}; bind failures "
        f"{ws_mod.prefix_bind_failures}, VAD failures {vad.failures}")
    if ws_mod.prefix_bind_failures or vad.failures:
        raise AssertionError("phase 14: a bind or VAD failure was counted")
    return total


# -- phase 15: the lifecycle, the second engine and token-level speculation -------

SPEC_GAMMA = 4
# what an idle unload may leave allocated on the card (tests/test_torch_cuda.py
# UNLOAD_RESIDUE_BYTES): what a process's first load creates and torch
# keeps (cuBLAS's workspace, cuFFT's plans, the decode kernels' tickets)
UNLOAD_RESIDUE_MIB = 64
SPEC_ENV = {"USE_SPECULATIVE": "true", "IDLE_TIMEOUT": "2",
            "ASR_WATCHDOG_INTERVAL": "1", "ASR_WARMUP_BUCKETS": "10,15",
            "ASR_BATCH_WINDOW_MS": "500"}


def spec_shapes():
    """(prompt length, max_new, spec cache length) of preset:1.7b's 30 s
    bucket: the verify window's largest cache."""
    from qwen3_asr_tpu_torch.runtime.speculative import spec_cache_length
    plen, max_new, _ = bucket_shape(30)
    return plen, max_new, spec_cache_length(plen, max_new, SPEC_GAMMA)


def bucket_shape(sec: int):
    """(prompt length, max_new, cache length) of a preset:1.7b bucket."""
    from qwen3_asr_tpu_torch.models.asr import PromptTemplate
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.encoder import encoder_output_length
    from qwen3_asr_tpu_torch.runtime.engine import (PREFIX_BUDGET,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.generate import cache_length
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    suffix = len(preset_tokenizer(cfg.decoder.vocab_size).encode(
        PromptTemplate().suffix_text()))
    chunk = cfg.encoder.n_window * 2
    frames = -(-sec * 100 // chunk) * chunk
    plen = PREFIX_BUDGET + int(encoder_output_length(frames, chunk)) + suffix
    max_new = max_new_tokens_for(frames / 100)
    return plen, max_new, cache_length(plen, max_new)


# text lengths of the verify window's rows (each row at its own frontier)
SPEC_TEXT_LENS = [128, 1, 37, 90, 200, 255, 12, 64]


def spec_flash_cases(sh, dtype, dev):
    """#1 at the verify window: q [B, nq, γ, d], causal from a per-row
    q_offset = plen + text_len - 1 (rows at their own frontiers, some left
    padded further) over the 30 s spec cache (S = 768); B = 1 and 8.
    make_cases' tuple."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    nq, nkv, d = sh["nq"], sh["nkv"], sh["d"]
    esize = torch.tensor([], dtype=dtype).element_size()
    plen, _, s = spec_shapes()
    t, vf0 = SPEC_GAMMA, sh["valid_from"]
    for batch in (1, 8):
        gen = torch.Generator(device=dev).manual_seed(batch + 17)
        q = torch.randn((batch, nq, t, d), generator=gen,
                        device=dev).to(dtype)
        k, v = (torch.randn((batch, nkv, s, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        vfs = [vf0, vf0 + 28, 0, vf0, 3, vf0, 40, vf0][:batch]
        offs = [plen + n - 1 for n in SPEC_TEXT_LENS[:batch]]
        vf = torch.tensor(vfs, dtype=torch.int32, device=dev)
        vt = torch.full((batch,), s, dtype=torch.int32, device=dev)
        qo = torch.tensor(offs, dtype=torch.int32, device=dev)
        mask = AttnSpec(causal=True, q_offset=qo, valid_from=vf
                        ).dense_mask(batch, t, s, dev)
        keys = sum(o + t - x for o, x in zip(offs, vfs))
        yield (f"spec_verify_t{t}_b{batch}", "flash_attention",
               lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo:
                   flash_attention(q, k, v, causal=True, q_offset=qo,
                                   kv_valid_from=vf, kv_valid_to=vt,
                                   return_residuals=True),
               lambda q=q, k=k, v=v, vf=vf, vt=vt, qo=qo:
                   flash_attention_plain(q, k, v, vf, vt, qo, causal=True,
                                         window_block=0,
                                         sm_scale=d ** -0.5),
               lambda q=q, k=k, v=v, mask=mask:
                   F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask[:, None], enable_gqa=True),
               (2 * batch * nq * t * d + 2 * nkv * keys * d) * esize
               + 2 * 4 * batch * nq * t + 3 * 4 * batch,
               4 * d * nq * int(mask.sum()), 0)


def spec_kernel_rows(sh, dev, card, rows) -> None:
    """Parity (phase 2) and timing (phase 3) at token speculation's
    shapes: flash at the verify window (f32 and bf16; bf16 timed) and
    kernel B writing the window's γ keys at a position a row, into a bf16
    cache of the 30 s spec length."""
    plen, max_new, s = spec_shapes()
    log(f"[shapes] spec: 30 s bucket prompt {plen}, max_new {max_new}, "
        f"spec cache {s}, γ = {SPEC_GAMMA}")
    for dtype in (torch.float32, torch.bfloat16):
        tol, dt = TOL[dtype], str(dtype).replace("torch.", "")
        for label, kernel, run, plain, sdpa, nbytes, flops, layers in \
                spec_flash_cases(sh, dtype, dev):
            outs, refs = run(), plain()
            torch.cuda.synchronize()
            err = float((outs[0].float() - refs[0].float()).abs().max())
            for a, b in zip(outs[1:], refs[1:]):
                torch.testing.assert_close(a, b, atol=tol, rtol=tol)
            same_bits(kernel, label, outs, run())
            log(f"[parity] {label} {dt}: max_abs_err={err:.3e} (bound "
                f"{tol:g}); m and l within it; a repeat call's bits equal")
            if not err <= tol:
                raise AssertionError(f"{kernel} {label} {dt}: error {err} "
                                     f"above {tol}")
            if dtype == torch.bfloat16:
                if label.endswith("_b8"):
                    one_kernel_per_call(kernel, label, run)
                rows[kernel].append(time_row(
                    label, dt, err, run, plain, sdpa, nbytes, flops, layers,
                    card))
    shapes = [(b, SPEC_GAMMA, s, [plen + n - 1 for n in SPEC_TEXT_LENS[:b]])
              for b in (1, 8)]
    qk_row_rows(qk_row_cases(sh, dev, shapes, {"bf16": QK_CACHES["bf16"]}),
                card, rows, headline=f"qk_rows_b8_t{SPEC_GAMMA}_bf16",
                tag=" (the verify window)")


def memory_mib(dev) -> tuple:
    """(allocated, reserved) MiB of the caching allocator on ``dev``."""
    return (torch.cuda.memory_allocated(dev) / 2 ** 20,
            torch.cuda.memory_reserved(dev) / 2 ** 20)


def get_health(base: str) -> dict:
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        return json.loads(r.read())


def spec_launch_check(name: str, launches: dict, want) -> None:
    missing = [k for k in want if not launches.get(k)]
    if missing:
        raise AssertionError(f"{name}: launched no {missing}: {launches}")


def spec_f32_phase(dev, wavs, wants, greedy_ids, card) -> dict:
    """(a) trained_ckpt f32 with trained_draft f32 through a lazy
    ``ModelManager()`` behind the server: the 12 clips one at a time, then
    all at once, token-identical to phase 4's greedy ids and the CPU's
    spec ids; the idle unload seen in /health and the memory it returns;
    a reload by a request; then ``DUAL_MODEL`` without speculation, one WS
    session whose partials the fast engine decodes. Returns the launches
    of the card's runs."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
    from qwen3_asr_tpu_torch.serving.server import device_bytes
    ckpt = os.path.join(DATA, "trained_ckpt")
    draft = os.path.join(DATA, "trained_draft")
    clips = [decode_audio(w) for w in wavs]
    cpu = load_engine(ckpt, device="cpu")
    cpu.attach_draft(load_engine(draft, device="cpu").model)
    cpu_ids = [cpu.transcribe(a, sr)[0].token_ids for a, sr in clips]
    del cpu
    if cpu_ids != greedy_ids:
        raise AssertionError("(a): the CPU's spec ids are not phase 4's "
                             "greedy ids")
    total = {}

    def add(got):
        for k, n in got.items():
            total[k] = total.get(k, 0) + n

    mem = {}
    with environ(MODEL_ID=ckpt, FAST_MODEL_ID=draft, **SPEC_ENV):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem["before the load"] = memory_mib(dev)
        manager = ModelManager(device=dev, dtype=torch.float32)
        with serving(manager) as url:
            base = url.rsplit("/v1/", 1)[0]
            health = get_health(base)
            if health["model_loaded"] or health["model_id"] is not None:
                raise AssertionError(f"(a): /health before the load {health}")
            counter = PathLaunches()
            t0 = time.perf_counter()
            manager.ensure_loaded()
            load_s = time.perf_counter() - t0
            eng, fast = manager.engine, manager.fast_engine
            if eng.draft_model is not fast.model or eng.dtype != torch.float32:
                raise AssertionError("(a): the draft is not attached")
            health = get_health(base)
            spec_keys = sum("spec" in k for k in eng.executables)
            log(f"[spec] (a) lazy load of trained_ckpt + trained_draft f32 "
                f"with the warmup (buckets 10, 15): {load_s:.2f} s; main "
                f"engine {len(eng.executables)} keys ({spec_keys} spec), "
                f"fast {len(fast.executables)}; /health model_loaded "
                f"{health['model_loaded']}, executable_count "
                f"{health['executable_count']}, device_arrays_mb "
                f"{health['device_arrays_mb']} | {card}")
            if not (health["model_loaded"] and health["model_id"] == ckpt
                    and spec_keys):
                raise AssertionError(f"(a): /health once loaded {health}")
            solo, walls, tokens, rounds = [], [], 0, 0
            for a, sr in clips:
                # one at a time: the manager's job, as a solo request runs
                t0 = time.perf_counter()
                res = manager.queue.submit(
                    lambda a=a, sr=sr: manager.transcribe_sync(a, sr, None)
                ).result(600)[0]
                walls.append(time.perf_counter() - t0)
                run = eng.last_run
                if not run.get("spec") or run["batch"] != 1:
                    raise AssertionError(f"(a): a solo request ran {run}")
                tokens += run["generated"] - 1
                rounds += run["rounds"]
                solo.append(res.token_ids)
            bodies, _ = post_all(url, wavs)
            d0 = manager.batcher.dispatches
            futures = [manager.batcher.transcribe(a, sr, None)
                       for a, sr in clips]
            batched = [f.result(timeout=600)[0].token_ids for f in futures]
            dispatches = manager.batcher.dispatches - d0
            counter.engines = (eng, fast)
            launches, eager = counter.read()
            counter.engines = ()
            add(launches)
            mem["loaded"] = memory_mib(dev)
            held = device_bytes(manager) / 2 ** 20
            log(f"[spec] (a) 12 clips one at a time: {sum(walls):.3f} s, "
                f"{rounds} verifier rounds for {tokens} tokens past the "
                f"first: {tokens / rounds:.3f} tokens a round (γ = 4); "
                f"ids equal to phase 4's greedy ids: {solo == greedy_ids}, "
                f"to the CPU's spec ids: {solo == cpu_ids}; all 12 at once "
                f"in {dispatches} dispatches: ids equal {batched == greedy_ids}"
                f", server bodies equal {bodies == wants}; launches "
                f"{launches}, eager {eager} (the load's warm-up runs); "
                f"the engines hold {held:.1f} MiB | {card}")
            if solo != greedy_ids or batched != greedy_ids or bodies != wants:
                raise AssertionError("(a): speculative ids or bodies differ "
                                     "from greedy")
            if dispatches >= len(clips):
                raise AssertionError(f"(a): {dispatches} dispatches for "
                                     f"{len(clips)} clips")
            spec_launch_check("(a)", launches, (
                "flash_attention", "decode_attention", "qk_rope_kv"))
            del eng, fast, res, run, futures, counter
            t_idle = time.perf_counter()
            while True:
                health = get_health(base)
                if not health["model_loaded"]:
                    break
                if time.perf_counter() - t_idle > 60:
                    raise AssertionError("(a): no idle unload in 60 s")
                time.sleep(0.25)
            unload_s = time.perf_counter() - t_idle
            # /health turns as the engines are dropped; the unload job goes
            # on (the collection of their reference cycles, empty_cache):
            # a job queued now runs after it has ended
            manager.queue.submit(lambda: None).result(60)
            gc.collect()
            torch.cuda.synchronize()
            mem["after the unload"] = memory_mib(dev)
            if health["model_id"] is not None or manager.engine is not None:
                raise AssertionError(f"(a): /health after the unload {health}")
            counter = PathLaunches()
            t0 = time.perf_counter()
            body = post(url, wavs[0])
            reload_s = time.perf_counter() - t0
            res = manager.batcher.transcribe(*clips[0], None).result(600)[0]
            counter.engines = (manager.engine, manager.fast_engine)
            launches, _ = counter.read()
            counter.engines = ()
            add(launches)
            mem["after the reload"] = memory_mib(dev)
            if body != wants[0] or res.token_ids != greedy_ids[0]:
                raise AssertionError("(a): the reloaded engine's answer "
                                     "differs")
        residue = mem["after the unload"][0] - mem["before the load"][0]
        log(f"[spec] (a) /health showed the unload {unload_s:.2f} s after "
            f"the last request (IDLE_TIMEOUT=2, watchdog 1 s): "
            f"model_loaded false, model_id null; the reload by a request "
            f"{reload_s:.2f} s, its body and ids equal; memory MiB "
            f"(allocated, reserved): "
            + "; ".join(f"{k} ({a:.1f}, {r:.1f})" for k, (a, r) in
                        mem.items())
            + f"; residue after the unload {residue:.1f} MiB allocated "
            f"(bound {UNLOAD_RESIDUE_MIB}) | {card}")
        if residue > UNLOAD_RESIDUE_MIB:
            held_by(ckpt, draft)
            raise AssertionError(f"(a): {residue:.1f} MiB left after the "
                                 f"unload")
    del manager
    gc.collect()
    torch.cuda.empty_cache()
    # DUAL_MODEL without speculation: partials on the fast engine
    name = "english_02"
    with environ(MODEL_ID=ckpt, FAST_MODEL_ID=draft, DUAL_MODEL="true",
                 USE_SPECULATIVE="false", IDLE_TIMEOUT="0",
                 ASR_WARMUP_BUCKETS="10,15"):
        manager = ModelManager(device=dev, dtype=torch.float32)
        manager.queue.start()
        manager.ensure_loaded()
        main, fast = manager.engine, manager.fast_engine
        with ws_serving(manager) as ws_url:
            counter = PathLaunches(main, fast)
            msgs = ws_stream(ws_url, real_pcm(name + ".wav"))
            launches, _ = counter.read()
        add(launches)
    fronts = {e: sum(x.front.replays for x in eng.executables.values())
              for e, eng in (("main", main), ("fast", fast))}
    fast_resume = sum(x.front.replays for k, x in fast.executables.items()
                      if "resume" in k)
    with open(os.path.join(DATA, "real", name + ".txt"),
              encoding="utf-8") as f:
        want = f.read().strip()
    finals = [m["text"] for m in msgs if m.get("is_final")]
    partials = [m for m in msgs if m.get("is_partial")]
    log(f"[spec] (a) DUAL_MODEL=true: one WS session, {len(partials)} "
        f"partials from {fronts['fast']} fast-engine runs ({fast_resume} "
        f"with resume), finals from {fronts['main']} main-engine runs: "
        f"{finals[-1] if finals else None!r}; no draft attached: "
        f"{main.draft_model is None}; launches {launches} | {card}")
    if (not partials or fast_resume < 1 or fronts["main"] < 1
            or main.draft_model is not None or finals[-1:] != [want]):
        raise AssertionError(f"(a) DUAL_MODEL: fronts {fronts}, finals "
                             f"{finals} vs {want!r}")
    del manager, main, fast
    gc.collect()
    torch.cuda.empty_cache()
    return total


def held_by(*model_ids) -> None:
    """Log what still refers to each live engine of ``model_ids`` (two
    levels of referrers): the diagnosis of an unload that freed less than
    it should."""
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    gc.collect()
    live = [o for o in gc.get_objects() if isinstance(o, TranscriptionEngine)
            and o.model_id in model_ids]
    for eng in live:
        for ref in gc.get_referrers(eng):
            if ref is live:
                continue
            outer = [type(r).__name__ for r in gc.get_referrers(ref)
                     if r is not live][:6]
            log(f"[spec] a live {eng.model_id} engine is referred to by a "
                f"{type(ref).__name__} "
                f"({list(ref)[:6] if isinstance(ref, dict) else ''}), "
                f"itself referred to by {outer}")


def draft_model_0_6b(dev):
    """preset:0.6b in bf16 with random weights from seed 1: a draft for
    preset:1.7b (its tokenizer and chunking)."""
    from qwen3_asr_tpu_torch.models.asr import AsrModel
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
    from qwen3_asr_tpu_torch.models.encoder import init_encoder_params
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("0.6b")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = {
        "encoder": init_encoder_params(cfg.encoder, gen, dev, torch.bfloat16),
        "decoder": init_decoder_params(cfg.decoder, gen, dev, torch.bfloat16)}
    return AsrModel(cfg, params, preset_tokenizer(cfg.decoder.vocab_size))


def spec_turns(name, spec, plain, inputs, card) -> dict:
    """The spec key and the plain key on the same inputs, in turns (spec,
    greedy, greedy, spec): walls with the copies in and out, the spec
    runs' tokens equal to each other, rounds and tokens a round, and the
    share of tokens equal to greedy's (bf16: not bit-stable)."""
    walls = {"spec": [], "greedy": []}
    out = {}
    for mode in ("spec", "greedy", "greedy", "spec"):
        exe = spec if mode == "spec" else plain
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = exe.run(*inputs)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        if mode in out and not torch.equal(res.tokens, out[mode].tokens):
            raise AssertionError(f"{name}: two {mode} runs differ")
        out[mode] = res
    s, g = out["spec"], out["greedy"]
    batch = s.tokens.shape[0]
    gained = int((s.lengths - 1).clamp(min=0).sum())
    equal = float((s.tokens == g.tokens).float().mean())
    info = {"spec_s": min(walls["spec"]), "greedy_s": min(walls["greedy"]),
            "rounds": s.steps, "tokens": int(s.lengths.sum()),
            "tokens_per_round": gained / (batch * s.steps) if s.steps else 0}
    log(f"[spec] {name}: spec {', '.join(f'{w:.3f}' for w in walls['spec'])}"
        f" s, greedy {', '.join(f'{w:.3f}' for w in walls['greedy'])} s "
        f"(spec / greedy {info['spec_s'] / info['greedy_s']:.2f}x); "
        f"{info['tokens']} tokens in {s.steps} rounds ({s.steps_run} "
        f"computed), {info['tokens_per_round']:.3f} tokens a row and round; "
        f"greedy {g.steps} steps; token positions equal to greedy's "
        f"{equal:.2%} | {card}")
    return info


def round_breakdown(exe, name, card) -> dict:
    """Device ms of a round (a chunk replay over its rounds) and of its
    parts as graphs of their own: the γ draft steps and the verify
    forward (the accept arithmetic is the rest)."""
    from qwen3_asr_tpu_torch.runtime.graphs import Graph
    loop, dev = exe.loop, exe.audio.device
    exe.front()
    round_ms = replay_ms(exe.chunk) / loop.rounds_per_chunk
    drafts = torch.zeros((loop.batch, loop.gamma), dtype=torch.int32,
                         device=dev)
    parts = {"draft": Graph(loop._draft, dev),
             "verify": Graph(lambda: loop._verify(drafts), dev)}
    ms = {k: replay_ms(g) for k, g in parts.items()}
    ms["round"] = round_ms
    log(f"[spec] {name}: a round {round_ms:.3f} ms of device time: "
        f"{loop.gamma} draft steps {ms['draft']:.3f} ms "
        f"({ms['draft'] / round_ms:.1%}), the verify forward at T = "
        f"{loop.gamma} {ms['verify']:.3f} ms ({ms['verify'] / round_ms:.1%})"
        f", the rest {round_ms - ms['draft'] - ms['verify']:.3f} ms | {card}")
    del parts
    return ms


def spec_bf16_phase(dev, engine, card) -> dict:
    """(b) phase 5's preset:1.7b bf16 engine as the verifier with a
    preset:0.6b draft of random bf16 weights, γ = 4: the 30 s upload at
    B=1 and phase 6's 8 uploads at B=8 through the server, from replays
    only; walls against greedy in turns, rounds, tokens a round, device
    ms a round and its parts, the keys' capture seconds and memory (graph
    = eager is tests/test_torch_cuda.py's
    ``test_spec_graph_replay_equals_eager``); 1.7b self-draft at B=1 (the
    acceptance
    ceiling); the share of a round that widening an fp8 cache's layers
    for the verify window takes. Returns the launches."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu_torch.runtime.graphs import Graph
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    draft = draft_model_0_6b(dev)
    engine.attach_draft(draft)
    audio = real_audio()
    long = audio[:int(29.5 * 16000)]
    seg = int(9.5 * 16000)
    clips8 = [audio[i * seg:(i + 1) * seg] for i in range(8)]
    (bf30, bs30), (bf10, bs10) = (engine.bucket_frames(len(long)),
                                  engine.bucket_frames(seg))
    from qwen3_asr_tpu_torch.runtime.engine import max_new_tokens_for
    k1 = (bf30, max_new_tokens_for(bs30), 1)
    k8 = (bf10, max_new_tokens_for(bs10), 8)
    alloc0 = torch.cuda.memory_allocated(dev)
    spec1, cap1 = engine.executable(*k1, gamma=SPEC_GAMMA)
    spec8, cap8 = engine.executable(*k8, gamma=SPEC_GAMMA)
    grown = (torch.cuda.memory_allocated(dev) - alloc0) / 2 ** 20
    log(f"[spec] (b) spec keys of preset:1.7b + a preset:0.6b draft (bf16, "
        f"γ = {SPEC_GAMMA}): 30 s B=1 built in {cap1:.2f} s "
        f"({spec1.nbytes() / 2 ** 20:.1f} MiB of buffers, state and both "
        f"caches), 10 s B=8 in {cap8:.2f} s ({spec8.nbytes() / 2 ** 20:.1f}"
        f" MiB); {grown:.1f} MiB more allocated; B=8 chunk recorded "
        f"{spec8.chunk.recorded} | {card}")
    manager = ModelManager(engine)
    manager.warmed = True        # phase 5 warmed it; the keys are built
    manager.batcher = MicroBatcher(manager, window_ms=1000, max_batch=8)
    bodies8 = [encode_wav(c, 16000) for c in clips8]
    with serving(manager) as url:
        counter = PathLaunches(engine)
        t0 = time.perf_counter()
        post(url, encode_wav(long, 16000))
        wall1 = time.perf_counter() - t0
        run1 = dict(engine.last_run)
        t0 = time.perf_counter()
        _, walls8 = post_all(url, bodies8)
        wall8 = time.perf_counter() - t0
        run8 = dict(engine.last_run)
        launches, eager = counter.read()
    log(f"[spec] (b) through the server: the 30 s upload {wall1:.3f} s "
        f"(B={run1['batch']}, {run1['rounds']} rounds, "
        f"{run1['tokens_per_round']:.3f} tokens a round), 8 uploads at once "
        f"{wall8:.3f} s (B={run8['batch']}, {run8['rounds']} rounds, "
        f"{run8['tokens_per_round']:.3f} tokens a row and round; request "
        f"walls {percentiles(walls8)}); launches {launches}, eager {eager} "
        f"| {card}")
    if not (run1.get("spec") and run8.get("spec") and run1["batch"] == 1
            and run8["batch"] == 8) or any(eager.values()):
        raise AssertionError(f"(b): {run1}, {run8}, eager {eager}")
    spec_launch_check("(b)", launches, (
        "flash_attention", "decode_attention", "decode_attention_batch",
        "qk_rope_kv", "qk_rope_kv_per_row"))
    plain1, _ = engine.executable(*k1)
    plain8, cap = engine.executable(*k8)
    in1 = engine.bucket_inputs([long], bf30, None)
    in8 = engine.bucket_inputs(clips8, bf10, None)
    spec_turns("(b) 30 s, B=1, 0.6b draft", spec1, plain1, in1, card)
    spec_turns("(b) 10 s, B=8, 0.6b draft", spec8, plain8, in8, card)
    round_breakdown(spec1, "(b) 30 s, B=1", card)
    round_breakdown(spec8, "(b) 10 s, B=8", card)
    # the acceptance ceiling: the verifier as its own draft
    engine.attach_draft(engine.model)
    self1, cap_self = engine.executable(*k1, gamma=SPEC_GAMMA)
    ceiling = spec_turns("(b) 30 s, B=1, self-draft", self1, plain1, in1,
                         card)
    if ceiling["tokens_per_round"] < SPEC_GAMMA - 0.5:
        raise AssertionError(f"(b): self-draft accepted "
                             f"{ceiling['tokens_per_round']:.2f} a round")
    round_breakdown(self1, "(b) 30 s, B=1, self-draft", card)
    # an fp8 cache: the verify window widens every layer first
    fp8 = TranscriptionEngine(engine.model, device=dev, dtype=torch.bfloat16,
                              cache_dtype=torch.float8_e4m3fn)
    fp8.attach_draft(draft)
    f8, cap_f8 = fp8.executable(*k8, gamma=SPEC_GAMMA)
    res = f8.run(*in8)
    parts = round_breakdown(f8, "(b) 10 s, B=8, fp8 cache", card)
    cache = f8.loop.cache_v

    def widen():
        for i in range(cache.k.shape[0]):
            cache.k[i].to(torch.bfloat16)
            cache.v[i].to(torch.bfloat16)
    widen_ms = replay_ms(Graph(widen, dev))
    log(f"[spec] (b) fp8 cache, B=8: {res.steps} rounds; widening the "
        f"verifier's {cache.k.shape[0]} layers (K and V) for the window "
        f"{widen_ms:.3f} ms of a {parts['round']:.3f} ms round "
        f"({widen_ms / parts['round']:.1%}) | {card}")
    del fp8, f8, cache
    # the engine serves without a draft again, its spec keys dropped
    engine.draft_model = engine.draft_frontend = None
    engine.executables = {k: v for k, v in engine.executables.items()
                          if "spec" not in k}
    del manager, spec1, spec8, self1, draft
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def spec_phase(dev, engine, real) -> dict:
    """Phase 15: the manager's lifecycle, its second engine and token-level
    speculative decoding. Returns the kernels' launches over its
    main-path runs."""
    card = card_line()
    total = {}
    for got in (spec_f32_phase(dev, *real, card),
                spec_bf16_phase(dev, engine, card)):
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    log(f"[spec] phase 15 launches {total}")
    return total


# -- phase 16: the serving contract and the lossless codecs -----------------------

TRACE_SECONDS = 3.0
# kernel names of PyTorch's and cuDNN's attention (SDPA's backends; the
# encoder's convolutions run other cuDNN kernels)
LIBRARY_ATTENTION = ("flash_fwd", "pytorch_flash", "fmha",
                     "efficient_attention", "sdpa", "flash_fprop")


def pcm_payload(v, bits: int, fmt: str = "pcm", big: bool = False) -> bytes:
    """Samples ``v`` [N, C] interleaved: PCM ints of ``bits`` bits (ints in
    range; 8-bit stored unsigned, as WAV's) or IEEE floats."""
    order = ">" if big else "<"
    v = np.asarray(v).reshape(-1)
    if fmt == "float":
        return v.astype(f"{order}f{bits // 8}").tobytes()
    v = v.astype(np.int64)
    if bits == 8:
        return (v + 128).astype(np.uint8).tobytes()
    if bits == 24:
        b = ((v[:, None] >> np.array([0, 8, 16])) & 0xFF).astype(np.uint8)
        return (b[:, ::-1] if big else b).tobytes()
    return v.astype(f"{order}i{bits // 8}").tobytes()


def wav_bytes(v, sr: int, bits: int = 16) -> bytes:
    """PCM WAV of int samples ``v`` [N, C]."""
    ch, body = v.shape[1], pcm_payload(v, bits)
    return (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * bits // 8,
                          ch * bits // 8, bits)
            + b"data" + struct.pack("<I", len(body)) + body)


def w64_bytes(v, sr: int, bits: int = 16, fmt: str = "pcm") -> bytes:
    """Sony Wave64: GUID chunk ids (the FourCC, then 12 bytes), int64
    sizes counting the 24-byte header, 8-byte alignment."""
    ch = v.shape[1]
    fmt_body = struct.pack("<HHIIHH", 3 if fmt == "float" else 1, ch, sr,
                           sr * ch * bits // 8, ch * bits // 8, bits)

    def chunk(cc: bytes, body: bytes) -> bytes:
        size = 24 + len(body)
        return cc + bytes(12) + struct.pack("<q", size) + body + \
            bytes(-size % 8)
    chunks = chunk(b"fmt ", fmt_body) + chunk(b"data",
                                               pcm_payload(v, bits, fmt))
    return (b"riff" + bytes(12) + struct.pack("<q", 40 + len(chunks))
            + b"wave" + bytes(12) + chunks)


def ext80(rate: int) -> bytes:
    """An integer rate as an IEEE 754 80-bit extended float."""
    e = rate.bit_length() - 1
    return struct.pack(">HQ", 16383 + e, rate << (63 - e))


def aiff_bytes(v, sr: int, bits: int = 16, comp=None,
               fmt: str = "pcm") -> bytes:
    """AIFF, or AIFC with compression type ``comp`` (``NONE``, ``twos``,
    ``sowt`` for ints; ``fl32``, ``fl64`` for floats)."""
    comm = struct.pack(">HIH", v.shape[1], v.shape[0], bits) + ext80(sr)
    if comp is not None:
        comm += comp + b"\x00\x00"     # and an empty name, padded
    ssnd = bytes(8) + pcm_payload(v, bits, fmt, big=comp != b"sowt")

    def chunk(cc: bytes, body: bytes) -> bytes:
        return cc + struct.pack(">I", len(body)) + body + \
            bytes(len(body) & 1)
    body = (b"AIFC" if comp is not None else b"AIFF") + \
        chunk(b"COMM", comm) + chunk(b"SSND", ssnd)
    return b"FORM" + struct.pack(">I", len(body)) + body


AU_ENCODINGS = {2: (8, "pcm"), 3: (16, "pcm"), 4: (24, "pcm"),
                5: (32, "pcm"), 6: (32, "float"), 7: (64, "float")}


def au_bytes(v, sr: int, encoding: int = 3) -> bytes:
    bits, fmt = AU_ENCODINGS[encoding]
    body = pcm_payload(v, bits, fmt, big=True)
    return struct.pack(">IIIIII", 0x2E736E64, 24, len(body), encoding, sr,
                       v.shape[1]) + body


def caf_bytes(v, sr: int, bits: int = 16, fmt: str = "pcm",
              little: bool = False, open_ended: bool = False) -> bytes:
    """Core Audio Format, LPCM; ``open_ended``: the data chunk's size -1
    (to the end of the file)."""
    ch = v.shape[1]
    flags = (1 if fmt == "float" else 0) | (2 if little else 0)
    desc = struct.pack(">d", float(sr)) + b"lpcm" + struct.pack(
        ">IIIII", flags, ch * bits // 8, 1, ch, bits)
    data = bytes(4) + pcm_payload(v, bits, fmt, big=not little)
    return (b"caff" + struct.pack(">HH", 1, 0)
            + b"desc" + struct.pack(">q", len(desc)) + desc
            + b"data" + struct.pack(">q", -1 if open_ended else len(data))
            + data)


def codec_variants(ints: np.ndarray, sr: int = 16000) -> dict:
    """16-bit mono samples ``ints`` (within +-32767) as WAV and in every
    other lossless container the port decodes, each holding them exactly,
    so that each decodes to the WAV's floats."""
    from qwen3_asr_tpu_torch.audio.flac import encode_flac
    v = ints[:, None]
    return {
        "wav": wav_bytes(v, sr),
        "flac16": encode_flac(ints / 32767, sr),
        "flac24_lpc": encode_flac((ints << 8) / 8388607, sr, bps=24,
                                  subframe_opts={"mode": "lpc"}),
        "flac16_stereo": encode_flac(
            None, sr, channels=np.stack([ints, ints], 1) / 32767,
            stereo_mode="mid_side"),
        "aiff": aiff_bytes(v, sr),
        "aifc_float32": aiff_bytes(v / 32768, sr, bits=32, comp=b"fl32",
                                   fmt="float"),
        "au": au_bytes(v, sr),
        "caf": caf_bytes(v, sr),
        "w64": w64_bytes(v, sr)}


class JsonLog(logging.Handler):
    """Every record as the port's JSON line (``utils/logging.py``), with
    the name of the thread that logged it."""

    def __init__(self):
        from qwen3_asr_tpu_torch.utils.logging import JsonFormatter
        super().__init__()
        self.setFormatter(JsonFormatter())
        self.lines = []

    def emit(self, record):
        self.lines.append((record.threadName, json.loads(self.format(record))))


@contextlib.contextmanager
def json_log():
    """A ``JsonLog`` on the root logger at INFO while it is open."""
    handler, level = JsonLog(), logging.root.level
    logging.root.addHandler(handler)
    logging.root.setLevel(logging.INFO)
    try:
        yield handler
    finally:
        logging.root.removeHandler(handler)
        logging.root.setLevel(level)


def request(url: str, data: bytes = None, method: str = "GET",
            headers=None, timeout: float = 600):
    """(status, body bytes) of one request, whatever the status."""
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@contextlib.contextmanager
def run_ids():
    """A list that gains the token ids of every engine dispatch
    (``TranscriptionEngine._run_bucket``) made while it is open, a list
    of rows a dispatch."""
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    runs, orig = [], TranscriptionEngine._run_bucket

    def recorded(self, *args, **kwargs):
        texts, ids = orig(self, *args, **kwargs)
        runs.append([list(row) for row in ids])
        return texts, ids

    TranscriptionEngine._run_bucket = recorded
    try:
        yield runs
    finally:
        TranscriptionEngine._run_bucket = orig


def codec_f32_phase(dev, card: str) -> None:
    """Phase 16 (a): 4 of the real clips in every lossless container through
    the server to a lazy trained_ckpt f32 manager: bodies and token ids
    equal to the WAV upload's; the loading request's id in the JSON lines
    of its thread and of the device thread."""
    from qwen3_asr_tpu_torch.audio import native
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    # every third clip: four languages; the CPU tests hold every
    # container bit-equal to JAX's decoder on all twelve
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))[::3]
    req_id = f"smoke-{uuid.uuid4().hex}"
    env = {"MODEL_ID": os.path.join(DATA, "trained_ckpt"),
           "IDLE_TIMEOUT": "0", "SKIP_WARMUP": "true"}
    t_enc, uploads, clipped = 0.0, 0, 0
    with environ(**env), json_log() as jlog, run_ids() as runs:
        manager = ModelManager(device=dev, dtype=torch.float32)
        with serving(manager) as url:
            for i, path in enumerate(clips):
                with open(path, "rb") as f:
                    ints = np.round(decode_audio(f.read())[0] * 32768
                                    ).astype(np.int64)
                clipped += int((ints < -32767).sum())
                ints = ints.clip(-32767, 32767)
                t0 = time.perf_counter()
                variants = codec_variants(ints)
                t_enc += time.perf_counter() - t0
                runs.clear()
                status, _, wav_body = post_form(
                    url, variants["wav"],
                    headers={"X-Request-ID": req_id} if i == 0 else None)
                if status != 200:
                    raise AssertionError(f"{path}: WAV upload {status}")
                ref = runs[:]
                if not ref or not ref[0]:
                    raise AssertionError(f"{path}: the WAV upload's run "
                                         f"was not recorded: {ref}")
                want = decode_audio(variants["wav"])[0]
                for name, data in variants.items():
                    if name == "wav":
                        continue
                    audio, sr = decode_audio(data)
                    runs.clear()
                    status, _, body = post_form(url, data)
                    ids = runs[:]
                    uploads += 1
                    if (status, body) != (200, wav_body) or ids != ref \
                            or sr != 16000 or not np.array_equal(audio, want):
                        raise AssertionError(
                            f"{os.path.basename(path)} as {name}: {status} "
                            f"{body[:200]!r} / {ids[:8]} vs the WAV's "
                            f"{wav_body[:200]!r} / {ref[:8]}; samples equal "
                            f"{np.array_equal(audio, want)}")
            compressed_f32_phase(url, clips, runs, card)
    log(f"[codec] (a) trained_ckpt f32, lazy: {len(clips)} clips x "
        f"{len(variants)} containers ({', '.join(variants)}), {uploads} "
        f"uploads besides the WAV's: every body, token ids (each upload's "
        f"own dispatches) and decoded sample equal to the WAV upload's "
        f"({clipped} samples of -32768 clipped to -32767 first); "
        f"containers built in {t_enc:.2f} s | {card}")
    if native.get_lib() is None:
        raise AssertionError("the FLAC helper (csrc/audio_dsp.cpp) was not "
                             "built: the plain version decoded")
    mine = [(thread, line) for thread, line in jlog.lines
            if line.get("requestId") == req_id]
    threads = sorted({t for t, _ in mine})
    log(f"[codec] (a) {len(mine)} JSON log lines carry the first upload's "
        f"X-Request-ID, on threads {threads}; e.g. "
        f"{next((l for t, l in mine if t == 'device-dispatch'), None)}")
    if "device-dispatch" not in threads or len(threads) < 2:
        raise AssertionError(f"request id {req_id} on threads {threads}: "
                             f"want the device thread and the request's")


def decode_ms(data: bytes, native: bool = True, repeats: int = 3) -> float:
    from qwen3_asr_tpu_torch.audio.flac import decode_flac
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        decode_flac(data, native=native)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def codec_bf16_phase(base: str, sent, card: str) -> None:
    """Phase 16 (b): host FLAC decode with the helper and without, and a
    FLAC upload's wall against the same audio as WAV, on phase 5's
    engine; the 330 s clip's decode. ``sent`` counts the requests."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.audio.flac import encode_flac
    real = real_audio()
    mono = real[:int(29.5 * 16000)]
    t44 = np.arange(int(29.5 * 44100)) / 44100
    left = np.interp(t44, np.arange(len(mono)) / 16000, mono)
    st = np.round(np.stack([left, 0.8 * np.roll(left, 3)], 1) * 32767
                  ).astype(np.int64).clip(-32767, 32767)
    t0 = time.perf_counter()
    flac = encode_flac(None, 44100, channels=st / 32767,
                       stereo_mode="mid_side")
    enc_s = time.perf_counter() - t0
    wav = wav_bytes(st, 44100)
    if not np.array_equal(decode_audio(flac)[0], decode_audio(wav)[0]):
        raise AssertionError("(b): the 44.1 kHz FLAC and WAV decode apart")
    five = encode_flac(None, 44100, channels=st[:5 * 44100] / 32767,
                       stereo_mode="mid_side")
    native_ms, plain_ms = decode_ms(flac), decode_ms(five, False, 1)
    per_s = native_ms / 29.5
    plain_per_s = plain_ms / 5.0
    log(f"[codec] (b) 29.5 s FLAC, 44.1 kHz stereo 16-bit mid/side "
        f"({len(flac) / 1e6:.2f} MB, WAV {len(wav) / 1e6:.2f} MB, encoded in "
        f"{enc_s:.2f} s): host decode {native_ms:.1f} ms with the helper = "
        f"{per_s:.3f} ms per audio second ({per_s * 60:.1f} ms a minute); "
        f"plain version {plain_ms:.1f} ms on the first 5 s = "
        f"{plain_per_s:.3f} ms per audio second, {plain_per_s / per_s:.1f}x "
        f"the helper's | {card}")
    url = base + "/v1/audio/transcriptions"
    walls = {"wav": [], "flac": []}
    bodies = set()
    for kind in ("wav", "flac", "flac", "wav"):
        t0 = time.perf_counter()
        status, _, body = post_form(url, wav if kind == "wav" else flac)
        walls[kind].append(time.perf_counter() - t0)
        sent[("/v1/audio/transcriptions", "POST", str(status))] += 1
        bodies.add((status, body))
    log(f"[codec] (b) preset:1.7b bf16 upload walls, in turns: WAV "
        f"{walls['wav'][0]:.3f} / {walls['wav'][1]:.3f} s, FLAC "
        f"{walls['flac'][0]:.3f} / {walls['flac'][1]:.3f} s (FLAC / WAV "
        f"{sum(walls['flac']) / sum(walls['wav']):.3f}); one body for all "
        f"four: {len(bodies) == 1} | {card}")
    if len(bodies) != 1 or next(iter(bodies))[0] != 200:
        raise AssertionError(f"(b): bodies {bodies}")
    long = np.round(np.tile(real, -(-330 * 16000 // len(real)))[
        :330 * 16000] * 32767).astype(np.int64).clip(-32767, 32767)
    t0 = time.perf_counter()
    flac330 = encode_flac(long / 32767, 16000)
    enc_s = time.perf_counter() - t0
    ms330 = decode_ms(flac330, repeats=1)
    log(f"[codec] (b) 330 s FLAC, 16 kHz mono 16-bit ({len(flac330) / 1e6:.2f}"
        f" MB, encoded in {enc_s:.2f} s): host decode {ms330:.1f} ms with the "
        f"helper = {ms330 / 330:.3f} ms per audio second | {card}")


def trace_phase(base: str, wav: bytes, sent, card: str) -> None:
    """Phase 16 (c): ``/debug/trace`` during an upload; its Chrome trace's
    kernels; a second capture answers 409."""
    url = base + "/v1/audio/transcriptions"
    trace_url = f"{base}/debug/trace?seconds={TRACE_SECONDS:g}"

    def upload() -> float:
        t0 = time.perf_counter()
        status, _, _ = post_form(url, wav)
        sent[("/v1/audio/transcriptions", "POST", str(status))] += 1
        if status != 200:
            raise AssertionError(f"(c): upload answered {status}")
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as trace_dir, \
            environ(ASR_TRACE_DIR=trace_dir):
        off = [upload(), upload()]
        first = {}

        def capture():
            first["answer"] = request(trace_url, b"", "POST")
        thread = threading.Thread(target=capture)
        thread.start()
        time.sleep(0.5)
        second = request(trace_url, b"", "POST")
        sent[("/debug/trace", "POST", str(second[0]))] += 1
        on = upload()
        thread.join(timeout=120)
        status, body = first.get("answer", (None, b""))
        sent[("/debug/trace", "POST", str(status))] += 1
        files = sorted(glob.glob(os.path.join(trace_dir, "*.json")),
                       key=os.path.getmtime)
        answer = json.loads(body) if status == 200 else {}
        # one upload's records come near the budget in 3 s: the answer
        # says whether it cut the recording
        cut = answer.get("budget_reached")
        if status != 200 or {k: answer.get(k) for k in (
                "trace_dir", "seconds")} != {
                "trace_dir": trace_dir, "seconds": TRACE_SECONDS} \
                or not 0 < answer.get("captured_seconds", 0) <= TRACE_SECONDS \
                or cut != (answer["captured_seconds"] < TRACE_SECONDS) \
                or not answer.get("kernel_records") \
                or second[0] != 409 or not files:
            raise AssertionError(f"(c): trace {status} {body[:200]!r}, "
                                 f"second {second}, files {files}")
        size = os.path.getsize(files[-1])
        t0 = time.perf_counter()
        with open(files[-1], encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        read_s = time.perf_counter() - t0
    kernels = collections.Counter(e.get("name", "") for e in events
                                  if e.get("cat") == "kernel")
    flash = sum(n for k, n in kernels.items() if "flash_bf16_kernel" in k)
    decode = sum(n for k, n in kernels.items() if "decode_split_kernel" in k)
    library = {k[:80]: n for k, n in kernels.items()
               if any(p in k.lower() for p in LIBRARY_ATTENTION)}
    log(f"[trace] (c) POST /debug/trace?seconds={TRACE_SECONDS:g} during a "
        f"29.5 s upload: 200 {answer}; a second capture meanwhile "
        f"answered {second[0]} {json.loads(second[1])['code']}; the trace "
        f"{size / 1e6:.1f} MB ({read_s:.1f} s to parse), {len(events)} "
        f"events, {sum(kernels.values())} kernel events of "
        f"{len(kernels)} names (the answer's estimate "
        f"{answer['kernel_records']}): flash_bf16_kernel {flash}, "
        f"decode_split_kernel {decode}, library attention {library} | {card}")
    log(f"[trace] (c) the upload's wall: {off[0]:.3f} / {off[1]:.3f} s "
        f"without a capture, {on:.3f} s under it | {card}")
    if not flash or not decode or library:
        raise AssertionError(f"(c): the trace holds flash {flash}, decode "
                             f"{decode}, library attention {library}")


def metrics_phase(base: str, sent, card: str) -> None:
    """Phase 16 (d): ``/metrics`` against the requests the phase sent;
    ``/openapi.json`` and ``/docs``; a 404."""
    from qwen3_asr_tpu_torch.serving.meta import route_metadata
    for path in ("/openapi.json", "/docs", "/no/such/route"):
        status, body = request(base + path)
        sent[(path if status != 404 else "unmatched", "GET",
              str(status))] += 1
        if path == "/openapi.json":
            doc = json.loads(body)
    routes = {(r["path"], r["method"].lower()) for r in route_metadata()}
    listed = {(p, m) for p, ops in doc["paths"].items() for m in ops}
    status, text = request(base + "/metrics")
    text = text.decode()
    got, hist, types = {}, {}, collections.Counter()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            types[line.split()[2]] += 1
            continue
        name, _, value = line.rpartition(" ")
        labels = dict(re.findall(r'(\w+)="([^"]*)"', name))
        if name.startswith("asr_requests_total{"):
            got[(labels["path"], labels["method"], labels["status"])] = \
                float(value)
        elif name.startswith("asr_request_duration_seconds_count{"):
            hist[labels["path"]] = float(value)
    want_hist = collections.Counter()
    for (path, _, _), n in sent.items():
        if path != "unmatched":
            want_hist[path] += n
    gauges = [g for g in ("asr_model_loaded 1.0", "asr_queue_depth 0.0",
                          "asr_ws_sessions 0.0") if g in text.splitlines()]
    log(f"[metrics] (d) asr_requests_total {got}; the duration histogram's "
        f"counts {hist}; gauges {gauges}; one TYPE line a name "
        f"{max(types.values()) == 1}; /openapi.json lists "
        f"{len(listed)} operations, every route of meta.py: "
        f"{routes <= listed} | {card}")
    if status != 200 or got != {k: float(n) for k, n in sent.items()} \
            or hist != {k: float(n) for k, n in want_hist.items()} \
            or len(gauges) != 3 or max(types.values()) != 1 \
            or not routes <= listed:
        raise AssertionError(f"(d): /metrics {got} / {hist} against the "
                             f"requests sent {dict(sent)}")


COMPRESSED = os.path.join(DATA, "compressed")


def float_wav_bytes(audio, sr: int) -> bytes:
    """Mono IEEE-float WAV of float32 ``audio``."""
    pcm = np.asarray(audio, "<f4").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 3, 1, sr, 4 * sr, 4, 32)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def cer(ref: str, hyp: str) -> float:
    """Character error rate of ``hyp`` against ``ref``, whitespace and
    case aside (Levenshtein over characters)."""
    a, b = "".join(ref.lower().split()), "".join(hyp.lower().split())
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1] / max(1, len(a))


# (a')'s files of each clip, by the suffix after its stem
COMPRESSED_SUFFIXES = (".mp3", ".ogg", "_silk.opus", "_celt.opus",
                       "_hybrid.opus", ".mp2")


def compressed_f32_phase(url: str, clips, runs, card: str) -> None:
    """Phase 16 (a'): (a)'s clips as MP3 (16 kHz mono, MPEG-2), Ogg
    Vorbis, Ogg Opus of each mode (SILK 16 kHz VOIP, CELT by libsndfile,
    hybrid at 48 kHz) and MPEG-2 Layer II behind an ID3v2 tag, committed
    in ``e2e/data/compressed``: each upload's body and its dispatch's token
    ids equal those of a float32 WAV upload of the port's own decode of
    the file; the C++ helper is built and decodes the shortest file of each
    codec as the plain loops do; the MP3 transcripts' CER against the
    clips' text, printed."""
    from qwen3_asr_tpu_torch.audio import mp3, native, vorbis
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.audio.ogg_opus import decode_ogg_opus
    t0 = time.perf_counter()
    cers, uploads = [], 0
    for path in clips:
        stem = os.path.basename(path)[:-4]
        for ext in COMPRESSED_SUFFIXES:
            with open(os.path.join(COMPRESSED, stem + ext), "rb") as f:
                data = f.read()
            audio, sr = decode_audio(data)
            runs.clear()
            status, _, ref_body = post_form(url, float_wav_bytes(audio, sr))
            ref = runs[:]
            runs.clear()
            got, _, body = post_form(url, data)
            ids = runs[:]
            uploads += 2
            if status != 200 or (got, body) != (200, ref_body) \
                    or ids != ref or not ref:
                raise AssertionError(
                    f"(a') {stem}{ext}: {got} {body[:200]!r} / {ids[:8]} "
                    f"vs the float WAV's {status} {ref_body[:200]!r} / "
                    f"{ref[:8]}")
            if ext == ".mp3":
                with open(path[:-4] + ".txt", encoding="utf-8") as f:
                    want = f.read().strip()
                cers.append(f"{stem} {cer(want, json.loads(body)['text']):.3f}")
    lib = native.get_lib()
    if lib is None:
        raise AssertionError("(a'): the helper (csrc/audio_dsp.cpp) was not "
                             "built: the plain version decoded")
    same = []
    t_same = time.perf_counter()
    for ext, decode in ((".mp3", mp3.decode_mp3),
                        (".ogg", vorbis.decode_vorbis),
                        ("_silk.opus", decode_ogg_opus),
                        ("_celt.opus", decode_ogg_opus),
                        ("_hybrid.opus", decode_ogg_opus),
                        (".mp2", mp3.decode_mp3)):
        path = min(glob.glob(os.path.join(COMPRESSED, f"*{ext}")),
                   key=os.path.getsize)
        with open(path, "rb") as f:
            data = f.read()
        a, b = decode(data)[0], decode(data, native=False)[0]
        if not np.array_equal(a, b):
            raise AssertionError(f"(a'): {os.path.basename(path)}: the "
                                 f"helper and the plain loops decode apart")
        same.append(f"{os.path.basename(path)} ({len(a)} samples)")
    log(f"[codec] (a') trained_ckpt f32: {len(clips)} clips as MP3, Ogg "
        f"Vorbis, Ogg Opus (SILK, CELT, hybrid) and Layer II, {uploads} "
        f"uploads: every body and token ids equal to a float32 WAV upload "
        f"of the port's decode; helper built and used ({lib._name}), equal "
        f"to the plain loops bit for bit on {', '.join(same)} "
        f"({time.perf_counter() - t_same:.1f} s); MP3 CER "
        f"{'; '.join(cers)}; {time.perf_counter() - t0:.1f} s | {card}")


def compressed_bf16_phase(base: str, engine, sent, card: str) -> dict:
    """Phase 16 (b'): the ~29.5 s MP3 (MPEG-1 joint stereo, 44.1 kHz, LAME
    tag), Ogg Vorbis (44.1 kHz stereo), Ogg Opus (48 kHz stereo, hybrid
    then CELT) and MPEG-1 Layer II (44.1 kHz joint stereo) of the FLEURS
    clips on phase 5's engine: host decode ms an audio second with the
    helper and with the plain loops (on the first 2 s), and each upload's
    wall against a float WAV of the same decode, in turns. Returns the
    kernels' launches."""
    from qwen3_asr_tpu_torch.audio import mp3, vorbis
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.audio.ogg_opus import decode_ogg_opus
    url = base + "/v1/audio/transcriptions"
    t_phase = time.perf_counter()
    counter = PathLaunches(engine)
    for ext, name, decode in (
            ("mp3", "long_44k_stereo.mp3", mp3.decode_mp3),
            ("ogg", "long_44k_stereo.ogg", vorbis.decode_vorbis),
            ("opus", "long_48k_stereo.opus", decode_ogg_opus),
            ("mp2", "long_44k_stereo.mp2", mp3.decode_mp3)):
        with open(os.path.join(COMPRESSED, name), "rb") as f:
            data = f.read()
        audio, sr = decode_audio(data)
        seconds = len(audio) / sr
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            decode(data)
            best = min(best, time.perf_counter() - t0)
        tracemalloc.start()
        decode_audio(data)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        head = data[:int(len(data) * 2.0 / seconds)]
        t0 = time.perf_counter()
        plain = decode(head, native=False)[0]
        plain_s = time.perf_counter() - t0
        per_s, plain_per_s = best * 1e3 / seconds, plain_s * 1e3 / (
            len(plain) / sr)
        wav = float_wav_bytes(audio, sr)
        walls = {"wav": [], ext: []}
        bodies = set()
        for kind in ("wav", ext, ext, "wav"):
            t0 = time.perf_counter()
            status, _, body = post_form(url, wav if kind == "wav" else data)
            walls[kind].append(time.perf_counter() - t0)
            sent[("/v1/audio/transcriptions", "POST", str(status))] += 1
            bodies.add((status, body))
        log(f"[codec] (b') {seconds:.2f} s {ext.upper()}, {sr / 1e3:g} kHz "
            f"stereo "
            f"({len(data) / 1e6:.3f} MB): host decode {best * 1e3:.1f} ms "
            f"with the helper = {per_s:.3f} ms per audio second; plain "
            f"loops {plain_s * 1e3:.1f} ms on the first "
            f"{len(plain) / sr:.2f} s = {plain_per_s:.3f} ms per audio "
            f"second ({plain_per_s / per_s:.1f}x); the upload's decode "
            f"allocates at most {peak / 2**20:.1f} MiB (tracemalloc) for "
            f"{audio.nbytes / 2**20:.1f} MiB of mono float32; preset:1.7b "
            f"bf16 upload "
            f"walls in turns: WAV {walls['wav'][0]:.3f} / "
            f"{walls['wav'][1]:.3f} s, {ext.upper()} {walls[ext][0]:.3f} / "
            f"{walls[ext][1]:.3f} s ({ext.upper()} / WAV "
            f"{sum(walls[ext]) / sum(walls['wav']):.3f}); one body for all "
            f"four: {len(bodies) == 1} | {card}")
        if len(bodies) != 1 or next(iter(bodies))[0] != 200:
            raise AssertionError(f"(b') {ext}: bodies {bodies}")
    launches, _ = counter.read()
    for name in ("flash_attention", "decode_attention"):
        if not launches.get(name):
            raise AssertionError(f"(b') launched no {name}: {launches}")
    log(f"[codec] (b') launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s | {card}")
    return launches


def contract_phase(dev, engine) -> dict:
    """Phase 16: the serving contract and the upload codecs. Returns the
    kernels' launches over (b), (c) and (b')."""
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    card = card_line()
    codec_f32_phase(dev, card)
    manager = ModelManager(engine)
    manager.warmed = True
    sent = collections.Counter()
    with serving(manager) as url:
        base = url.rsplit("/v1/", 1)[0]
        counter = PathLaunches(engine)
        codec_bf16_phase(base, sent, card)
        trace_phase(base, upload_bodies()[-1][1], sent, card)
        launches, _ = counter.read()
        compressed = compressed_bf16_phase(base, engine, sent, card)
        metrics_phase(base, sent, card)
    for name, n in compressed.items():
        launches[name] = launches.get(name, 0) + n
    log(f"[contract] phase 16 launches {launches}")
    return launches


# -- phase 17: gateway mode ----------------------------------------------------

# Chat templates in the Qwen style for trained_ckpt (its tokenizer has the
# builtin prompt's special tokens): (i) renders the builtin prompt's layout
# (phase 17 (a) serves it), (ii) drops the system block.
# tests/test_torch_chat_template.py holds both against jinja2 and the JAX
# engine on the CPU.
TEMPLATE_BUILTIN_LAYOUT = (
    "{%- for message in messages %}\n"
    "{{- '<|im_start|>' + message['role'] + '\\n' }}\n"
    "{%- if message['content'] is string %}\n"
    "    {{- message['content'] }}\n"
    "{%- else %}\n"
    "    {%- for part in message['content'] %}\n"
    "        {%- if part['type'] == 'audio' %}\n"
    "            {{- audio_bos_token + audio_token + audio_eos_token }}\n"
    "        {%- elif part['type'] == 'text' %}\n"
    "            {{- part['text'] }}\n"
    "        {%- endif %}\n"
    "    {%- endfor %}\n"
    "{%- endif %}\n"
    "{{- '<|im_end|>\\n' }}\n"
    "{%- endfor %}\n"
    "{%- if add_generation_prompt %}\n"
    "{{- '<|im_start|>assistant\\n' }}\n"
    "{%- endif %}\n")

TEMPLATE_NO_SYSTEM = TEMPLATE_BUILTIN_LAYOUT.replace(
    "{%- for message in messages %}\n",
    "{%- for message in messages %}\n"
    "{%- if message.role == 'system' %}{% continue %}{% endif %}\n", 1)


def template_ckpt(root: str, name: str, template: str) -> str:
    """A copy of trained_ckpt whose ``tokenizer_config.json`` carries
    ``template``."""
    dst = os.path.join(root, name)
    shutil.copytree(os.path.join(DATA, "trained_ckpt"), dst)
    with open(os.path.join(dst, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": template}, f)
    return dst


@contextlib.contextmanager
def gateway_serving(fleet):
    """The port's gateway over ``fleet`` on 127.0.0.1 (an ephemeral port),
    its watchdog running; yields its base URL, and stops the gateway and
    kills every worker afterwards (the smoke must leave no process)."""
    from qwen3_asr_tpu_torch.serving.gateway import build_gateway
    server = build_gateway(fleet)
    fleet.start_watchdog()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        fleet.stop_watchdog()
        fleet.kill_all()
        for s in fleet.supervisors:
            if s.proc is not None and s.proc.poll() is None:
                s.proc.kill()
        thread.join(timeout=30)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_tails(fleet, lines: int = 30) -> str:
    out = []
    for s in fleet.supervisors:
        if s.log_path and os.path.exists(s.log_path):
            with open(s.log_path, errors="replace") as f:
                tail = f.readlines()[-lines:]
            out.append(f"--- worker {s.index} ({s.log_path}):\n"
                       + "".join(tail))
    return "\n".join(out)


def post_as(url: str, data: bytes, req_id: str) -> dict:
    """``post`` with an ``X-Request-ID``."""
    from qwen3_asr_tpu_torch.serving.gateway import multipart
    ctype, body = multipart({}, data, "a.wav")
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": ctype, "X-Request-ID": req_id})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def logged_ids(fleet, req_ids) -> dict:
    """request id -> the token ids the workers' debug lines give for it
    (``serving/server.py`` logs them with the forwarded request id)."""
    want, out = set(req_ids), {}
    for s in fleet.supervisors:
        with open(s.log_path, errors="replace") as f:
            for line in f:
                if "| token ids " not in line:
                    continue
                rec = json.loads(line)
                if rec.get("requestId") in want:
                    ids = json.loads(rec["message"].split("| token ids ")[1])
                    out[rec["requestId"]] = ids[0] if len(ids) == 1 else ids
    return out


def compute_apps() -> dict:
    """pid -> used memory, as ``nvidia-smi --query-compute-apps`` lists
    them."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


def send_at_once(url: str, wavs, prefix: str) -> list:
    """Every upload at once, each with the request id ``prefix-i``."""
    with concurrent.futures.ThreadPoolExecutor(len(wavs)) as pool:
        return list(pool.map(lambda a: post_as(url, a[1], f"{prefix}-{a[0]}"),
                             enumerate(wavs)))


def gateway_f32_phase(dev, real, root: str, card: str) -> None:
    """(a) trained_ckpt f32 behind the gateway, two workers on the card
    (``WORKER_PORTS``), with a checkpoint chat template: (i) one that
    renders the builtin layout: phase 4's 12 clips at once through the
    gateway, answers and token ids equal to phase 4's card results, both
    workers serving; an SSE stream and a WS session (english_02) through
    the gateway equal to the same sent to a worker directly."""
    from qwen3_asr_tpu_torch.serving.gateway import WorkerFleet
    wavs, wants, ids = real
    builtin = template_ckpt(root, "builtin_layout", TEMPLATE_BUILTIN_LAYOUT)
    with environ(WORKER_PORTS=f"{free_port()},{free_port()}"):
        fleet = WorkerFleet.from_env(device="cuda", dtype="float32")
    for s in fleet.supervisors:
        # NVIDIA_TF32_OVERRIDE=0: f32 convolutions without TF32, as this
        # process runs them (phase 4's ids)
        s.spawn_env.update(MODEL_ID=builtin, SKIP_WARMUP="true",
                           IDLE_TIMEOUT="0", LOG_LEVEL="debug",
                           NVIDIA_TF32_OVERRIDE="0")
        s.log_path = os.path.join(root, f"worker_{s.index}.log")
    try:
        with gateway_serving(fleet) as base:
            t0 = time.perf_counter()
            fleet.ensure_all_managed()
            log(f"[gateway] (a) two trained_ckpt f32 workers on the card "
                f"(ports {[s.port for s in fleet.supervisors]}, pids "
                f"{[s.proc.pid for s in fleet.supervisors]}) ready in "
                f"{time.perf_counter() - t0:.1f} s")
            url = base + "/v1/audio/transcriptions"
            t0 = time.perf_counter()
            bodies = send_at_once(url, wavs, "p17a-i")
            wall = time.perf_counter() - t0
            got = logged_ids(fleet, [f"p17a-i-{i}" for i in range(len(wavs))])
            got = [got.get(f"p17a-i-{i}") for i in range(len(wavs))]
            served = [s.served for s in fleet.supervisors]
            health = [get_health(s.url("")) for s in fleet.supervisors]
            log(f"[gateway] (a)(i) builtin-layout template: {len(wavs)} clips "
                f"at once through the gateway in {wall:.3f} s, served "
                f"{served}; answers equal to phase 4's: {bodies == wants}; "
                f"token ids equal to phase 4's card ids: {got == ids}; "
                f"workers' hbm_used_mb {[h.get('hbm_used_mb') for h in health]}"
                f", model_id {[h.get('model_id') for h in health]} | {card}")
            if bodies != wants or got != ids or min(served) < 1 or not all(
                    h.get("hbm_used_mb") for h in health):
                raise AssertionError(f"(a)(i): bodies {bodies}, ids {got}, "
                                     f"served {served}, health {health}")
            wav = real_text_wav("english_02.wav")
            direct = fleet.supervisors[0]
            events = [read_sse(u, wav, time.perf_counter())[0] for u in (
                base + "/v1/audio/transcriptions/stream",
                direct.url("/transcribe/stream"))]
            pcm = real_pcm("english_02.wav")
            msgs = [ws_stream(u, pcm, "?use_server_vad=false") for u in (
                base.replace("http", "ws") + "/ws/transcribe",
                direct.url("/ws/transcribe").replace("http", "ws"))]
            log(f"[gateway] (a)(i) english_02: SSE {len(events[0])} events "
                f"through the gateway, equal to a worker's own: "
                f"{events[0] == events[1]}; WS {len(msgs[0])} messages, "
                f"equal: {msgs[0] == msgs[1]}")
            if events[0] != events[1] or msgs[0] != msgs[1] or \
                    events[0][-1] != {"done": True} or len(msgs[0]) < 4:
                raise AssertionError(f"(a): SSE {events}, WS {msgs}")
    except BaseException:
        log(worker_tails(fleet))
        raise


def real_text_wav(name: str) -> bytes:
    with open(os.path.join(DATA, "real", name), "rb") as f:
        return f.read()


def bf16_worker(root: str):
    """(b)'s supervisor: preset:1.7b bf16 warmed at 10 and 30 s, its idle
    kill off until (b) asks for it."""
    from qwen3_asr_tpu_torch.serving.gateway import WorkerSupervisor
    with environ(IDLE_TIMEOUT="2"):
        sup = WorkerSupervisor(port=free_port(), device="cuda",
                               watchdog_interval=1.0,
                               log_path=os.path.join(root, "worker_b.log"),
                               spawn_env={"MODEL_ID": "preset:1.7b",
                                          "ASR_WARMUP_BUCKETS": "10,30",
                                          # uploads only: no WS tick and
                                          # flush keys at B = 2, 4, 8
                                          "ASR_WS_TICK_MAX_BATCH": "1",
                                          "IDLE_TIMEOUT": "0",
                                          "ASR_BATCH_WINDOW_MS": "200",
                                          "LOG_LEVEL": "debug"})
    sup.idle_timeout = 0
    return sup


def gateway_bf16_phase(dev, sup, before, warm_s: float, card: str) -> None:
    """(b) preset:1.7b bf16, full width, one managed worker (``sup``,
    spawned and warmed at 10 and 30 s while (a) ran, in ``warm_s``): the
    10 s and 30 s uploads sent directly and through the gateway, in turns,
    medians of 5 and the hop's ms; 8 uploads at once through the gateway
    (one B=8 dispatch in the worker); the idle kill (``IDLE_TIMEOUT`` 2 s,
    a 1 s watchdog): card memory before the spawn (``before``: free MiB
    and ``nvidia-smi``'s apps), loaded and after the kill, the worker's
    PID in ``nvidia-smi`` while loaded and gone after; then a cold
    respawn's seconds from request to answer."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.serving.gateway import WorkerFleet
    free0, apps0 = before
    fleet = WorkerFleet([sup])
    audio = real_audio()
    seg = int(9.5 * 16000)
    clips8 = [encode_wav(audio[i * seg:(i + 1) * seg], 16000)
              for i in range(8)]
    uploads = {"10 s": clips8[0], "30 s": upload_bodies()[-1][1]}
    try:
        with gateway_serving(fleet) as base:
            sup.ensure()                 # spawned while (a) ran
            time.sleep(1.0)              # (a)'s workers' memory returned
            free1 = torch.cuda.mem_get_info(dev)[0] / 2 ** 20
            apps1 = compute_apps()
            health = get_health(sup.url(""))
            log(f"[gateway] (b) preset:1.7b bf16 worker (pid {sup.proc.pid}) "
                f"loaded and warmed (10, 30 s) in {warm_s:.1f} s while (a) "
                f"ran; its "
                f"/health hbm_used_mb {health.get('hbm_used_mb')} of "
                f"{health.get('hbm_limit_mb')}; card free "
                f"{free0:.0f} -> {free1:.0f} MiB; nvidia-smi apps {apps1} "
                f"| {card}")
            gw_url = base + "/v1/audio/transcriptions"
            direct_url = sup.url("/transcribe")
            for name, wav in uploads.items():
                post(direct_url, wav)      # each route's first use
                post(gw_url, wav)
                walls = {"direct": [], "gateway": []}
                for _ in range(5):
                    for kind, u in (("direct", direct_url), ("gateway", gw_url)):
                        t0 = time.perf_counter()
                        post(u, wav)
                        walls[kind].append(time.perf_counter() - t0)
                med = {k: float(np.median(v)) for k, v in walls.items()}
                log(f"[gateway] (b) {name} upload (the worker's 200 ms "
                    f"batch window included), median of 5: direct "
                    f"{med['direct'] * 1e3:.1f} ms, through the gateway "
                    f"{med['gateway'] * 1e3:.1f} ms: the hop "
                    f"{(med['gateway'] - med['direct']) * 1e3:.1f} ms (walls "
                    f"direct {[round(w * 1e3, 1) for w in walls['direct']]}, "
                    f"gateway {[round(w * 1e3, 1) for w in walls['gateway']]})"
                    f" | {card}")
            for attempt in range(3):     # until they land in one window
                t0 = time.perf_counter()
                bodies = send_at_once(gw_url, clips8, f"p17b-{attempt}")
                wall8 = time.perf_counter() - t0
                with open(sup.log_path, errors="replace") as f:
                    batches = [json.loads(line)["message"] for line in f
                               if "micro-batch: " in line]
                log(f"[gateway] (b) 8 uploads at once through the gateway: "
                    f"{wall8:.3f} s; the worker's dispatches {batches}")
                if any(m.startswith("micro-batch: 8 requests")
                       for m in batches):
                    break
            else:
                raise AssertionError(f"(b): no B=8 dispatch: {batches}")
            if not all(isinstance(b.get("text"), str) for b in bodies):
                raise AssertionError(f"(b): bodies {bodies}")
            # the idle kill
            pid = sup.proc.pid
            sup.idle_timeout = 2
            t_idle = time.perf_counter()
            proc = sup.proc
            while (sup.alive() or proc.poll() is None) \
                    and time.perf_counter() - t_idle < 60:
                time.sleep(0.1)
            killed_s = time.perf_counter() - t_idle
            time.sleep(1.0)              # freed memory shows a moment later
            free2 = torch.cuda.mem_get_info(dev)[0] / 2 ** 20
            apps2 = compute_apps()
            listed = pid in apps1
            log(f"[gateway] (b) idle kill {killed_s:.2f} s after the last "
                f"request (IDLE_TIMEOUT 2 s, watchdog 1 s); card free "
                f"before the spawn {free0:.0f}, loaded {free1:.0f}, after the "
                f"kill {free2:.0f} MiB: {free2 - free1:.0f} MiB returned; "
                f"worker pid {pid} in nvidia-smi while loaded: {listed}, "
                f"after: {pid in apps2}; nvidia-smi's compute apps before "
                f"the spawn {apps0}, loaded {apps1}, after the kill {apps2} "
                f"(where every process shows as one pid, that pid's memory "
                f"is their sum) | {card}")
            if proc.poll() is None or free2 - free1 < 4000:
                raise AssertionError("(b): the idle kill did not return the "
                                     "worker's memory")
            if os.getpid() in apps1 and (not listed or pid in apps2):
                raise AssertionError(f"(b): nvidia-smi lists {apps1} "
                                     f"loaded, {apps2} after the kill")
            # a cold respawn: request to answer
            sup.idle_timeout = 0
            t0 = time.perf_counter()
            body = post(gw_url, uploads["10 s"])
            cold = time.perf_counter() - t0
            log(f"[gateway] (b) cold respawn: {cold:.2f} s from request to "
                f"answer (spawn, load, warmup of 10 and 30 s, the request); "
                f"pid {sup.proc.pid} | {card}")
            if not isinstance(body.get("text"), str) or sup.proc.pid == pid:
                raise AssertionError(f"(b): cold respawn {body}")
    except BaseException:
        log(worker_tails(fleet))
        raise


def gateway_phase(dev, real) -> None:
    """Phase 17: gateway mode. The workers are processes of their own, so
    their kernel launches are not counted in this process; the evidence
    that they ran on the card is (a)'s token ids equal to the card's
    in-process ids (phase 4), the workers' ``/health`` ``hbm_used_mb``, the
    card memory a worker holds and the idle kill returns, and its PID in
    ``nvidia-smi``."""
    card = card_line()
    root = tempfile.mkdtemp(prefix="smoke_gateway_")
    sup = None
    try:
        gc.collect()
        torch.cuda.empty_cache()
        before = (torch.cuda.mem_get_info(dev)[0] / 2 ** 20, compute_apps())
        sup = bf16_worker(root)
        warm = {}

        def spawn():                     # (b)'s worker warms during (a)
            t0 = time.perf_counter()
            try:
                sup.ensure()
                warm["s"] = time.perf_counter() - t0
            except Exception as e:
                warm["error"] = e
        spawner = threading.Thread(target=spawn)
        spawner.start()
        try:
            gateway_f32_phase(dev, real, root, card)
        finally:
            spawner.join()
        if "error" in warm:
            raise warm["error"]
        gateway_bf16_phase(dev, sup, before, warm["s"], card)
    finally:
        if sup is not None:
            sup.kill()
        shutil.rmtree(root, ignore_errors=True)


# -- phase 18 --------------------------------------------------------------------

TRAIN_BUCKET_S = 6.0       # (b), (c): the training batches' bucket
TRAIN_BATCH = 8            # (c): rows a full-width step
TRAIN_LR = 1e-5            # (b), (c), (d): the fine-tuning CLI's default
TRAIN_STEPS = 3            # (b): steps, card against CPU; (c): timed steps
TRAIN_TOL = 1e-5           # (b): the losses, card against CPU, relative


def train_shapes():
    """The shapes a preset:1.7b training step at the 6 s bucket gives the
    backward kernels: the encoder's windows (and at 30 s), the decoder's
    causal forward over [prefix, audio, suffix + targets]."""
    from qwen3_asr_tpu_torch.models.asr import PromptTemplate
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.encoder import (conv_tokens_per_chunk,
                                                    encoder_output_length)
    from qwen3_asr_tpu_torch.runtime.engine import (PREFIX_BUDGET,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    enc, dec = cfg.encoder, cfg.decoder
    chunk = enc.n_window * 2
    frames = -(-int(TRAIN_BUCKET_S * 100) // chunk) * chunk
    tok, tmpl = preset_tokenizer(dec.vocab_size), PromptTemplate()
    t_audio = int(encoder_output_length(frames, chunk))
    t_train = (PREFIX_BUDGET + t_audio + len(tok.encode(tmpl.suffix_text()))
               + max_new_tokens_for(frames / 100.0))
    return dict(
        t_audio=t_audio, t_enc_30s=int(encoder_output_length(3000, chunk)),
        window=conv_tokens_per_chunk(chunk) * max(1, enc.n_window_infer
                                                  // chunk),
        enc_heads=enc.encoder_attention_heads, enc_d=enc.head_dim,
        t_train=t_train, nq=dec.num_attention_heads,
        nkv=dec.num_key_value_heads, d=dec.head_dim,
        valid_from=PREFIX_BUDGET - len(tok.encode(tmpl.prefix_text(None))))


def flash_bwd_cases(ts, dtype, dev):
    """(label, args, kw, (SDPA forward, SDPA forward and backward),
    bytes, flops) of kernel (i)
    at the encoder's 6 s (B=8) and 30 s (B=1) windows and the training
    forward's causal shape (B=8, rows left-padded to the prompt)."""
    from qwen3_asr_tpu_torch.ops.attention import AttnSpec
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(18)
    esize = torch.tensor([], dtype=dtype).element_size()
    shapes = [
        ("encoder_6s_b8", 8, ts["enc_heads"], ts["enc_heads"], ts["t_audio"],
         ts["enc_d"], AttnSpec(window_block=ts["window"])),
        ("encoder_30s_b1", 1, ts["enc_heads"], ts["enc_heads"],
         ts["t_enc_30s"], ts["enc_d"], AttnSpec(window_block=ts["window"])),
        ("train_causal_b8_6s", 8, ts["nq"], ts["nkv"], ts["t_train"],
         ts["d"], AttnSpec(causal=True, valid_from=ts["valid_from"])),
    ]
    out = []
    for label, b, nq, nkv, t, d, spec in shapes:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        def i32(v):
            return torch.full((b,), v, dtype=torch.int32, device=dev)

        q, g = randn(b, nq, t, d), randn(b, nq, t, d)
        k, v = randn(b, nkv, t, d), randn(b, nkv, t, d)
        vf = i32(spec.valid_from or 0)
        vt, zero = i32(t), i32(0)
        _, m, l = flash_attention(q, k, v, causal=spec.causal,
                                  kv_valid_from=vf,
                                  window_block=spec.window_block,
                                  return_residuals=True)
        kw = dict(causal=spec.causal, window_block=spec.window_block,
                  sm_scale=d ** -0.5)
        mask = spec._replace(valid_from=vf).dense_mask(b, t, t, dev)
        ins = tuple(x.clone().requires_grad_() for x in (q, k, v))

        def sdpa(ins=ins, mask=mask, gqa=nq != nkv):
            return F.scaled_dot_product_attention(
                *ins, attn_mask=mask[:, None], enable_gqa=gqa)

        def sdpa_fwd_bwd(sdpa=sdpa, ins=ins, g=g):
            return torch.autograd.grad(sdpa(), ins, g)

        # inputs q, k, v, dO, m, l and the three int32 [B]; outputs dq,
        # dk, dv; five products over the live (row, key) pairs of every
        # query head
        nbytes = ((2 * b * nq * t * d + 2 * b * nkv * t * d) * esize
                  + 2 * 4 * b * nq * t + 3 * 4 * b
                  + (b * nq * t * d + 2 * b * nkv * t * d) * esize)
        flops = 5 * 2 * d * nq * int(mask.sum())
        out.append((label, (q, k, v, g, m, l, vf, vt, zero), kw,
                    (sdpa, sdpa_fwd_bwd), nbytes, flops))
    return out


def qk_bwd_cases(ts, dtype, dev):
    """(label, args, plain call, bytes, flops) of kernel (ii) at the
    training forward's rows (B=8) and trained_ckpt's heads (d 48)."""
    from qwen3_asr_tpu_torch.models.decoder import rope_cos_sin
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import _heads, qk_rope_bwd_plain
    gen = torch.Generator(device=dev).manual_seed(19)
    esize = torch.tensor([], dtype=dtype).element_size()
    out = []
    for label, b, t, nq, nkv, d in (
            ("qk_bwd_b8_6s", 8, ts["t_train"], ts["nq"], ts["nkv"], ts["d"]),
            ("qk_bwd_trained_ckpt_b12", 12, 210, 4, 2, 48)):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q, k = randn(b, t, nq * d), randn(b, t, nkv * d)
        wq, wk = (1 + 0.1 * randn(d)).to(dtype), (1 + 0.1 * randn(d)).to(dtype)
        gq, gk, gv = randn(b, nq, t, d), randn(b, nkv, t, d), \
            randn(b, nkv, t, d)
        cos, sin = rope_cos_sin(
            torch.arange(t, device=dev)[None].expand(b, t), d, 1e6)
        args = (q, k, wq, wk, cos, sin, 1e-6, gq, gk, gv)

        def plain(q=q, k=k, wq=wq, wk=wk, cos=cos, sin=sin, gq=gq, gk=gk,
                  gv=gv, d=d, b=b, t=t):
            dq, dwq = qk_rope_bwd_plain(_heads(q, d), wq, cos, sin, 1e-6, gq)
            dk, dwk = qk_rope_bwd_plain(_heads(k, d), wk, cos, sin, 1e-6, gk)
            flat = lambda x: x.transpose(1, 2).reshape(b, t, -1)  # noqa
            return flat(dq), flat(dk), flat(gv), dwq, dwk

        rows = b * t * (nq + nkv) * d        # elements of q and k
        # read x (q, k), g (q, k, v), the norms, cos and sin; write dx
        # (q, k, v) and the two norm gradients; ~16 flops a q/k element
        nbytes = (rows + 2 * (rows + b * t * nkv * d) + 4 * d) * esize \
            + 2 * b * t * d * 4
        out.append((label, args, plain, nbytes, 16 * rows))
    return out


def train_time_row(label, dt, route, err, run, plain, library, nbytes,
                   flops, card):
    """Phase 3's row for a backward kernel: device ms of the kernel, of its
    plain version and of the library's backward (CUDA graph replays; the
    library's backward as its forward and backward, autograd captured in
    the graph, less its forward alone), the bound (the products at the
    dtype's peak: bf16's tensor cores, f32's CUDA cores)."""
    ms, plain_ms = per_call_ms(run, 0), per_call_ms(plain, 0, PLAIN_ITERS)
    lib_ms = (per_call_ms(library[1], 0) - per_call_ms(library[0], 0)
              if library is not None else None)
    if lib_ms is not None and not lib_ms > 0:
        raise AssertionError(f"{label}: SDPA's forward and backward took no "
                             f"longer than its forward ({lib_ms} ms)")
    call_ms = eager_ms(run, 50)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS) * 1e3
    bound = max(t_bytes, t_ops)
    name = str(dt)[6:]
    row = {"shape": label if dt == torch.bfloat16 else f"{label}_{name}",
           "dtype": name, "route": route, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "eager_ms": call_ms, "bytes": nbytes, "flops": flops}
    lib = (f"SDPA backward {lib_ms:.4f} ms (kernel / library "
           f"{ms / lib_ms:.3f})" if lib_ms is not None else
           "no library call")
    earlier = EARLIER_MS.get(row["shape"])
    before = (f"; its first version {earlier:.4f} ms (PERF.md)"
              if earlier is not None else "")
    log(f"[timing] {label} {name}, route {route} (device): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {lib}; one eager call "
        f"{call_ms:.4f} ms; bound {bound:.5f} ms ({row['bound_by']}), share "
        f"{bound / ms:.3%}{before} | {card}")
    return row


def train_kernel_rows(ts, dev, card) -> dict:
    """Phase 18 (a): kernels (i) and (ii) against their plain versions in
    f32 (TF32 off) and bf16, a repeat call's bits equal the first's, each
    call on the route ``bwd_route`` names; times as phase 3's (library:
    SDPA's backward through autograd, the same boolean mask,
    ``enable_gqa``): (i) in bf16 (the tensor cores) and f32 (the CUDA
    cores), (ii) in bf16 (the vector route at head dim 128, the row route
    at trained_ckpt's 48)."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import qk_rope_kv as qk
    flash_attention_bwd = fa.flash_attention_bwd
    flash_attention_bwd_plain = fa.flash_attention_bwd_plain
    qk_rope_bwd = qk.qk_rope_bwd
    rows = {"flash_attention_bwd": [], "qk_rope_bwd": []}

    def routed(kernel, fn, want):
        before = dict(kernel.route_launches)
        out = fn()
        got = {r: n - before[r] for r, n in kernel.route_launches.items()}
        if got != {**{r: 0 for r in got}, want: 1}:
            raise AssertionError(f"{kernel.__name__}: routes {got}, want "
                                 f"{want}")
        return out

    def parity(kernel, label, dt, got, again, want):
        tol = TOL[dt]
        errs = []
        for a, a2, w in zip(got, again, want):
            if a.dtype != dt or not torch.equal(a, a2):
                raise AssertionError(f"{kernel} {label}: dtype {a.dtype} or "
                                     f"a repeat call's bits differ")
            scale = max(float(w.float().abs().max()), 1e-6)
            errs.append(float((a.float() - w.float()).abs().max()) / scale)
        err = max(errs)
        log(f"[parity] {kernel} {label} {str(dt)[6:]}: max error "
            f"{err:.3e} of each gradient's largest magnitude (bound {tol:g});"
            f" repeat bits equal")
        if not err <= tol:
            raise AssertionError(f"{kernel} {label}: error {err} above {tol}")
        return err

    for dt in (torch.float32, torch.bfloat16):
        for label, args, kw, sdpa, nbytes, flops in \
                flash_bwd_cases(ts, dt, dev):
            def run(args=args, kw=kw):
                return flash_attention_bwd(*args, **kw)

            def plain(args=args, kw=kw):
                return flash_attention_bwd_plain(*args, **kw)

            route = fa.bwd_route(dt, args[0].shape[-1])
            got, again = (routed(flash_attention_bwd, run, route)
                          for _ in range(2))
            want = plain()
            torch.cuda.synchronize()
            err = parity("flash_attention_bwd", label, dt, got, again, want)
            rows["flash_attention_bwd"].append(train_time_row(
                label, dt, route, err, run, plain, sdpa, nbytes, flops,
                card))
        for label, args, plain, nbytes, flops in qk_bwd_cases(ts, dt, dev):
            def run(args=args):
                return qk_rope_bwd(*args)

            route = qk.bwd_route(dt, args[2].shape[-1])
            got, again = (routed(qk_rope_bwd, run, route) for _ in range(2))
            want = plain()
            torch.cuda.synchronize()
            err = parity("qk_rope_bwd", label, dt, got, again, want)
            if dt == torch.bfloat16:
                rows["qk_rope_bwd"].append(train_time_row(
                    label, dt, route, err, run, plain, None, nbytes, flops,
                    card))
    return rows


def train_counter():
    """Counters of the training path's four kernels, and of the backward
    kernels' routes, set to 0."""
    from qwen3_asr_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_bwd)
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import (qk_rope_bwd,
                                                    qk_rope_kv_write)
    wrappers = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "qk_rope_kv": qk_rope_kv_write, "qk_rope_bwd": qk_rope_bwd}
    for w in wrappers.values():
        w.launches = 0
    for w in (flash_attention_bwd, qk_rope_bwd):
        w.route_launches.update((r, 0) for r in w.route_launches)
    return lambda: {**{k: w.launches for k, w in wrappers.items()},
                    **{f"{k}:{r}": n for k in ("flash_attention_bwd",
                                                 "qk_rope_bwd")
                       for r, n in wrappers[k].route_launches.items()}}


def train_launch_check(name: str, got: dict, cfg, steps: int,
                       dtype: torch.dtype) -> None:
    """Each step launches flash forward and backward once an encoder and a
    decoder layer, kernel B and kernel (ii) once a decoder layer, the
    backward kernels on the routes the dtype and head dims pick."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import qk_rope_kv as qk
    enc, dec = cfg.encoder.encoder_layers, cfg.decoder.num_hidden_layers
    want = {"flash_attention": steps * (enc + dec),
            "flash_attention_bwd": steps * (enc + dec),
            "qk_rope_kv": steps * dec, "qk_rope_bwd": steps * dec}
    routes = collections.Counter()
    routes[f"flash_attention_bwd:"
           f"{fa.bwd_route(dtype, cfg.encoder.head_dim)}"] += steps * enc
    routes[f"flash_attention_bwd:"
           f"{fa.bwd_route(dtype, cfg.decoder.head_dim)}"] += steps * dec
    routes[f"qk_rope_bwd:{qk.bwd_route(dtype, cfg.decoder.head_dim)}"] += \
        steps * dec
    want.update({k: routes.get(k, 0) for k in got if ":" in k})
    log(f"[train] {name}: launches in {steps} step(s) {got} (want {want})")
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want}")


def train_items(clips, lang: bool = True):
    """Manifest rows of the real clips (their transcripts and language)."""
    items = []
    for path in clips:
        with open(path[:-4] + ".txt", encoding="utf-8") as f:
            item = {"wav": path, "text": f.read().strip()}
        lang_f = path[:-4] + ".lang"
        if lang and os.path.exists(lang_f):
            with open(lang_f, encoding="utf-8") as f:
                item["language"] = f.read().strip()
        items.append(item)
    return items


def train_f32_phase(dev, card) -> dict:
    """Phase 18 (b): trained_ckpt in f32, three train steps on a
    make_batch of the 12 real clips, card against CPU; the gradient
    reaches every leaf of both towers; the trained weights saved, served
    from the card and the CPU with the same ids."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.checkpoint import save_asr_checkpoint
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.runtime.optim import adamw
    from qwen3_asr_tpu_torch.runtime.train import (_value_and_grad, asr_loss,
                                                   batch_to,
                                                   init_train_state,
                                                   make_train_step)
    from qwen3_asr_tpu_torch.tools.finetune import make_batch
    ckpt = os.path.join(DATA, "trained_ckpt")
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))
    engines = {"cuda": load_engine(ckpt, device=dev, dtype=torch.float32),
               "cpu": load_engine(ckpt, device="cpu")}
    batch = make_batch(engines["cpu"], train_items(clips), TRAIN_BUCKET_S)
    log(f"[train] trained_ckpt f32: batch of {len(clips)} clips, "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))
    cfg = engines["cuda"].model.cfg

    # every gradient leaf of both towers on the card (the encoder's key
    # bias: 0 in exact arithmetic, softmax ignoring a per-row constant)
    tb = batch_to(batch, dev)
    loss, grads = _value_and_grad(
        asr_loss, engines["cuda"].model.params, cfg, tb["mel"],
        tb["feature_lens"], tb["prompt_ids"], tb["target_ids"],
        tb["target_mask"], tb["valid_from"])
    zero = []
    for tower in ("encoder", "decoder"):
        for key, g in _flat(grads[tower]):
            if not bool(g.ne(0).any()):
                zero.append(f"{tower}/{key}")
    log(f"[train] trained_ckpt f32 on the card: loss {float(loss):.6f}, "
        f"gradient leaves with no non-zero element: {zero or 'none'}")
    if zero not in ([], ["encoder/layers/bk"]):
        raise AssertionError(f"no gradient reached {zero}")

    losses, states, launched = {}, {}, None
    for where, eng in engines.items():
        opt = adamw(TRAIN_LR)
        state = init_train_state(eng.model.params, opt)
        step = make_train_step(cfg, opt)
        read = train_counter()
        losses[where] = []
        for _ in range(TRAIN_STEPS):
            state, loss = step(state, batch)
            losses[where].append(float(loss))
        if where == "cuda":
            torch.cuda.synchronize()
            launched = read()
        states[where] = state
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    log(f"[train] trained_ckpt f32, {TRAIN_STEPS} steps at lr {TRAIN_LR:g}:"
        f" losses card {losses['cuda']} / CPU {losses['cpu']}, largest "
        f"relative difference {rel:.2e} (bound {TRAIN_TOL:g}) | {card}")
    if not rel <= TRAIN_TOL:
        raise AssertionError(f"train losses differ by {rel:.2e}")
    train_launch_check("trained_ckpt f32", launched, cfg, TRAIN_STEPS,
                       torch.float32)

    # the train -> serve loop: save, load, transcribe english_01
    root = tempfile.mkdtemp(prefix="smoke_train_")
    try:
        ids = {}
        for where, state in states.items():
            out = os.path.join(root, where)
            save_asr_checkpoint(out, cfg, state.params)
            shutil.copy(os.path.join(ckpt, "tokenizer.json"), out)
            served = load_engine(out, device=dev if where == "cuda"
                                 else "cpu",
                                 dtype=torch.float32)
            with open(os.path.join(DATA, "real", "english_01.wav"),
                      "rb") as f:
                res = served.transcribe(*decode_audio(f.read()))[0]
            ids[where] = res.token_ids
            log(f"[train] saved after {TRAIN_STEPS} steps ({where}), served "
                f"on the {'card' if where == 'cuda' else 'CPU'}: "
                f"english_01 {res.text!r}")
            del served
        if ids["cuda"] != ids["cpu"]:
            raise AssertionError(f"trained checkpoint's ids: card "
                                 f"{ids['cuda']} vs CPU {ids['cpu']}")
        log(f"[train] the card's saved checkpoint gives the CPU's "
            f"{len(ids['cuda'])} token ids")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launched


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def train_bf16_phase(dev, card) -> dict:
    """Phase 18 (c): preset:1.7b at full width in bf16 with seeded random
    weights (``init_*_params``; ``preset:`` serves zeros, whose gradients
    vanish) and its byte tokenizer, B=8 real clips at the 6 s bucket:
    ms a step (median of 3 after one warm step), the loss finite, peak
    memory, launches a step by kernel."""
    from qwen3_asr_tpu_torch.runtime.optim import adamw
    from qwen3_asr_tpu_torch.runtime.train import (init_train_state,
                                                   make_train_step)
    from qwen3_asr_tpu_torch.tools.finetune import make_batch
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))
    engine = full_width_engine(dev)
    cfg = engine.model.cfg
    batch = make_batch(engine, train_items(clips[:TRAIN_BATCH]),
                       TRAIN_BUCKET_S)
    log(f"[train] preset:1.7b bf16: batch "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))
    opt = adamw(TRAIN_LR)
    state = init_train_state(engine.model.params, opt)
    step = make_train_step(cfg, opt)
    state, loss = step(state, batch)          # the warm step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, losses, launched = [], [float(loss)], {}
    for _ in range(TRAIN_STEPS):
        read = train_counter()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))            # synchronizes
        walls.append((time.perf_counter() - t0) * 1e3)
        for k, n in read().items():
            launched[k] = launched.get(k, 0) + n
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"preset:1.7b bf16 losses {losses}")
    train_launch_check("preset:1.7b bf16", launched, cfg, TRAIN_STEPS,
                       torch.bfloat16)
    log(f"[train] preset:1.7b bf16, B={TRAIN_BATCH} at the "
        f"{TRAIN_BUCKET_S:g} s bucket: ms a step {sorted(walls)} (median "
        f"{float(np.median(walls)):.1f}), losses {losses} (finite), peak "
        f"memory {peak:.2f} GiB; launches a step "
        f"{ {k: n // TRAIN_STEPS for k, n in launched.items()} } | {card}")
    train_step_profile(step, state, batch, card)
    del state, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# kernel name fragments -> the parts of a training step
STEP_PARTS = (("flash backward (i)", ("dq_kernel", "dkv_kernel")),
              ("flash forward (#1)", ("flash_bf16_kernel", "flash_f32")),
              ("QK-norm + RoPE (B, ii)", ("qk_rope", "norm_grad")),
              ("GEMM", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
              ("convolution", ("conv", "cudnn", "implicit")))


def train_step_profile(step, state, batch, card) -> None:
    """One more step under ``torch.profiler`` (CUDA activity only): device
    busy share, device ms by part of the step, the top kernels."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        _, loss = step(state, batch)
        float(loss)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    parts = collections.Counter()
    for e in events:
        name = e.key.lower()
        part = next((p for p, keys in STEP_PARTS
                     if any(k in name for k in keys)), "other")
        parts[part] += e.device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    log(f"[train] one preset:1.7b bf16 step under the profiler: device busy "
        f"{busy:.1f} ms of {wall:.1f} ms wall ({busy / wall:.1%}); by part "
        + ", ".join(f"{p} {ms:.1f} ms" for p, ms in parts.most_common())
        + "; top kernels " + "; ".join(
            f"{e.key[:60]} {e.device_time_total / 1e3:.2f} ms / {e.count}"
            for e in top) + f" | {card}")


def finetune_cli_phase(card) -> None:
    """Phase 18 (d): ``python -m qwen3_asr_tpu_torch.tools.finetune`` on
    the card, 2 steps on a manifest of 4 real clips, its checkpoint
    written."""
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))[:4]
    root = tempfile.mkdtemp(prefix="smoke_finetune_")
    try:
        manifest = os.path.join(root, "manifest.jsonl")
        with open(manifest, "w", encoding="utf-8") as f:
            for item in train_items(clips):
                f.write(json.dumps(item) + "\n")
        out = os.path.join(root, "out")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "qwen3_asr_tpu_torch.tools.finetune",
             "--model-id", os.path.join(DATA, "trained_ckpt"),
             "--manifest", manifest, "--steps", "2", "--batch-size", "4",
             "--output", out], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        steps = [ln for ln in proc.stderr.splitlines() + proc.stdout
                 .splitlines() if '"step ' in ln or "| loss" in ln]
        log(f"[train] finetune CLI: exit {proc.returncode} in "
            f"{time.time() - t0:.1f} s; " + " / ".join(
                json.loads(s)["message"] if s.startswith("{") else s
                for s in steps))
        if proc.returncode != 0 or not all(
                os.path.exists(os.path.join(out, n))
                for n in ("model.safetensors", "config.json",
                          "tokenizer.json")) or len(steps) != 2:
            raise AssertionError(f"finetune CLI failed:\n{proc.stderr[-3000:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_phase(dev) -> tuple:
    """Phase 18: training on the card. Returns the kernel rows of (a) and
    the launches of (b) and (c), each counted from 0 just before it."""
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[train] card memory in use at the start: "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB")
    rows = train_kernel_rows(train_shapes(), dev, card)
    launched = train_f32_phase(dev, card)
    for k, n in train_bf16_phase(dev, card).items():
        launched[k] += n
    finetune_cli_phase(card)
    return rows, launched


# name -> (source, TPU kernel it replaces, headline shape)
# -- phase 19 ----------------------------------------------------------------------

TOOLS_LONG_S = 45.0        # (a): the long-form file
TOOLS_BATCH = 8            # (a): the clips of one batch, 9.5 s each
EXPORT_BUCKET_S = 6.0      # (b): the exported encoder's bucket
VAD_STEPS = 1500           # (c): train_vad's default, not cut
OVERFIT_STEPS = 31         # (d): the overfit CLI's steps (its cosine
                           # decay needs more than its 30 warmup steps)
BOOT_ENV = {"QUANTIZE": "int8", "ASR_KV_CACHE_DTYPE": "int4"}   # (f)


@contextlib.contextmanager
def cli_engines():
    """The engines ``load_engine`` builds meanwhile (a CLI builds its own),
    each with a ``PathLaunches`` made as it is built, and the token ids
    every ``transcribe``/``transcribe_batch`` result carries."""
    from qwen3_asr_tpu_torch.runtime import lifecycle
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    real_load = lifecycle.load_engine
    real_batch = TranscriptionEngine.transcribe_batch
    got = {"engines": [], "ids": []}

    def load(*a, **k):
        eng = real_load(*a, **k)
        got["engines"].append((eng, PathLaunches(eng)))
        return eng

    def batch(self, clips, language=None):
        out = real_batch(self, clips, language)
        got["ids"] += [r.token_ids for r in out]
        return out

    lifecycle.load_engine = load
    TranscriptionEngine.transcribe_batch = batch
    try:
        yield got
    finally:
        lifecycle.load_engine = real_load
        TranscriptionEngine.transcribe_batch = real_batch


def cli_run(main, argv) -> tuple:
    """(exit code, stdout, stderr, wall s) of a CLI's ``main(argv)`` run in
    this process."""
    import io
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def summary_rt(err: str) -> float:
    """The transcribe CLI's audio seconds a wall second (its summary)."""
    m = re.search(r"\(([0-9.]+)x RT\)", err)
    if not m:
        raise AssertionError(f"no summary line in the CLI's stderr: {err}")
    return float(m.group(1))


def transcribe_cli_phase(real, tmp: str, card: str) -> dict:
    """(a): the offline CLI on trained_ckpt f32 (phase 4's answers and
    ids), with accurate SRTs, and on preset:1.7b bf16 (long-form, B=8,
    B=1). Returns the launches of the preset:1.7b call."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.sidecars import subtitle
    from qwen3_asr_tpu_torch.tools import transcribe
    _, _, wants, ids = real
    ckpt = os.path.join(DATA, "trained_ckpt")
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))
    with cli_engines() as got:
        rc, out, err, wall = cli_run(transcribe.main, clips + [
            "--model", ckpt, "--json", "--dtype", "float32"])
    records = [json.loads(line) for line in out.splitlines()]
    (engine, counter), = got["engines"]
    launches, _ = counter.read()
    if (rc != 0 or [r["file"] for r in records] != clips
            or [{"text": r["text"], "language": r["language"]}
                for r in records] != wants
            or sorted(got["ids"]) != sorted(ids)):
        raise AssertionError(f"transcribe CLI on trained_ckpt: rc {rc}, "
                             f"{records} against phase 4's {wants}")
    log(f"[tools] (a) transcribe CLI, trained_ckpt f32, {len(clips)} clips "
        f"in one call: records equal to phase 4's server answers, token ids "
        f"equal to phase 4's; {len(engine.executables)} keys; "
        f"{summary_rt(err):.1f} s of audio a wall second ({wall:.2f} s with "
        f"the load); launches {launches} | {card}")
    saved = subtitle.FORCED_ALIGNER_ID
    subtitle.FORCED_ALIGNER_ID = ckpt
    try:
        rc, out, err, wall = cli_run(transcribe.main, clips + [
            "--model", ckpt, "--json", "--dtype", "float32", "--srt",
            "--srt-mode", "accurate", "--output-dir",
            os.path.join(tmp, "srt")])
    finally:
        subtitle.unload_aligner()
        subtitle.FORCED_ALIGNER_ID = saved
    records = [json.loads(line) for line in out.splitlines()]
    events = []
    for r in records:
        with open(r["srt"]) as f:
            events.append(f.read().count("-->"))
    if rc != 0 or len(records) != len(clips) or min(events) < 1:
        raise AssertionError(f"accurate SRTs: rc {rc}, events {events}")
    log(f"[tools] (a) the same with --srt --srt-mode accurate "
        f"(FORCED_ALIGNER_ID=trained_ckpt): {sum(events)} subtitle events "
        f"in {len(records)} files, {wall:.2f} s | {card}")

    audio = real_audio()
    seg = int(9.5 * 16000)
    files = [os.path.join(tmp, "long_45s.wav"), os.path.join(tmp, "solo_5s.wav")]
    with open(files[0], "wb") as f:
        f.write(encode_wav(audio[:int(TOOLS_LONG_S * 16000)], 16000))
    with open(files[1], "wb") as f:
        f.write(encode_wav(audio[-5 * 16000:], 16000))
    for i in range(TOOLS_BATCH):
        files.append(os.path.join(tmp, f"clip_{i}.wav"))
        with open(files[-1], "wb") as f:
            f.write(encode_wav(audio[i * seg:(i + 1) * seg], 16000))
    with environ(SKIP_WARMUP="true"), cli_engines() as got:
        rc, out, err, wall = cli_run(transcribe.main, files + [
            "--model", "preset:1.7b", "--json"])
    (engine, counter), = got["engines"]
    launches, eager = counter.read()
    records = [json.loads(line) for line in out.splitlines()]
    audio_s = TOOLS_LONG_S + 5.0 + TOOLS_BATCH * 9.5
    log(f"[tools] (a) transcribe CLI, preset:1.7b bf16: a {TOOLS_LONG_S:g} s "
        f"file, a 5 s clip and {TOOLS_BATCH} clips of 9.5 s in one call: "
        f"{summary_rt(err):.1f} s of audio a wall second of inference "
        f"({audio_s / wall:.1f} with the load, {wall:.2f} s); keys "
        f"{sorted(k[:3] for k in engine.executables)}; launches #1 "
        f"{launches['flash_attention']}, #2 {launches['decode_attention']}, "
        f"#3 {launches['decode_attention_batch']} (eager {eager}) | {card}")
    if (rc != 0 or len(records) != len(files)
            or not all(isinstance(r["text"], str) for r in records)
            or not all(launches[k] for k in ("flash_attention",
                                             "decode_attention",
                                             "decode_attention_batch"))):
        raise AssertionError(f"transcribe CLI on preset:1.7b: rc {rc}, "
                             f"launches {launches}")
    return launches


def export_phase(dev, tmp: str, card: str) -> tuple:
    """(b): the preset:1.7b bf16 encoder exported at the 6 s bucket, then
    the kernels a decode step records at phase 7's key. Returns the flash
    launches of the program's runs and the engine (for (e))."""
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.tools.export_encoder import (bucket_mel_frames,
                                                          export_program,
                                                          flash_nodes,
                                                          load_encoder)
    engine = load_engine("preset:1.7b", device=dev)
    cfg = engine.model.cfg.encoder
    frames = bucket_mel_frames(cfg, EXPORT_BUCKET_S)
    t0 = time.perf_counter()
    program = export_program(engine.model.params["encoder"], cfg, 1, frames,
                             torch.bfloat16, dev)
    export_s = time.perf_counter() - t0
    names = [str(n.target) for n in program.graph.nodes]
    nodes = flash_nodes(program)
    sdpa = [n for n in names if "scaled_dot_product" in n]
    gen = torch.Generator(device=dev).manual_seed(19)
    mel = torch.randn((1, cfg.num_mel_bins, frames), generator=gen,
                      device=dev).to(torch.bfloat16)
    lens = torch.tensor([frames - 37], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        want, want_lens = encoder_forward(engine.model.params["encoder"],
                                          cfg, mel, lens)
    flash_attention.launches = 0
    got, got_lens = program.module()(mel, lens)
    torch.cuda.synchronize()
    launched = flash_attention.launches
    path = os.path.join(tmp, "encoder.pt2")
    t0 = time.perf_counter()
    torch.export.save(program, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = load_encoder(path)
    load_s = time.perf_counter() - t0
    got2 = again.module()(mel, lens)[0]
    torch.cuda.synchronize()
    launched2 = flash_attention.launches - launched
    layers = cfg.encoder_layers
    log(f"[tools] (b) encoder export, preset:1.7b bf16 at the "
        f"{EXPORT_BUCKET_S:g} s bucket ({frames} mel frames): {export_s:.1f} "
        f"s, {len(names)} nodes, {nodes} of the flash operator, SDPA nodes "
        f"{len(sdpa)}; the program's output equal to the eager encoder: "
        f"{torch.equal(got, want) and torch.equal(got_lens, want_lens)}, "
        f"flash launches {launched}; saved {os.path.getsize(path) / 2**20:.0f}"
        f" MiB in {save_s:.1f} s, loaded in {load_s:.1f} s, equal again: "
        f"{torch.equal(got2, want)} ({launched2} launches) | {card}")
    if (nodes != layers or sdpa or not torch.equal(got, want)
            or not torch.equal(got_lens, want_lens)
            or not torch.equal(got2, want) or launched != layers
            or launched2 != layers):
        raise AssertionError("the exported encoder does not hold the flash "
                             "operator or differs from the eager encoder")
    del program, again, got, got2
    os.remove(path)
    # phase 7's key with the operator registered: the same kernels a step
    long = real_audio()[:int(29.5 * 16000)]
    engine.transcribe(long, 16000)
    run = engine.last_run
    exe = next(x for key, x in engine.executables.items()
               if key[0] == run["bucket_frames"] and key[2] == 1
               and not x.resume)
    nodes = (exe.front.nodes, exe.chunk.nodes)
    want = MEASURED.get("phase 7 graph nodes")
    log(f"[tools] (b) phase 7's key (30 s, B=1, bf16 KV) with the flash "
        f"operator registered: graph nodes (front, chunk) {nodes}, phase 7's "
        f"{want} | {card}")
    if want is not None and nodes != want:
        raise AssertionError(f"the key's graphs hold {nodes} nodes against "
                             f"phase 7's {want}")
    return 2 * layers, engine


def vad_train_phase(dev, tmp: str, card: str) -> None:
    """(c): ``tools/train_vad.py`` on the card, beside the committed
    weights through the same ``evaluate()``."""
    import hashlib
    from qwen3_asr_tpu_torch.audio import vad_model
    from qwen3_asr_tpu_torch.tools import train_vad
    data = os.path.join(DATA, "real")
    digest = hashlib.sha256(open(vad_model.WEIGHTS_PATH, "rb").read()
                            ).hexdigest()
    saved = {k: os.environ.get(k) for k in ("ASR_VAD", "ASR_VAD_WEIGHTS")}
    try:
        t0 = time.perf_counter()
        windows, labels, names, _ = train_vad.build_dataset(data)
        feats = train_vad.featurize_windows(windows, dev)
        data_s = time.perf_counter() - t0
        params = train_vad.init_params(0, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = train_vad.train(params, feats, labels, VAD_STEPS,
                                         3e-3, 0, log_every=0)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        params, offset, _, fp, fn = train_vad.calibrate(params, feats, labels)
        out = os.path.join(tmp, "vad.npz")
        train_vad.save_params(params, out)
        ours = train_vad.report(data, out, dev, names, fp, fn)
        committed = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                     for k, v in vad_model.load_params(
                         vad_model.WEIGHTS_PATH).items()}
        c_fp, c_fn = train_vad.error_rates(committed, feats, labels)
        theirs = train_vad.report(data, vad_model.WEIGHTS_PATH, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        vad_model._read.cache_clear()
        vad_model._model.cache_clear()
    loss = [float(x) for x in losses[::300]] + [float(losses[-1])]
    held = {k: ours["flap_table"][k]["flap_rate"] for k in train_vad.HELD_OUT}
    c_held = {k: theirs["flap_table"][k]["flap_rate"]
              for k in train_vad.HELD_OUT}
    log(f"[tools] (c) train_vad on the card: {len(labels)} windows "
        f"({int(labels.sum())} speech) built and featurized in {data_s:.1f} "
        f"s, {VAD_STEPS} steps in {train_s:.1f} s "
        f"({1e3 * train_s / VAD_STEPS:.2f} ms a step), loss {loss}; "
        f"boundary offset {offset:+.2f}; "
        f"train FP {fp:.4f} / FN {fn:.4f} (committed weights {c_fp:.4f} / "
        f"{c_fn:.4f} at their own boundary); worst flap {ours['worst_flap_rate']}"
        f" (committed {theirs['worst_flap_rate']}); held out {held} "
        f"(committed {c_held}) | {card}")
    if hashlib.sha256(open(vad_model.WEIGHTS_PATH, "rb").read()
                      ).hexdigest() != digest:
        raise AssertionError("train_vad wrote the committed weights")
    if not all(np.isfinite(loss)) or loss[-1] >= loss[0]:
        raise AssertionError(f"train_vad's loss did not fall: {loss}")


def bpe_overfit_phase(tmp: str, card: str) -> None:
    """(d): the BPE trainer on the card's host, then the overfit CLI
    without ``--tokenizer``."""
    from qwen3_asr_tpu_torch.tools import overfit
    real = os.path.join(DATA, "real")
    texts = [open(p, encoding="utf-8").read().strip()
             for p in sorted(glob.glob(os.path.join(real, "*.txt")))]
    path = os.path.join(tmp, "tokenizer.json")
    t0 = time.perf_counter()
    overfit.build_tokenizer(texts, path)
    bpe_s = time.perf_counter() - t0
    with open(path, encoding="utf-8") as f, open(os.path.join(
            DATA, "trained_ckpt", "tokenizer.json"), encoding="utf-8") as g:
        ours, theirs = f.read(), g.read()
    merges = len(json.loads(ours)["model"]["merges"])
    log(f"[tools] (d) BPE trainer on {len(texts)} transcripts: {merges} "
        f"merges in {bpe_s:.3f} s, trained_ckpt/tokenizer.json byte for "
        f"byte: {ours == theirs} | {card}")
    if ours != theirs or merges != 850:
        raise AssertionError("the BPE trainer did not reproduce "
                             "trained_ckpt/tokenizer.json")
    data = os.path.join(tmp, "overfit_data")
    os.makedirs(data)
    for name in ("english_01", "chinese_02"):
        for ext in (".wav", ".txt", ".lang"):
            if os.path.exists(os.path.join(real, name + ext)):
                shutil.copy(os.path.join(real, name + ext), data)
    out = os.path.join(tmp, "overfit_out")
    t0 = time.perf_counter()
    overfit.main(["--data-dir", data, "--output", out, "--size", "base",
                  "--max-steps", str(OVERFIT_STEPS), "--eval-every", "1000",
                  "--device", "cuda"])
    with open(os.path.join(out, "overfit_manifest.json")) as f:
        manifest = json.load(f)
    log(f"[tools] (d) overfit CLI without --tokenizer, --size base, 2 clips, "
        f"{OVERFIT_STEPS} steps on the card: {time.perf_counter() - t0:.1f} s"
        f", {manifest['n_params']} parameters, exact {manifest['exact']}/"
        f"{manifest['total_strict']} | {card}")


def roofline_phase(engine, card: str) -> None:
    """(e): the analytic cost and the shares of phases 5 and 6."""
    from qwen3_asr_tpu_torch.runtime.roofline import analytic_cost, utilization
    for name in ("phase 5, 30 s upload at B=1",
                 "phase 6, 8 uploads at B=8, bf16 KV"):
        if name not in MEASURED:
            log(f"[tools] (e) {name}: not measured in this run")
            continue
        wall, run = MEASURED[name]
        frames = run["bucket_frames"]
        cost = analytic_cost(engine, run["batch"], frames, frames / 100.0)
        shares = utilization(cost, wall)
        log(f"[tools] (e) roofline, {name}: {cost.as_dict()}; wall {wall:.3f}"
            f" s: mfu {shares['mfu']:.4f}, hbm_util {shares['hbm_util']:.4f} "
            f"(of 989 TFLOP/s and 3.35 TB/s) | {card}")


def boot_run(cache: str, build: Optional[str] = None) -> dict:
    """One boot (``tools_perf/boot.py``) in a process of its own, with the
    boot cache ``cache``, into the build directory ``build`` (the
    package's ``_build/`` when None)."""
    env = dict(os.environ, ASR_AOT_CACHE_DIR=cache, **BOOT_ENV)
    env.pop("ASR_WARMUP_BUCKETS", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_asr_tpu_torch.tools_perf.boot"]
        + (["--build-dir", build] if build else []),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"boot failed: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def boot_line(name: str, b: dict, card: str) -> None:
    log(f"[boot] {name} ({b['quantize']} weights, {b['kv']} KV, build "
        f"directory empty: {b['build_dir_empty']}, compiler processes "
        f"{b['compiler_runs']}): {b['process_s']:.1f} s of process, "
        f"{b['total_s']:.1f} s from import to the first answer; by part "
        f"{json.dumps(b['parts'])} | {card}")


def cold_boot(cache: str, card: str) -> dict:
    """Phase 1: a cold boot into an empty boot cache, whose build of every
    kernel (``nvcc``, into the package's ``_build/``: empty in a fresh
    checkout) is the build the later phases load."""
    cold = boot_run(cache)
    boot_line("cold, phase 1", cold, card)
    return cold


def boot_phase(cache: str, cold: dict, card: str) -> None:
    """(f): a boot from the cache phase 1's cold boot filled, into an
    empty build directory."""
    warm = boot_run(cache, os.path.join(cache, "build_warm"))
    boot_line("from the cache", warm, card)
    saved = cold["process_s"] - warm["process_s"]
    log(f"[boot] saved by the cache: {saved:.1f} s of process (the build "
        f"{cold['parts']['build_s'] - warm['parts']['build_s']:.1f} s); "
        f"token ids equal to the cold boot's: "
        f"{cold['token_ids'] == warm['token_ids']} | {card}")
    if (cold["token_ids"] != warm["token_ids"] or not warm["build_dir_empty"]
            or warm["compiler_runs"]
            or (cold["build_dir_empty"] and not cold["compiler_runs"])):
        raise AssertionError("the boot from the cache differs from the cold "
                             "boot, or compiled again")


def tools_phase(dev, real, boot_cache: str, cold: dict) -> dict:
    """Phase 19 (docstring). Returns its launches of #1, #2 and #3."""
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="smoke_tools_") as tmp:
        launches = transcribe_cli_phase(real, tmp, card)
        flash, engine = export_phase(dev, tmp, card)
        launches["flash_attention"] += flash
        roofline_phase(engine, card)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        vad_train_phase(dev, tmp, card)
        bpe_overfit_phase(tmp, card)
        boot_phase(boot_cache, cold, card)
    return launches


KERNELS = {
    "flash_attention": ("qwen3_asr_tpu_torch/csrc/flash_attention.cu",
                        "qwen3_asr_tpu/ops/flash_attention.py:39",
                        "prefill_30s_b1"),
    "decode_attention": ("qwen3_asr_tpu_torch/csrc/decode_attention.cu",
                         "qwen3_asr_tpu/ops/decode_attention.py:39",
                         "decode_step_b1"),
    "decode_attention_batch": (
        "qwen3_asr_tpu_torch/csrc/decode_attention_batch.cu",
        "qwen3_asr_tpu/ops/decode_attention_batch.py:62",
        "batched_b8_s768_bf16"),
    "slab_reader": ("qwen3_asr_tpu_torch/csrc/slab_reader.cu",
                    "tools_perf/attn_phase.py:108",
                    "engine_b8_s768_bf16"),
    # kernels of the default configuration with no TPU kernel behind them:
    # "replaces" names the XLA code they stand in for
    "decode_attention_batch_int4": (
        "qwen3_asr_tpu_torch/csrc/decode_attention_batch.cu",
        "qwen3_asr_tpu/ops/attention.py:156", "int4_b8_s768"),
    "qgemv": ("qwen3_asr_tpu_torch/csrc/qgemv.cu",
              "qwen3_asr_tpu/ops/quant.py:134", "lm_head_m1_int8"),
    "qgemm": ("qwen3_asr_tpu_torch/csrc/qgemm.cu",
              "qwen3_asr_tpu/ops/quant.py:134", "gate_up_group_m453_int4"),
    "qk_rope_kv": ("qwen3_asr_tpu_torch/csrc/qk_rope_kv.cu",
                   "qwen3_asr_tpu/models/decoder.py:146,163,132,258",
                   "qk_b8_t1_int4"),
    # the training path's backward kernels (phase 18)
    "flash_attention_bwd": ("qwen3_asr_tpu_torch/csrc/flash_attention_bwd.cu",
                            "qwen3_asr_tpu/ops/flash_attention.py:186",
                            "train_causal_b8_6s"),
    "qk_rope_bwd": ("qwen3_asr_tpu_torch/csrc/qk_rope_bwd.cu",
                    "qwen3_asr_tpu/models/decoder.py:146,163",
                    "qk_bwd_b8_6s"),
    # (i)'s route with cotangents on m and l (phase 20)
    "flash_attention_bwd_ml": (
        "qwen3_asr_tpu_torch/csrc/flash_attention_bwd_ml.cu",
        "qwen3_asr_tpu/ops/flash_attention.py:186", "train_causal_b8_6s_ml"),
}
NO_TPU_KERNEL = {"decode_attention_batch_int4": "XLA attend_xla, int4",
                 "qgemv": "XLA qdot",
                 "qgemm": "XLA qdot",
                 "qk_rope_kv": "XLA rms_norm + apply_rope + _kv_quantize + "
                               "dynamic_update_slice",
                 "flash_attention_bwd": "XLA's vjp of _xla_forward, the "
                                        "custom VJP of #1",
                 "qk_rope_bwd": "XLA's autodiff of rms_norm + apply_rope",
                 "flash_attention_bwd_ml": "XLA's vjp of _xla_forward with "
                                           "cotangents on out, m and l"}
TRAIN_KERNELS = ("flash_attention_bwd", "qk_rope_bwd")


# -- phase 20 ----------------------------------------------------------------------

ML_KERNEL = "flash_attention_bwd_ml"   # kernel (i)'s route with m/l cotangents
CP_SHARDS = 4              # (b): the shards folded onto the card
CP_VALID_FROM = 20         # (b): the left padding of the prompt's row
PAR_LR = 1e-3              # (c): the train steps' learning rate
PAR_TOL = 1e-4             # (c): weights after a step, absolute (lr / 10)


def ml_cotangent_cases(ts, dtype, dev):
    """(label, args, kw, dm, dl, bytes, flops) of kernel (i)'s m/l route:
    the encoder's 6 s windows (B=8), the training forward's causal shape
    (B=8, prompt from 12) and that shape with keys 40, 80 and 120 copies of
    key 20 (rows tie at their maximum); the cotangents of JAX's residual
    loss sum(out²) + 1e-3·sum(m) + sum(log l): dout = 2 out, dm = 1e-3,
    dl = 1/l on rows with a live key."""
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    out = []
    for label, args, kw, _, nbytes, flops in flash_bwd_cases(ts, dtype, dev):
        if label == "encoder_30s_b1":
            continue
        tied = [False, True] if label.startswith("train") else [False]
        for tie in tied:
            q, k, v, _, _, _, vf, vt, zero = args
            if tie:
                k = k.clone()
                for c in (40, 80, 120):
                    k[:, :, c] = k[:, :, 20]
            o, m, l = flash_attention(q, k, v, causal=kw["causal"],
                                      kv_valid_from=vf,
                                      window_block=kw["window_block"],
                                      return_residuals=True)
            dm = torch.full_like(m, 1e-3)
            dl = torch.where(l > 0, 1.0 / torch.clamp(l, min=1e-30),
                             torch.zeros_like(l))
            # (i)'s bytes and the two cotangents; the same products
            out.append((label + ("_ml_tied" if tie else "_ml"),
                        (q, k, v, (2 * o.float()).to(dtype), m, l, vf, vt,
                         zero), kw, dm, dl, nbytes + 2 * m.numel() * 4,
                        flops))
    return out


def ml_route_rows(ts, dev, card) -> list:
    """Phase 20 (a): the m/l route against ``flash_attention_bwd_plain``
    with dm and dl (f32 to 2e-5, bf16 to 2e-2 of each gradient's largest
    magnitude; a repeat call's bits), the tied case's ties counted; device
    ms of the route, of the same call with dm = dl = None, of the plain
    version, beside (i)'s bound. No PyTorch call computes this gradient:
    the library column is null."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    bwd, plain_bwd = fa.flash_attention_bwd, fa.flash_attention_bwd_plain
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for label, args, kw, dm, dl, nbytes, flops in \
                ml_cotangent_cases(ts, dt, dev):
            def run(args=args, kw=kw, dm=dm, dl=dl):
                return bwd(*args, **kw, dm=dm, dl=dl)

            def base(args=args, kw=kw):
                return bwd(*args, **kw)

            def plain(args=args, kw=kw, dm=dm, dl=dl):
                return plain_bwd(*args, **kw, dm=dm, dl=dl)

            before = bwd.ml_launches
            got, again = run(), run()
            torch.cuda.synchronize()
            if bwd.ml_launches != before + 2:
                raise AssertionError(f"{label}: the m/l route launched "
                                     f"{bwd.ml_launches - before} times")
            want = plain()
            errs = []
            for a, a2, w in zip(got, again, want):
                if a.dtype != dt or not torch.equal(a, a2):
                    raise AssertionError(f"{ML_KERNEL} {label}: dtype "
                                         f"{a.dtype} or a repeat call's "
                                         f"bits differ")
                scale = max(float(w.float().abs().max()), 1e-6)
                errs.append(float((a.float() - w.float()).abs().max())
                            / scale)
            err = max(errs)
            if not err <= TOL[dt]:
                raise AssertionError(f"{ML_KERNEL} {label} {dt}: error "
                                     f"{err} above {TOL[dt]}")
            ties = ""
            if "tied" in label:
                q, k, _, _, _, _, vf, vt, zero = args
                s, mask = fa._scores(q, k, vf, vt, zero, kw["causal"], 0,
                                     kw["sm_scale"])
                top = torch.where(mask, s, torch.full_like(s, -torch.inf))
                n = int(((top == top.amax(-1, keepdim=True)).sum(-1) > 1)
                        .sum())
                if not n:
                    raise AssertionError(f"{label}: no row ties")
                ties = f", {n} rows with tied maxima"
            ms, base_ms = per_call_ms(run, 0), per_call_ms(base, 0)
            plain_ms = per_call_ms(plain, 0, PLAIN_ITERS)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / (BF16_FLOPS if dt == torch.bfloat16
                             else F32_FLOPS) * 1e3
            bound = max(t_bytes, t_ops)
            name = str(dt)[6:]
            route = fa.bwd_route(dt, args[0].shape[-1])
            rows.append({
                "shape": label if dt == torch.bfloat16 else f"{label}_{name}",
                "dtype": name, "route": route, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "without_ml_ms": base_ms, "bytes": nbytes, "flops": flops})
            log(f"[parity] {ML_KERNEL} {label} {name}, route {route}: max "
                f"error {err:.3e} of each gradient's largest magnitude "
                f"(bound {TOL[dt]:g}); repeat bits equal{ties}")
            log(f"[timing] {ML_KERNEL} {label} {name} (device): m/l route "
                f"{ms:.4f} ms, the same call with dm = dl = None {base_ms:.4f}"
                f" ms, plain {plain_ms:.4f} ms, no library call; bound "
                f"{bound:.5f} ms ({rows[-1]['bound_by']}), share "
                f"{bound / ms:.3%} | {card}")
    return rows


def ml_path_launches(ts, dev, card) -> dict:
    """Phase 20 (a)'s path: JAX's residual loss differentiated through
    ``flash_attention(..., return_residuals=True)`` (``FlashFunction``) at
    the bf16 cases, counted from 0 just before: the m/l route once a
    call, finite non-zero gradients."""
    from qwen3_asr_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_bwd)
    cases = ml_cotangent_cases(ts, torch.bfloat16, dev)
    flash_attention_bwd.ml_launches = 0
    flash_attention_bwd.route_launches.update(
        (r, 0) for r in flash_attention_bwd.route_launches)
    for label, args, kw, *_ in cases:
        q, k, v, _, _, _, vf, _, _ = args
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        o, m, l = flash_attention(*ins, causal=kw["causal"],
                                  kv_valid_from=vf,
                                  window_block=kw["window_block"],
                                  return_residuals=True)
        loss = ((o.float() ** 2).sum() + 1e-3 * m.sum()
                + torch.log(torch.clamp(l, min=1e-30)).sum())
        for g in torch.autograd.grad(loss, ins):
            if not (bool(torch.isfinite(g).all())
                    and float(g.float().abs().max()) > 0):
                raise AssertionError(f"{label}: bad residual gradient")
    torch.cuda.synchronize()
    got = {ML_KERNEL: flash_attention_bwd.ml_launches,
           **{f"{ML_KERNEL}:{r}": n
              for r, n in flash_attention_bwd.route_launches.items()}}
    log(f"[parallel] residual loss through FlashFunction at "
        f"{[c[0] for c in cases]}: launches {got} | {card}")
    if got[ML_KERNEL] != len(cases):
        raise AssertionError(f"the m/l route launched {got}, want "
                             f"{len(cases)}")
    return got


def cp_rows(dev, card) -> None:
    """Phase 20 (b): context parallelism folded onto the card at
    preset:1.7b's decoder shapes: the 30 s prefill's queries (B=1, 16 heads
    of 128, T = 453) causal at the end of S keys with a left-padded
    ``valid_from``, S = 768 in 4 shards of 192 and S = 3072 in 4 of 768,
    against one flash call over the whole K/V (bf16 2e-2 of the largest
    magnitude, f32 2e-5 at 768); device ms of the 4 shard calls with
    ``combine_stacked`` against the one call."""
    from qwen3_asr_tpu_torch.ops.context_parallel import (
        context_parallel_folded)
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    sh = main_path_shapes()
    t, gen = sh["prompt_len"], torch.Generator(device=dev).manual_seed(20)
    for s_len, dt in ((768, torch.float32), (768, torch.bfloat16),
                      (3072, torch.bfloat16)):
        q = torch.randn((1, 16, t, 128), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((1, 8, s_len, 128), generator=gen,
                            device=dev).to(dt) for _ in range(2))
        kw = dict(causal=True, q_offset=s_len - t,
                  kv_valid_from=torch.full((1,), CP_VALID_FROM,
                                           dtype=torch.int32, device=dev))

        def folded(q=q, k=k, v=v, kw=kw):
            return context_parallel_folded(q, k, v, CP_SHARDS, **kw)

        def one(q=q, k=k, v=v, kw=kw):
            return flash_attention(q, k, v, **kw)

        got, want = folded(), one()
        scale = max(float(want.float().abs().max()), 1e-6)
        err = float((got.float() - want.float()).abs().max()) / scale
        if not err <= TOL[dt]:
            raise AssertionError(f"CP S={s_len} {dt}: error {err}")
        ms, one_ms = per_call_ms(folded, 0), per_call_ms(one, 0)
        log(f"[parallel] CP folded, S = {s_len} in {CP_SHARDS} shards of "
            f"{s_len // CP_SHARDS}, T = {t}, {str(dt)[6:]}: max error "
            f"{err:.3e} of the largest magnitude against one flash call "
            f"(bound {TOL[dt]:g}); device ms {CP_SHARDS} shards + "
            f"combine_stacked {ms:.4f}, one call {one_ms:.4f} "
            f"({ms / one_ms:.2f}x) | {card}")


def world1_engine(dev, mesh, card) -> dict:
    """Phase 20 (c): phase 5's preset:1.7b bf16 engine (seed 0) and the
    same model under ``make_mesh(1, 1)`` on a world-1 NCCL group, each
    running phase 5's first upload at B=1: token ids equal bit for bit,
    the collectives recorded in the sharded key's graphs (none in the
    unsharded one's), node counts and device ms of the front graph and a
    decode step. Returns the mesh engine's launches, counted from 0 just
    before its run."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    model = full_width_model(dev)
    clip = decode_audio(upload_bodies()[0][1])[0]
    out, launches = {}, None
    for name, m in (("unsharded", None), ("mesh 1x1", mesh)):
        eng = TranscriptionEngine(model, device=dev, dtype=torch.bfloat16,
                                  mesh=m)
        eng.transcribe(clip, 16000)                 # builds the key
        counter = PathLaunches(eng)
        ids = eng.transcribe(clip, 16000)[0].token_ids
        torch.cuda.synchronize()
        got, eager = counter.read()
        run = eng.last_run
        exe = eng.executables[(run["bucket_frames"], run["max_new"],
                               run["batch"], eng.cache_dtype)]
        front_ms, step_ms = front_and_step_ms(exe)
        if m is not None:
            launches = got
        rec = (exe.front.collectives, exe.chunk.collectives)
        out[name] = ids
        log(f"[parallel] {name} engine, {len(ids)} tokens: front graph "
            f"{exe.front.nodes} nodes ({rec[0]} collectives recorded) "
            f"{front_ms:.3f} ms, decode chunk {exe.chunk.nodes} nodes "
            f"({rec[1]} collectives) {step_ms:.4f} ms a step; launches "
            f"{got}, eager {eager} | {card}")
        if (m is None) != (rec == (0, 0)):
            raise AssertionError(f"{name}: collectives in its graphs {rec}")
        del eng
    if out["mesh 1x1"] != out["unsharded"]:
        raise AssertionError(f"world-1 mesh engine's ids differ: "
                             f"{out['mesh 1x1']} vs {out['unsharded']}")
    log(f"[parallel] the world-1 NCCL engine's ids equal the unsharded "
        f"engine's bit for bit ({len(out['unsharded'])} tokens)")
    return launches


def world1_training(dev, mesh, card) -> None:
    """Phase 20 (c): the distributed CP on the world-1 group equals flash;
    on trained_ckpt in f32, one step of the finetune path (``make_train_step``
    with the dp=1 mesh) and one pp=1, n_micro=2 pipeline step equal the
    plain train step (loss 1e-5 relative, weights 1e-4 absolute at lr
    1e-3), prompts unpadded as the pipeline's loss takes them."""
    from qwen3_asr_tpu_torch.ops.context_parallel import (
        context_parallel_attention)
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    from qwen3_asr_tpu_torch.parallel.mesh import shard_model
    from qwen3_asr_tpu_torch.parallel.pipeline import (make_mesh_pp,
                                                       make_pp_train_step,
                                                       shard_params_pp)
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.runtime.optim import adamw, tree_leaves
    from qwen3_asr_tpu_torch.runtime.train import (init_train_state,
                                                   make_train_step)
    from qwen3_asr_tpu_torch.tools.finetune import make_batch
    gen = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn((1, 16, 453, 128), generator=gen, device=dev)
    k, v = (torch.randn((1, 8, 768, 128), generator=gen, device=dev)
            for _ in range(2))
    got = context_parallel_attention(q, k, v, causal=True, q_offset=315)
    want = flash_attention(q, k, v, causal=True, q_offset=315)
    err = float((got - want).abs().max() / want.abs().max())
    log(f"[parallel] context_parallel_attention over the world-1 NCCL "
        f"group against flash, f32: max error {err:.3e} (bound 2e-5)")
    if not err <= 2e-5:
        raise AssertionError(f"distributed CP error {err}")

    engine = load_engine(os.path.join(DATA, "trained_ckpt"), device=dev,
                         dtype=torch.float32)
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))[:4]
    batch = make_batch(engine, train_items(clips), TRAIN_BUCKET_S)
    del batch["valid_from"]
    model, cfg = engine.model, engine.model.cfg
    shard = shard_model(model, mesh)
    pmesh = make_mesh_pp(pp=1, device_type=dev.type)
    runs = {}
    for name, c, params, make in (
            ("plain", cfg, model.params,
             lambda o: make_train_step(cfg, o)),
            ("finetune dp=1", shard.cfg, shard.params,
             lambda o: make_train_step(shard.cfg, o, mesh=mesh)),
            ("pipeline pp=1", cfg, shard_params_pp(model.params, pmesh),
             lambda o: make_pp_train_step(cfg, o, pmesh, n_micro=2))):
        opt = adamw(PAR_LR)
        state, loss = make(opt)(init_train_state(params, opt), batch)
        torch.cuda.synchronize()
        runs[name] = (float(loss), state.params)
    base_loss, base = runs.pop("plain")
    for name, (loss, params) in runs.items():
        rel = abs(loss - base_loss) / abs(base_loss)
        gap = max(float((a - b).abs().max()) for a, b in
                  zip(tree_leaves(params), tree_leaves(base)))
        log(f"[parallel] trained_ckpt f32, one step at lr {PAR_LR:g}: "
            f"{name} loss {loss:.7f} against the plain step's "
            f"{base_loss:.7f} (relative {rel:.2e}, bound 1e-5); weights "
            f"within {gap:.2e} (bound {PAR_TOL:g}) | {card}")
        if not (rel <= 1e-5 and gap <= PAR_TOL):
            raise AssertionError(f"{name}: loss {rel}, weights {gap}")


def parallel_phase(dev) -> tuple:
    """Phase 20: parallelism. (a) kernel (i)'s m/l route; (b) context
    parallelism folded onto the card; (c) a world-1 NCCL group: the mesh
    engine, the distributed CP, the finetune and pipeline steps. Returns
    (a)'s rows, its path's launches and the mesh engine's."""
    import torch.distributed as dist
    from qwen3_asr_tpu_torch.parallel.mesh import make_mesh
    card = card_line()
    ts = train_shapes()
    rows = ml_route_rows(ts, dev, card)
    ml = ml_path_launches(ts, dev, card)
    cp_rows(dev, card)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh(1, 1, device_type="cuda")
        engine_launches = world1_engine(dev, mesh, card)
        world1_training(dev, mesh, card)
    finally:
        dist.destroy_process_group()
    return rows, ml, engine_launches



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.environ["ASR_WARMUP_BUCKETS"] = SMOKE_BUCKETS
    card = card_line()
    log(f"[card] {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = t0 = time.time()

    def phase_done(name):
        nonlocal t0
        now = time.time()
        log(f"[time] {name}: {now - t0:.1f} s")
        t0 = now

    boot_cache = tempfile.mkdtemp(prefix="smoke_boot_")
    cold = cold_boot(boot_cache, card)
    build_kernels()
    phase_done("phase 1 (a cold boot: the build)")
    sh = main_path_shapes()
    log(f"[shapes] {sh}")
    rows = kernel_phases(sh, dev)
    phase_done("phases 2-3 (kernel parity and timing)")
    real = real_text_phase(dev)
    phase_done("phase 4 (real text)")
    engine, uploads = full_width_engine(dev), upload_bodies()
    launches, solo = main_path_phase(engine, uploads, dev)
    phase_done("phase 5 (main path at B=1)")
    batched, bf16_b8 = batch_phase(engine, dev, solo)
    launches["decode_attention_batch"] = batched["decode_attention_batch"]
    phase_done("phase 6 (main path at B=8)")
    profile_phase(engine, uploads[-1][1])
    phase_done("phase 7 (profile)")
    probe_rows, probe_launches = probe_phase(
        rows["decode_attention_batch"] + rows["decode_attention_batch_int4"])
    launches["slab_reader"] = probe_launches["slab_reader"]
    for r in probe_rows:
        head = next(x for x in rows["slab_reader"] if x["shape"] == r["shape"])
        head.update(ms=r["ms"], bound_ms=r["bound_ms"], bound_by="bytes",
                    gb_s=r["gb_s"])
    phase_done("phase 8 (probe)")
    default = default_config_phase(dev, sh, engine, bf16_b8, uploads)
    # the new kernel runs on every path: phases 5, 6 and 9, each counted
    # from 0 just before it
    qk = {5: launches["qk_rope_kv"], 6: batched["qk_rope_kv"],
          9: default["qk_rope_kv"]}
    for name in NO_TPU_KERNEL:
        if name not in TRAIN_KERNELS + (ML_KERNEL,):
            launches[name] = default[name]
    launches["qk_rope_kv"] = sum(qk.values())
    log(f"[launches] qk_rope_kv by phase {qk}: {sum(qk.values())}")
    phase_done("phase 9 (the default configuration)")
    ws = realtime_phase(dev, engine.model)
    # this slice's path, counted from 0 just before it: every kernel it
    # runs must have launched there
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch", "decode_attention_batch_int4",
                 "qgemv", "qgemm", "qk_rope_kv"):
        if not ws.get(name):
            raise AssertionError(f"phase 10 launched no {name}")
        launches[name] += ws[name]
    launches_per_row = ws["qk_rope_kv_per_row"]
    phase_done("phase 10 (real time over WS)")
    side = sidecar_phase(dev, engine)
    # this slice's path, counted from 0 just before it
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch", "qk_rope_kv"):
        if not side.get(name):
            raise AssertionError(f"phase 11 launched no {name}")
        launches[name] += side[name]
    phase_done("phase 11 (timestamps, subtitles, SSE, translations)")
    pooled = pool_phase(dev, engine, real)
    spec_inputs = real[1:]         # phase 15 (a): the uploads, answers, ids
    real_ids = (None,) + real[1:]  # phase 19 (a): the answers and ids
    del real
    # this slice's path, counted from 0 just before it
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch", "qgemv", "qgemm", "qk_rope_kv"):
        if not pooled.get(name):
            raise AssertionError(f"phase 12 launched no {name}")
        launches[name] += pooled[name]
    launches_per_row += pooled["qk_rope_kv_per_row"]
    phase_done("phase 12 (continuous batching)")
    streamed = stream_phase(dev, engine)
    # this slice's path, counted from 0 just before each of its runs
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch", "qgemv", "qgemm", "qk_rope_kv"):
        if not streamed.get(name):
            raise AssertionError(f"phase 13 launched no {name}")
        launches[name] += streamed[name]
    launches_per_row += streamed["qk_rope_kv_per_row"]
    phase_done("phase 13 (WS prefix caching)")
    grouped = group_phase(dev, engine)
    # this slice's path, counted from 0 just before each of its runs
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch", "qgemv", "qgemm", "qk_rope_kv"):
        if not grouped.get(name):
            raise AssertionError(f"phase 14 launched no {name}")
        launches[name] += grouped[name]
    launches_per_row += grouped["qk_rope_kv_per_row"]
    phase_done("phase 14 (grouped WS)")
    spec = spec_phase(dev, engine, spec_inputs)
    # this slice's path, counted from 0 just before each of its runs
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch", "qk_rope_kv"):
        if not spec.get(name):
            raise AssertionError(f"phase 15 launched no {name}")
        launches[name] += spec[name]
    launches_per_row += spec["qk_rope_kv_per_row"]
    phase_done("phase 15 (lifecycle, the fast engine, speculation)")
    contract = contract_phase(dev, engine)
    # this slice's path, counted from 0 just before its runs: uploads at
    # B=1 through the encoder, prefill and decode
    for name in ("flash_attention", "decode_attention", "qk_rope_kv"):
        if not contract.get(name):
            raise AssertionError(f"phase 16 launched no {name}")
        launches[name] += contract[name]
    phase_done("phase 16 (the serving contract, the upload codecs)")
    gateway_phase(dev, spec_inputs)
    phase_done("phase 17 (gateway mode)")
    del engine, bf16_b8
    gc.collect()
    torch.cuda.empty_cache()
    train_rows, trained = train_phase(dev)
    rows.update(train_rows)
    # this slice's path, counted from 0 just before each of its runs
    for name in ("flash_attention", "flash_attention_bwd", "qk_rope_kv",
                 "qk_rope_bwd"):
        if not trained.get(name):
            raise AssertionError(f"phase 18 launched no {name}")
        launches[name] = launches.get(name, 0) + trained[name]
    phase_done("phase 18 (training)")
    tools = tools_phase(dev, real_ids, boot_cache, cold)
    shutil.rmtree(boot_cache, ignore_errors=True)
    # this slice's path, counted from 0 just before each of its runs
    for name in ("flash_attention", "decode_attention",
                 "decode_attention_batch"):
        if not tools.get(name):
            raise AssertionError(f"phase 19 launched no {name}")
        launches[name] += tools[name]
    phase_done("phase 19 (the operator tools)")
    ml_rows, ml, meshed = parallel_phase(dev)
    rows[ML_KERNEL] = ml_rows
    launches[ML_KERNEL] = ml[ML_KERNEL]
    # this slice's path, counted from 0 just before each of its runs: the
    # residual loss's backward, and the world-1 mesh engine's request
    for name in ("flash_attention", "decode_attention", "qk_rope_kv"):
        if not meshed.get(name):
            raise AssertionError(f"phase 20 launched no {name}")
        launches[name] += meshed[name]
    phase_done("phase 20 (parallelism)")

    table = []
    for name, (source, replaces, headline) in KERNELS.items():
        head = next(r for r in rows[name] if r["shape"] == headline)
        extra = ({"replaces_kind": NO_TPU_KERNEL[name]}
                 if name in NO_TPU_KERNEL else {})
        if name == "qk_rope_kv":
            extra["launches_per_row"] = launches_per_row
        if name in TRAIN_KERNELS:   # phase 18's launches by route
            extra["launches_by_route"] = {
                k.split(":")[1]: n for k, n in trained.items()
                if k.startswith(name + ":")}
        if name == ML_KERNEL:       # phase 20's launches by route
            extra["launches_by_route"] = {
                k.split(":")[1]: n for k, n in ml.items() if ":" in k}
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, **extra,
                      "launches": launches[name],
                      "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                      "plain_ms": head["plain_ms"],
                      "bound_ms": head["bound_ms"],
                      "bound_by": head["bound_by"],
                      "library_ms": head["library_ms"],
                      "shape": headline, "shapes": rows[name]})
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
