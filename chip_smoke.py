"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root: ``python3 chip_smoke.py``. It exits non-zero
without a CUDA device, and whenever any phase fails. Phases:

1. the card's name and power limit; build the four CUDA kernels from
   ``qwen3_asr_tpu_torch/csrc`` (one nvcc each, in parallel) and print
   ptxas' registers, shared memory and spills;
2. each kernel against its plain PyTorch version at the main path's shapes
   for preset:1.7b: flash attention (encoder 30 s, prefill 30 s) and the
   single-token decode step at B=1 and B=4 in f32 (TF32 off) and bf16; the
   batched decode step at S=768 for B=1 and B=8 with bf16 and fp8 caches,
   and at the JAX serving shape B=96, S=512 with fp8; the slab-read probe
   at its three shapes;
3. device times (CUDA graph replays between CUDA events) of kernel, plain
   version and one SDPA call (yardstick only; on a bf16 copy of an fp8
   cache), beside the bound (bytes / 3.35 TB/s against FLOPs /
   989 TFLOP/s, counting only the work the mask leaves) and, in the log
   only, kernels #3 and #4's times before their redesign as PERF.md
   records them; decode steps step through all layers of the stacked
   cache, as the decode loop does, so each call finds its layer cold in
   HBM. One call of kernels #3 and #4 under torch.profiler must run one
   device kernel;
4. real text: e2e/data/trained_ckpt on the card in f32 must give token ids
   identical to the same port on the CPU and the reference transcripts,
   one clip at a time, and then with the 12 clips sent at once through
   the port's server and its micro-batcher (fewer dispatches than clips);
5. the main path at B=1: a preset:1.7b engine in bf16 with seeded random
   weights, served by the port's HTTP server on 127.0.0.1, answers three
   uploads (10 s, 15 s and 30 s buckets) one after another; flash runs
   once per encoder and decoder layer and request, the single-token decode
   kernel once per layer and decode step (one launch each);
6. the main path at batch: 8 concurrent uploads of the 10 s bucket on the
   same engine with a bf16 KV cache and with fp8, in turns (bf16, fp8,
   fp8, bf16), each answered from ONE dispatch at B=8 through the batched
   decode kernel;
7. where the time goes: the 30 s upload once more through the warm engine
   under ``torch.profiler``, recording CUDA activity only (the host events
   of the loop cost minutes of post-processing and the device share does
   not need them): wall, device busy share, the top kernels, and one
   decode kernel per layer and step;
8. the KV read-rate probe (``tools_perf/attn_phase.py``) at its shapes,
   each beside kernel #3's read rate at the same B and cache dtype.

Each phase prints its seconds. The line before the card line is the
kernel table as JSON; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
import uuid

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "e2e", "data")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


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

def build_kernels() -> None:
    from qwen3_asr_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build(list(KERNELS))
    log(f"[build] {len(reports)} kernels ready in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = re.sub(r"_ZN\w*?_cu_\w{8}\d+", "", m.group(1))[:48]
            elif "registers" in line or "spill" in line:
                log(f"[ptxas] {name}<{entry}>: {line.strip()}")


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
    return dict(
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
        kv_name = "bf16" if kv_dtype == bf16 else "fp8"

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
    from qwen3_asr_tpu_torch.ops.slab_reader import (slab_read,
                                                     slab_read_plain)
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import (
        LAYERS, NKV, SHAPES, stacked_cache)
    for name, batch, seq, dtype in SHAPES:
        k, v = stacked_cache(batch, seq, dtype, dev)
        yield (name,
               lambda layer, k=k, v=v: slab_read(k, v, layer_idx=layer,
                                                 seed=1),
               lambda layer, k=k, v=v: slab_read_plain(
                   k, v, layer_idx=layer, seed=1, block_s=128),
               2 * batch * NKV * seq * 128 * k.element_size(), LAYERS)
        del k, v


def per_call_ms(fn, layers: int) -> float:
    """Device ms of one call; with ``layers``, the calls step through every
    layer of the stacked cache (larger than L2), as the decode loop does."""
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import device_ms
    if not layers:
        return device_ms(fn)
    return device_ms(lambda: [fn(i) for i in range(layers)]) / layers


# Device ms of kernels #3 and #4 before their redesign, as PERF.md's kernel
# table records them (its earlier-time column, from a run of this script on
# an NVIDIA H100 80GB HBM3 at 700 W). Printed beside this run's in the log
# only: they are not this run's, so no row of the kernel table holds them.
EARLIER_MS = {
    "batched_b1_s768_bf16": 0.0134, "batched_b8_s768_bf16": 0.0212,
    "batched_b1_s768_fp8": 0.0118, "batched_b8_s768_fp8": 0.0191,
    "batched_b96_s512_fp8": 0.0728, "engine_b8_s768_bf16": 0.0115,
    "engine_b8_s768_fp8": 0.0078, "jax_default_b96_s512_fp8": 0.0353}


def one_kernel_per_call(name, fn, calls: int = 3) -> None:
    """``calls`` calls of ``fn`` under torch.profiler (CUDA activity only)
    must run exactly one device kernel each, all of one name. A spin kernel
    opens the window (on the card a second profiler run in a process has
    dropped its first kernel event) and is left out of the count."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key[:60], e.count) for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and "spin" not in e.key]
    log(f"[profile] {name}: {calls} calls ran {kernels}")
    if len(kernels) != 1 or kernels[0][1] != calls:
        raise AssertionError(f"{name}: want one device kernel a call, got "
                             f"{kernels}")


def time_row(label, dt, err, run, plain, sdpa, nbytes, flops, layers,
             card, sdpa_note=""):
    """Phase 3 for one case in bf16: the row of the kernel table."""
    ms = per_call_ms(run, layers)
    plain_ms = per_call_ms(plain, layers)
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
        + f", plain {plain_ms:.4f} ms, sdpa{sdpa_note} {lib_ms:.4f} ms "
        f"(kernel / sdpa {ms / lib_ms:.3f}); one eager call "
        f"{call_ms:.4f} ms; bound {bound:.5f} ms ({row['bound_by']}), "
        f"share {bound / ms:.3%} | {card}")
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
            one_kernel_per_call(f"{kernel} {label}",
                                lambda: run(layers - 1))
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
        plain_ms = per_call_ms(plain, layers)
        log(f"[parity] {label}: max_abs_err={err:.3e} (bound 1e-5 + "
            f"1e-5 relative); plain {plain_ms:.4f} ms (device) | {card}")
        if label == KERNELS["slab_reader"][2]:
            one_kernel_per_call(f"slab_reader {label}",
                                lambda: run(layers - 1))
        rows["slab_reader"].append({
            "shape": label, "max_abs_err": err, "plain_ms": plain_ms,
            "library_ms": None, "bytes": nbytes})
    return rows


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
    from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
    from qwen3_asr_tpu_torch.serving.server import merge_results
    from qwen3_asr_tpu_torch.text.repetition import detect_and_fix_repetitions
    ckpt = os.path.join(DATA, "trained_ckpt")
    gpu = load_engine(ckpt, device=dev, dtype=torch.float32)
    cpu = load_engine(ckpt, device="cpu")
    flash_attention.launches = decode_attention.launches = 0
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
    log(f"[real] trained_ckpt f32: {len(clips)}/{len(clips)} clips "
        f"token-identical to the CPU and equal to the transcripts; launches "
        f"flash={flash_attention.launches} decode={decode_attention.launches}")
    if not (flash_attention.launches and decode_attention.launches):
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
    for path, body, res, ref in zip(clips, bodies, batched, refs):
        text, lang = merge_results(ref)
        want = {"text": detect_and_fix_repetitions(text), "language": lang}
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


# -- phase 5 ---------------------------------------------------------------------

def full_width_engine(dev):
    from qwen3_asr_tpu_torch.models.asr import AsrModel
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
    from qwen3_asr_tpu_torch.models.encoder import init_encoder_params
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu_torch.runtime.lifecycle import preset_tokenizer
    cfg = preset("1.7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {
        "encoder": init_encoder_params(cfg.encoder, gen, dev, torch.bfloat16),
        "decoder": init_decoder_params(cfg.decoder, gen, dev, torch.bfloat16)}
    model = AsrModel(cfg, params, preset_tokenizer(cfg.decoder.vocab_size))
    return TranscriptionEngine(model, device=dev, dtype=torch.bfloat16)


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


def reset_launches():
    """Set every kernel's launch count to 0; returns a reader of them."""
    from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import (
        decode_attention_batched)
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    from qwen3_asr_tpu_torch.ops.slab_reader import slab_read
    wrappers = {"flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "decode_attention_batch": decode_attention_batched,
                "slab_reader": slab_read}
    for w in wrappers.values():
        w.launches = 0
    return lambda: {name: w.launches for name, w in wrappers.items()}


def main_path_phase(engine, uploads, dev):
    """Three uploads one after another: each runs at B=1 (bf16 cache, the
    single-token decode kernel). Returns (launches, B=1 figure of the
    10 s upload)."""
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

    first = None
    layers = engine.model.cfg.decoder.num_hidden_layers
    per_request = layers + engine.model.cfg.encoder.encoder_layers
    want_decode = 0
    with serving(ModelManager(engine)) as url:
        read_launches = reset_launches()
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
            want_decode += layers * (run["steps"] - 1)
            first = first or (wall, run["generated"])
            log(f"[serve] preset:1.7b bf16 {name}: {wall:.3f} s wall, "
                f"{run['generated']} tokens generated, prompt "
                f"{run['prompt_len']}, cache {run['cache_len']}, bucket "
                f"{run['bucket_frames']} frames, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        launches = read_launches()
    log(f"[serve] launches on the main path: {launches} (want flash "
        f"{per_request * len(uploads)}, decode {want_decode})")
    if (launches["flash_attention"] != per_request * len(uploads)
            or launches["decode_attention"] != want_decode):
        raise AssertionError(f"launches {launches}: want flash "
                             f"{per_request * len(uploads)} and decode "
                             f"{want_decode}, one per layer and step")
    return launches, first


# -- phase 6 ---------------------------------------------------------------------

def batch_phase(engine, dev, solo):
    """8 concurrent uploads of the 10 s bucket with a bf16 KV cache and
    with fp8, in turns (bf16, fp8, fp8, bf16) so that the two compare
    within one call: each run must come back from ONE dispatch at B=8,
    every decode step through the batched kernel. Returns its launches."""
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    card = card_line()
    audio = real_audio()
    seg = int(9.5 * 16000)
    bodies = [encode_wav(audio[i * seg:(i + 1) * seg], 16000)
              for i in range(8)]
    total = {}
    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    for kv in (bf16, fp8, fp8, bf16):
        eng = TranscriptionEngine(engine.model, device=dev,
                                  dtype=torch.bfloat16, cache_dtype=kv)
        manager = ModelManager(eng)
        manager.batcher = MicroBatcher(manager, window_ms=1000, max_batch=8)
        with serving(manager) as url:
            torch.cuda.reset_peak_memory_stats()
            read_launches = reset_launches()
            t0 = time.perf_counter()
            replies, walls = post_all(url, bodies)
            torch.cuda.synchronize()
            batch_wall = time.perf_counter() - t0
            launches = read_launches()
        run = eng.last_run
        name = "bf16" if kv == bf16 else "fp8"
        for body in replies:
            if not isinstance(body.get("text"), str) or "language" not in body:
                raise AssertionError(f"{name}: bad response {body}")
        want = 28 * (run["steps"] - 1)
        log(f"[batch] preset:1.7b bf16, KV cache {name}: 8 uploads at once "
            f"-> {manager.batcher.dispatches} dispatch, batch {run['batch']},"
            f" {run['generated']} tokens in {batch_wall:.3f} s = "
            f"{run['generated'] / batch_wall:.1f} tokens/s (B=1 phase 5: "
            f"{solo[1]} tokens in {solo[0]:.3f} s = "
            f"{solo[1] / solo[0]:.1f} tokens/s); request walls "
            f"{', '.join(f'{w:.3f}' for w in walls)} s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{launches} | {card}")
        if (manager.batcher.dispatches != 1 or run["batch"] != 8
                or launches["decode_attention_batch"] != want
                or launches["decode_attention"] or
                not launches["flash_attention"]):
            raise AssertionError(f"{name}: {manager.batcher.dispatches} "
                                 f"dispatches, batch {run['batch']}, "
                                 f"launches {launches}, want batched {want}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


# -- phase 7 ---------------------------------------------------------------------

def profile_phase(engine, wav: bytes, top: int = 12) -> None:
    """One more transcription of ``wav`` through the warm engine under
    torch.profiler (CUDA activity only): wall, device busy time (sum of
    CUDA kernel time) and its share of the wall, the kernels that took the
    most device time, and one single-token decode kernel per layer and
    decode step."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    audio, sr = decode_audio(wav)
    card = card_line()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.transcribe(audio, sr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    run = engine.last_run
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    log(f"[profile] {len(audio) / sr:.2f} s upload under torch.profiler: "
        f"{wall:.3f} s wall, {run['generated']} tokens, device busy "
        f"{busy:.3f} s = {busy / wall:.1%} of the wall | {card}")
    if not kernels:
        log("[profile] the profiler recorded no device time")
    for e in sorted(kernels, key=lambda e: e.device_time_total,
                    reverse=True)[:top]:
        log(f"[profile] {e.device_time_total / 1e3:10.3f} ms "
            f"{e.count:7d} calls  {e.key[:90]} "
            f"({e.device_time_total / 1e6 / busy:.1%} of busy)")
    decode = [(e.key[:60], e.count) for e in kernels
              if "decode_split_kernel" in e.key]
    want = engine.model.cfg.decoder.num_hidden_layers * (run["steps"] - 1)
    log(f"[profile] decode kernels: {decode} (want one name, {want} calls)")
    if len(decode) != 1 or decode[0][1] != want:
        raise AssertionError(f"decode kernels {decode}: want one name with "
                             f"{want} calls")


# -- phase 8 ---------------------------------------------------------------------

# the batched decode case (kernel #3) at each probe shape's B and dtype
PROBE_TWIN = {"engine_b8_s768_bf16": "batched_b8_s768_bf16",
              "engine_b8_s768_fp8": "batched_b8_s768_fp8",
              "jax_default_b96_s512_fp8": "batched_b96_s512_fp8"}


def probe_phase(batched_rows):
    """The KV read-rate probe at its shapes, each beside kernel #3's read
    rate at the same B and cache dtype (phase 3). Returns its rows and the
    launches."""
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import probe
    card = card_line()
    read_launches = reset_launches()
    rows = probe()
    launches = read_launches()
    for r in rows:
        twin = next(x for x in batched_rows
                    if x["shape"] == PROBE_TWIN[r["shape"]])
        rate = twin["bytes"] / twin["ms"] / 1e6
        log(f"[probe] {r['shape']}: {r['ms']:.4f} ms per layer "
            f"({r['bytes'] / 1e6:.1f} MB), {r['gb_s']:.0f} GB/s = "
            f"{r['share']:.1%} of 3.35 TB/s (before the redesign, "
            f"PERF.md: {EARLIER_MS[r['shape']]:.4f} ms); kernel #3 "
            f"{twin['shape']} "
            f"reads {rate:.0f} GB/s = {rate / r['gb_s']:.1%} of the probe's "
            f"rate | {card}")
    if not launches["slab_reader"]:
        raise AssertionError(f"the probe launched no slab read: {launches}")
    return rows, launches


# name -> (source, TPU kernel it replaces, headline shape)
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
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card} | torch.cuda: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = t0 = time.time()

    def phase_done(name):
        nonlocal t0
        now = time.time()
        log(f"[time] {name}: {now - t0:.1f} s")
        t0 = now

    build_kernels()
    phase_done("phase 1 (build)")
    sh = main_path_shapes()
    log(f"[shapes] {sh}")
    rows = kernel_phases(sh, dev)
    phase_done("phases 2-3 (kernel parity and timing)")
    real_text_phase(dev)
    phase_done("phase 4 (real text)")
    engine, uploads = full_width_engine(dev), upload_bodies()
    launches, solo = main_path_phase(engine, uploads, dev)
    phase_done("phase 5 (main path at B=1)")
    batched = batch_phase(engine, dev, solo)
    launches["decode_attention_batch"] = batched["decode_attention_batch"]
    phase_done("phase 6 (main path at B=8)")
    profile_phase(engine, uploads[-1][1])
    phase_done("phase 7 (profile)")
    probe_rows, probe_launches = probe_phase(rows["decode_attention_batch"])
    launches["slab_reader"] = probe_launches["slab_reader"]
    for r in probe_rows:
        head = next(x for x in rows["slab_reader"] if x["shape"] == r["shape"])
        head.update(ms=r["ms"], bound_ms=r["bound_ms"], bound_by="bytes",
                    gb_s=r["gb_s"])
    phase_done("phase 8 (probe)")

    table = []
    for name, (source, replaces, headline) in KERNELS.items():
        head = next(r for r in rows[name] if r["shape"] == headline)
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
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
