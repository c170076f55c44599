"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root: ``python3 chip_smoke.py``. It exits non-zero
without a CUDA device, and whenever any phase fails. Phases:

1. the card's name and power limit; build both CUDA kernels from
   ``qwen3_asr_tpu_torch/csrc`` (one nvcc each, in parallel) and print
   ptxas' registers, shared memory and spills;
2. each kernel against its plain PyTorch version at the main path's shapes
   for preset:1.7b (encoder 30 s, prefill 30 s, decode step; B=1 and B=4)
   in f32 (TF32 off) and bf16;
3. device times (CUDA graph replays between CUDA events) of kernel, plain
   version and one SDPA call (yardstick only), beside the bound (bytes /
   3.35 TB/s against FLOPs / 989 TFLOP/s, counting only the work the mask
   leaves); the decode step steps through all layers of the stacked cache,
   as the decode loop does, so each call finds its layer cold in HBM;
4. real text: e2e/data/trained_ckpt on the card in f32 must give token ids
   identical to the same port on the CPU and the reference transcripts;
5. the main path: a preset:1.7b engine in bf16 with seeded random weights,
   served by the port's HTTP server on 127.0.0.1, answers three uploads
   (10 s, 15 s and 30 s buckets) with both kernels' launch counts growing;
6. where the time goes: the 30 s upload once more through the warm engine
   under ``torch.profiler``: wall, device busy share and the top kernels.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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


def device_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times between CUDA events, so host overhead does not
    hide the kernel's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# -- phase 1 ---------------------------------------------------------------------

def build_kernels() -> None:
    from qwen3_asr_tpu_torch.ops import _build
    t0 = time.time()
    reports = _build.build(["flash_attention", "decode_attention"])
    log(f"[build] both kernels ready in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = "bf16" if "bfloat16" in m.group(1) else "f32"
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


def per_call_ms(fn, layers: int) -> float:
    """Device ms of one call; with ``layers``, the calls step through every
    layer of the stacked cache (larger than L2), as the decode loop does."""
    if not layers:
        return device_ms(fn)
    return device_ms(lambda: [fn(i) for i in range(layers)]) / layers


def kernel_phases(sh, dev):
    """Parity (phase 2) in f32 and bf16, timing (phase 3) in bf16, the
    working dtype on the card. Returns {kernel: [per-shape rows]}."""
    card = card_line()
    rows = {"flash_attention": [], "decode_attention": []}
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
                if dtype != torch.bfloat16:
                    continue
                ms = per_call_ms(run, layers)
                plain_ms = per_call_ms(plain, layers)
                lib_ms = per_call_ms(sdpa, layers)
                call_ms = eager_ms(run, 50)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOPS * 1e3
                bound = max(t_bytes, t_ops)
                row = {"shape": label, "dtype": dt, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound,
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "eager_ms": call_ms, "bytes": nbytes, "flops": flops}
                rows[kernel].append(row)
                log(f"[timing] {label} bf16 (device): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; one "
                    f"eager call {call_ms:.4f} ms; bound "
                    f"{bound:.5f} ms ({row['bound_by']}), share "
                    f"{bound / ms:.3%} | {card}")
    return rows


# -- phase 4 ---------------------------------------------------------------------

def real_text_phase(dev):
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    ckpt = os.path.join(DATA, "trained_ckpt")
    gpu = load_engine(ckpt, device=dev, dtype=torch.float32)
    cpu = load_engine(ckpt, device="cpu")
    flash_attention.launches = decode_attention.launches = 0
    clips = sorted(glob.glob(os.path.join(DATA, "real", "*.wav")))
    for path in clips:
        with open(path, "rb") as f:
            audio, sr = decode_audio(f.read())
        ours = gpu.transcribe(audio, sr)[0]
        ref = cpu.transcribe(audio, sr)[0]
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


def upload_bodies():
    from qwen3_asr_tpu_torch.audio.codec import decode_audio, encode_wav
    real = os.path.join(DATA, "real")

    def read(name):
        with open(os.path.join(real, name), "rb") as f:
            return f.read()

    parts = []
    for path in sorted(glob.glob(os.path.join(real, "*.wav"))):
        parts.append(decode_audio(read(os.path.basename(path)))[0])
    long = np.concatenate(parts)[:int(29.5 * 16000)]
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


def main_path_phase(engine, uploads, dev):
    from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
    from qwen3_asr_tpu_torch.serving.server import build_server
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

    server = build_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/audio/transcriptions"
    try:
        flash_attention.launches = decode_attention.launches = 0
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
            log(f"[serve] preset:1.7b bf16 {name}: {wall:.3f} s wall, "
                f"{run['generated']} tokens generated, prompt "
                f"{run['prompt_len']}, cache {run['cache_len']}, bucket "
                f"{run['bucket_frames']} frames, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        launches = {"flash_attention": flash_attention.launches,
                    "decode_attention": decode_attention.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[serve] launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


# -- phase 6 ---------------------------------------------------------------------

def profile_phase(engine, wav: bytes, top: int = 12) -> None:
    """One more transcription of ``wav`` through the warm engine under
    torch.profiler: wall, device busy time (sum of CUDA kernel time) and its
    share of the wall, and the kernels that took the most device time."""
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    audio, sr = decode_audio(wav)
    card = card_line()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
            f"{e.count:7d} calls  {e.key[:90]}")


KERNELS = {
    "flash_attention": ("qwen3_asr_tpu_torch/csrc/flash_attention.cu",
                        "qwen3_asr_tpu/ops/flash_attention.py:39",
                        "prefill_30s_b1"),
    "decode_attention": ("qwen3_asr_tpu_torch/csrc/decode_attention.cu",
                         "qwen3_asr_tpu/ops/decode_attention.py:39",
                         "decode_step_b1"),
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
    t0 = time.time()
    build_kernels()
    sh = main_path_shapes()
    log(f"[shapes] {sh}")
    rows = kernel_phases(sh, dev)
    real_text_phase(dev)
    engine, uploads = full_width_engine(dev), upload_bodies()
    launches = main_path_phase(engine, uploads, dev)
    profile_phase(engine, uploads[-1][1])

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
    log(f"[done] all phases passed in {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
