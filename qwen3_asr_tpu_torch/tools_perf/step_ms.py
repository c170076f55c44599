"""Decode-step and front-graph device time, and CUDA kernels a decode step,
of a checkout of the port on the card.

preset:1.7b (seeded random weights, bf16) in three configurations: bf16
weights with a bf16 KV cache (``bf16``), the JAX package's default serving
row (``int8``: ``QUANTIZE=int8``, ``ASR_KV_CACHE_DTYPE=int4``,
``ASR_INT8_ACT=true``), and int4 weights with an int4 KV cache (``int4``:
``QUANTIZE=int4``, ``ASR_KV_CACHE_DTYPE=int4``); ``--configs`` picks
some (a checkout that cannot load int4 weights takes ``bf16,int8``);
each at B=1 (the 30 s bucket, 29.5 s of the in-repo speech) and at B=8
(the 10 s bucket, eight 9.5 s clips). For each it runs the request once
through the key's CUDA graphs, then replays them between CUDA events:
the front graph (frontend, encoder, prompt, prefill, first token), and
one decode chunk over DECODE_CHUNK steps; and counts the CUDA kernels one
chunk replay records under ``torch.profiler``.

``--root DIR`` imports ``qwen3_asr_tpu_torch`` from DIR instead of this
checkout, so the same script times another checkout, e.g. a parent commit
unpacked beside this one; compare two in one machine's run, in turns
(parent, change, change, parent):

    python qwen3_asr_tpu_torch/tools_perf/step_ms.py \
        --root _tree_check/parent --configs bf16,int8
    python qwen3_asr_tpu_torch/tools_perf/step_ms.py

It prints the card's line, then one JSON object a configuration and
batch.

``--mode qgemm`` times kernel C (the quantized GEMM) instead, through the
checkout's own ``ops.qgemm.qgemm_group``: at every product of
``QGEMM_SHAPES`` (preset:1.7b, one launch a product as the front graph
makes it) and its rows (``QGEMM_ROWS``: the front graph's at B=1, 30 s,
and B=8, 10 s; 32 decode rows at the tied lm_head), int8, fp8 and int4
payloads (int4: groups of 128, one group at the lm_head), the device ms of
one call stepping through ``QGEMM_LAYERS`` stacked layers (each cold), and
of one ``F.linear`` on the same payloads widened to bf16 as a yardstick
that does not change between checkouts; the plan where the checkout has
one (``qgemm_plan``). The weights and x come from fixed seeds, so two
checkouts time the same products:

    python qwen3_asr_tpu_torch/tools_perf/step_ms.py --mode qgemm \
        --root _tree_check/parent
    python qwen3_asr_tpu_torch/tools_perf/step_ms.py --mode qgemm

With ``--plans`` (a checkout with ``qgemm_candidates``), each product is
also timed under every grid the kernel takes with at most four K splits,
beside the plan's estimate of each (``QgemmPlan.estimate_ns``), so the plan's
choice can be held against the card's.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
CONFIGS = {
    "bf16": ("bf16 weights, bf16 KV", {}),
    "int8": ("int8 weights, int4 KV, W8A8",
             {"QUANTIZE": "int8", "ASR_KV_CACHE_DTYPE": "int4",
              "ASR_INT8_ACT": "true"}),
    "int4": ("int4 weights, int4 KV",
             {"QUANTIZE": "int4", "ASR_KV_CACHE_DTYPE": "int4"})}
ENV_NAMES = ("QUANTIZE", "ASR_KV_CACHE_DTYPE", "ASR_INT8_ACT")
# (name, K, output widths, where) of kernel C's launches at preset:1.7b:
# the decoder's wo and w_down and its q/k/v and gate/up groups, the
# encoder's wo, fc1, fc2 and q/k/v group, and the tied lm_head (f32 logits)
QGEMM_SHAPES = (("wq_wo", 2048, (2048,), "dec"),
                ("down", 6144, (2048,), "dec"),
                ("qkv_group", 2048, (2048, 1024, 1024), "dec"),
                ("gate_up_group", 2048, (6144, 6144), "dec"),
                ("enc_attn", 1280, (1280,), "enc"),
                ("enc_fc1", 1280, (5120,), "enc"),
                ("enc_fc2", 5120, (1280,), "enc"),
                ("enc_qkv_group", 1280, (1280, 1280, 1280), "enc"),
                ("lm_head", 2048, (151936,), "head"))
# rows: the prompt at B=1 (30 s) and B=8 (10 s), the encoder's tokens at
# the same, and decode rows at the lm_head (chip_smoke.py checks these
# against the preset's own)
QGEMM_ROWS = {"dec": (453, 1624), "enc": (375, 1000), "head": (32,)}
QGEMM_LAYERS = 4                   # stacked layers a timing steps through


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def replay_ms(torch, graph, replays: int = 5) -> float:
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


def kernels_a_chunk(torch, exe) -> int:
    """CUDA kernel records of one chunk replay after the front's reset."""
    exe.front()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        exe.chunk()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA)


def qgemm_times(torch, dev, label: str, card: str, plans: bool) -> None:
    """``--mode qgemm``: one JSON line a product, payload and row count."""
    import torch.nn.functional as F
    from qwen3_asr_tpu_torch.ops import qgemm as qgemm_mod
    from qwen3_asr_tpu_torch.ops.qgemv import unpack_int4
    from qwen3_asr_tpu_torch.ops.quant import (quantize_array,
                                               quantize_embed, row_scales)
    from qwen3_asr_tpu_torch.tools_perf.attn_phase import device_ms
    plan_of = getattr(qgemm_mod, "qgemm_plan", None)
    for mode in ("int8", "fp8", "int4"):
        for name, k, ns, where in QGEMM_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(k + 3 * sum(ns))
            head = where == "head"
            layers = 1 if head else QGEMM_LAYERS
            pays, wides = [], []
            for n in ns:
                w = (torch.randn((n, k) if head else (layers, k, n),
                                 generator=gen, device=dev) * 0.02).bfloat16()
                leaf = quantize_embed(w, mode) if head \
                    else quantize_array(w, mode)
                q, sc = leaf["q"], row_scales(leaf)
                if head:
                    q, sc = q[None], sc[None]
                pays.append((q, sc))
                wides.append((unpack_int4(q) if q.dtype == torch.uint8
                              else q).to(torch.bfloat16))
                del w
            wide = torch.cat(wides, dim=1)
            del wides
            out_dtype = torch.float32 if head else torch.bfloat16
            for m in QGEMM_ROWS[where]:
                x = torch.randn((m, k), generator=gen,
                                device=dev).bfloat16()

                def run(x=x):
                    for layer in range(layers):
                        qgemm_mod.qgemm_group(
                            x, [(q[layer], s[layer]) for q, s in pays],
                            out_dtype=out_dtype)

                def lib(x=x):
                    for layer in range(layers):
                        F.linear(x, wide[layer])

                plan, grids = None, None
                ngroups = pays[0][1][0].numel() // ns[0]
                if plan_of is not None:
                    p = plan_of(m, list(ns), k, pays[0][0].dtype, ngroups)
                    plan = {"bm": p.bm, "splits": p.splits,
                            "blocks": p.blocks, "estimate_ns": p.estimate_ns()}
                if plans:
                    grids = []
                    for g in qgemm_mod.qgemm_candidates(
                            m, list(ns), k, pays[0][0].dtype, ngroups):
                        if g.splits > 4:
                            continue
                        qgemm_mod.qgemm_plan = lambda *_, g=g: g
                        grids.append({"bm": g.bm, "splits": g.splits,
                                      "estimate_ns": g.estimate_ns(),
                                      "ms": device_ms(run) / layers})
                    qgemm_mod.qgemm_plan = plan_of
                print(json.dumps({
                    "checkout": label, "mode": "qgemm", "shape": name,
                    "rows": m, "payload": mode,
                    "ms": device_ms(run) / layers,
                    "f_linear_ms": device_ms(lib) / layers, "plan": plan,
                    "grids": grids, "card": card}), flush=True)
            del pays, wide
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=CHECKOUT,
                    help="the checkout whose qwen3_asr_tpu_torch to time")
    ap.add_argument("--label", default="",
                    help="a name for this checkout in the output")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated, of " + ", ".join(CONFIGS))
    ap.add_argument("--mode", choices=("steps", "qgemm"), default="steps",
                    help="decode steps and front graphs, or kernel C")
    ap.add_argument("--plans", action="store_true",
                    help="qgemm: also time every grid the plan turned down")
    args = ap.parse_args()
    configs = args.configs.split(",")
    if not configs or set(configs) - set(CONFIGS):
        ap.error(f"--configs takes names of {list(CONFIGS)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_ms: no CUDA device is available", file=sys.stderr)
        return 1
    import qwen3_asr_tpu_torch
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    from qwen3_asr_tpu_torch.models.asr import AsrModel
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
    from qwen3_asr_tpu_torch.models.encoder import init_encoder_params
    from qwen3_asr_tpu_torch.ops import _build
    from qwen3_asr_tpu_torch.runtime.engine import (TranscriptionEngine,
                                                    max_new_tokens_for)
    from qwen3_asr_tpu_torch.runtime.generate import DECODE_CHUNK
    from qwen3_asr_tpu_torch.runtime.lifecycle import (
        kv_cache_dtype_from_env, preset_tokenizer, quantize_mode_from_env,
        quantize_model)
    pkg = os.path.dirname(os.path.abspath(qwen3_asr_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    label = args.label or os.path.relpath(root, CHECKOUT)
    print(f"[step_ms] {label}: {pkg} | {card}", flush=True)
    _build.build(sorted(os.path.basename(p)[:-3]
                        for p in glob.glob(os.path.join(pkg, "csrc", "*.cu"))))
    if args.mode == "qgemm":
        qgemm_times(torch, dev, label, card, args.plans)
        return 0

    parts = []
    for path in sorted(glob.glob(os.path.join(CHECKOUT, "e2e", "data",
                                              "real", "*.wav"))):
        with open(path, "rb") as f:
            parts.append(decode_audio(f.read())[0])
    speech = np.concatenate(parts)
    seg = int(9.5 * 16000)
    requests = ((1, [speech[:int(29.5 * 16000)]]),
                (8, [speech[i * seg:(i + 1) * seg] for i in range(8)]))

    cfg = preset("1.7b")

    def model():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = {"encoder": init_encoder_params(cfg.encoder, gen, dev,
                                                 torch.bfloat16),
                  "decoder": init_decoder_params(cfg.decoder, gen, dev,
                                                 torch.bfloat16)}
        return AsrModel(cfg, params, preset_tokenizer(cfg.decoder.vocab_size))

    for name, env in (CONFIGS[c] for c in configs):
        saved = {k: os.environ.get(k) for k in ENV_NAMES}
        for k in ENV_NAMES:
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            m = model()
            if env:
                quantize_model(m, quantize_mode_from_env())
            engine = TranscriptionEngine(
                m, device=dev, dtype=torch.bfloat16,
                cache_dtype=kv_cache_dtype_from_env() if env else None)
            for batch, clips in requests:
                bf, bs = engine.bucket_frames(max(len(c) for c in clips))
                exe, capture_s = engine.executable(bf, max_new_tokens_for(bs),
                                                   batch)
                res = exe.run(*engine.bucket_inputs(clips, bf, None))
                front = replay_ms(torch, exe.front)
                exe.front()
                step = replay_ms(torch, exe.chunk) / DECODE_CHUNK
                kernels = kernels_a_chunk(torch, exe) / DECODE_CHUNK
                print(json.dumps({
                    "checkout": label, "config": name, "batch": batch,
                    "bucket_frames": bf, "front_ms": front, "step_ms": step,
                    "kernels_a_step": kernels, "capture_s": capture_s,
                    "steps": res.steps, "card": card}), flush=True)
            del engine, m
            torch.cuda.empty_cache()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return 0


if __name__ == "__main__":
    sys.exit(main())
