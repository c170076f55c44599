"""A boot of the port by part, in a process of its own, on the card.

Times what a server's start pays before its first answer: the CUDA
context, building every kernel and host library (``ops/_build.py``:
``nvcc`` and ``g++``, or copies out of ``ASR_AOT_CACHE_DIR``, see
``runtime/aot_cache.py``; the compiler processes started are counted),
loading them (``ctypes``), reading the weights, quantizing them
(``QUANTIZE``), and the capture of each key an upload of ``--buckets``
needs (B=1); then transcribes ``--clip`` and reports its token ids, so two
boots can be held equal. ``--build-dir`` builds into another directory
than the package's ``_build/`` (an empty one is a cold boot).

    ASR_AOT_CACHE_DIR=/tmp/boot QUANTIZE=int8 ASR_KV_CACHE_DTYPE=int4 \\
        python -m qwen3_asr_tpu_torch.tools_perf.boot \\
        --build-dir /tmp/b1 --model preset:1.7b

It prints the card's line, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default="preset:1.7b")
    parser.add_argument("--build-dir", default=None)
    parser.add_argument("--buckets", default="10,30")
    parser.add_argument("--clip", default="e2e/data/real/english_01.wav")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch

    from ..ops import _build
    parts = {}
    t0 = time.perf_counter()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    parts["cuda_context_s"] = time.perf_counter() - t0
    if args.build_dir:
        _build.BUILD_DIR = Path(args.build_dir)
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    empty = not any(_build.BUILD_DIR.glob("*.so"))
    popen, compiler_runs = subprocess.Popen, []

    def counted(cmd, *a, **k):      # the compiler processes the build starts
        compiler_runs.append(os.path.basename(str(cmd[0])))
        return popen(cmd, *a, **k)

    subprocess.Popen = counted
    t0 = time.perf_counter()
    try:
        _build.build(names)
        _build.build_host("audio_dsp")
    finally:
        subprocess.Popen = popen
    parts["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in names:
        _build.load(name)
    from ..audio import native
    native.get_lib()
    parts["load_libraries_s"] = time.perf_counter() - t0

    from ..audio.codec import decode_audio
    from ..runtime.lifecycle import load_engine
    t0 = time.perf_counter()
    engine = load_engine(args.model, device="cuda")
    torch.cuda.synchronize()
    parts["load_engine_s"] = time.perf_counter() - t0
    parts.update(engine.load_parts)
    rng = np.random.default_rng(42)
    keys = {}
    for sec in [float(x) for x in args.buckets.split(",") if x]:
        noise = (rng.standard_normal(int(16000 * (sec - 0.5)))
                 .astype(np.float32) * 0.01)
        engine.transcribe(noise, 16000, language="en")
        keys[f"{sec:g}s_b1"] = engine.last_run["capture_s"]
    parts["captures_s"] = keys
    with open(args.clip, "rb") as f:
        audio, sr = decode_audio(f.read())
    t0 = time.perf_counter()
    res = engine.transcribe(audio, sr, language="en")
    torch.cuda.synchronize()
    parts["first_upload_s"] = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    out = {"model": args.model, "quantize": os.getenv("QUANTIZE", ""),
           "kv": os.getenv("ASR_KV_CACHE_DTYPE", ""),
           "cache": bool(os.getenv("ASR_AOT_CACHE_DIR")),
           "build_dir_empty": empty, "compiler_runs": len(compiler_runs),
           "parts": parts,
           "total_s": time.perf_counter() - t_start,
           "token_ids": [r.token_ids for r in res]}
    print(card)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
