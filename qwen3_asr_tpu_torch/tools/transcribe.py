"""Offline batch transcription CLI: files in, text/JSON/SRT out.

Counterpart of ``qwen3_asr_tpu/tools/transcribe.py``, the serverless
counterpart of ``POST /v1/audio/transcriptions``: it drives the
``TranscriptionEngine`` directly (no HTTP), batching same-bucket clips into
single dispatches (``engine.transcribe_batch``), and sends files longer
than ``MAX_SEGMENT_S`` through ``engine.transcribe``'s silence-boundary
segmentation, as the server does:

    python -m qwen3_asr_tpu_torch.tools.transcribe clips/*.wav --language english
    python -m qwen3_asr_tpu_torch.tools.transcribe talk.flac --srt --timestamps
    MODEL_ID=/ckpt python -m qwen3_asr_tpu_torch.tools.transcribe a.wav --json

It runs on the card unless ``--device cpu`` is given (in bf16 there, unless
``--dtype float32``), and reads what the
port's lifecycle reads (``MODEL_ID``, ``QUANTIZE``, ``ASR_KV_CACHE_DTYPE``,
and ``FORCED_ALIGNER_ID`` for ``--srt-mode accurate``), so a tuned serving
configuration is a tuned CLI configuration. The JAX CLI's
``ASR_MESH_DP``/``ASR_MESH_TP`` have no counterpart yet: the port serves
on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m qwen3_asr_tpu_torch.tools.transcribe",
        description="Batch-transcribe audio files with the engine.")
    p.add_argument("files", nargs="+", help="audio files (wav/flac/mp3/ogg/"
                   "aiff/au; anything audio.codec decodes)")
    p.add_argument("--model", default=os.getenv("MODEL_ID"),
                   help="checkpoint dir or preset:<name> (default $MODEL_ID)")
    p.add_argument("--language", default=None,
                   help="full language name or code (e.g. english, zh); "
                   "omit for auto-detect")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="one JSON object per file on stdout")
    p.add_argument("--timestamps", action="store_true",
                   help="include word timestamps (JSON output)")
    p.add_argument("--srt", action="store_true",
                   help="write a .srt next to each file (or --output-dir)")
    p.add_argument("--srt-mode", default="fast", choices=("fast", "accurate"),
                   help="subtitle timing: fast=char-proportional, accurate="
                   "forced aligner (needs FORCED_ALIGNER_ID)")
    p.add_argument("--output-dir", default=None,
                   help="write .txt/.srt artifacts here instead of beside "
                   "the inputs")
    p.add_argument("--batch-size", type=int,
                   default=int(os.getenv("ASR_CLI_BATCH", "16")),
                   help="max clips per dispatch (default 16)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   help="the weights' dtype (default: bfloat16 on the "
                   "card, float32 on the CPU)")
    return p.parse_args(argv)


def _out_paths(audio_paths, ext: str, output_dir):
    """Artifact path per input. Inside --output-dir, same-named inputs from
    different directories get disambiguated stems (clip.txt, clip_2.txt, ...)
    instead of overwriting each other."""
    out, used = {}, set()
    for path in audio_paths:
        if path in out:
            # a repeated argument: one artifact per input file
            continue
        stem = os.path.splitext(os.path.basename(path))[0]
        if output_dir:
            candidate, n = stem, 1
            while candidate in used:
                n += 1
                candidate = f"{stem}_{n}"
            used.add(candidate)
            os.makedirs(output_dir, exist_ok=True)
            out[path] = os.path.join(output_dir, candidate + ext)
        else:
            out[path] = os.path.join(
                os.path.dirname(path) or ".", stem + ext)
    return out


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if not args.model:
        print("error: no model — pass --model or set MODEL_ID",
              file=sys.stderr)
        return 2

    import torch

    from ..audio.codec import AudioDecodeError, decode_audio
    from ..runtime.engine import MAX_SEGMENT_S, TARGET_SR, _prep_audio
    from ..runtime.lifecycle import load_engine
    from ..serving.server import merge_results, merge_timestamps
    from ..text.repetition import detect_and_fix_repetitions
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    # Fail fast on a missing aligner checkpoint before the engine load: the
    # server degrades mid-request, a CLI exits with a clean message.
    if args.srt and args.srt_mode == "accurate":
        from ..sidecars import subtitle
        try:
            subtitle.load_aligner(device)
        except (OSError, ValueError) as e:
            print(f"error: --srt-mode accurate needs a loadable aligner "
                  f"checkpoint (FORCED_ALIGNER_ID="
                  f"{subtitle.FORCED_ALIGNER_ID}): {e}", file=sys.stderr)
            return 2

    t0 = time.time()
    engine = load_engine(args.model, device=device,
                         dtype=getattr(torch, args.dtype) if args.dtype
                         else None)
    load_s = time.time() - t0

    # Decode everything up front so batchable clips are known before the
    # first dispatch. Failures are reported per file, not fatal.
    clips, failures = {}, {}
    for path in args.files:
        try:
            with open(path, "rb") as fh:
                clips[path] = decode_audio(fh.read())
        except (OSError, AudioDecodeError) as e:
            failures[path] = str(e)

    # Prep once here (resample, mono, float); the engine's own _prep_audio
    # leaves 16 kHz mono arrays as they are.
    clips = {path: (_prep_audio(audio, sr), TARGET_SR)
             for path, (audio, sr) in clips.items()}
    # Word timestamps are not batchable (an aligner pass a clip), so
    # --timestamps sends every clip through the single-clip path.
    short, long_ = [], []
    for path, (audio, _) in clips.items():
        batchable = (len(audio) <= MAX_SEGMENT_S * TARGET_SR
                     and not args.timestamps)
        (short if batchable else long_).append(path)

    results = {}
    t1 = time.time()
    bs = max(1, args.batch_size)
    for i in range(0, len(short), bs):
        batch = short[i:i + bs]
        out = engine.transcribe_batch([clips[p] for p in batch],
                                      language=args.language)
        for path, res in zip(batch, out):
            results[path] = [res]
    for path in long_:
        audio, sr = clips[path]
        results[path] = engine.transcribe(audio, sr, language=args.language,
                                          return_timestamps=args.timestamps)
    infer_s = time.time() - t1

    audio_s = sum(len(a) / TARGET_SR for a, _ in clips.values())
    ok_files = [p for p in args.files if p not in failures]
    srt_paths = _out_paths(ok_files, ".srt", args.output_dir)
    txt_paths = _out_paths(ok_files, ".txt", args.output_dir)
    exit_code = 0
    for path in args.files:
        if path in failures:
            print(json.dumps({"file": path, "error": failures[path]})
                  if args.as_json else f"{path}: ERROR {failures[path]}",
                  file=sys.stderr)
            exit_code = 1
            continue
        res = results[path]
        # Clean each segment in place before any use, as the server's SRT
        # path does, so .srt and .txt agree.
        for r in res:
            r.text = detect_and_fix_repetitions(r.text)
        text, language = merge_results(res)
        record = {"file": path, "text": text, "language": language or None}
        if args.timestamps:
            record["words"] = merge_timestamps(res) or []
        if args.srt:
            from ..sidecars.subtitle import generate_srt_from_results
            audio, sr = clips[path]
            srt = generate_srt_from_results(res, audio, sr,
                                            mode=args.srt_mode)
            with open(srt_paths[path], "w") as fh:
                fh.write(srt)
            record["srt"] = srt_paths[path]
        if args.output_dir:
            with open(txt_paths[path], "w") as fh:
                fh.write(text + "\n")
            record["txt"] = txt_paths[path]
        print(json.dumps(record, ensure_ascii=False)
              if args.as_json else f"{path}\t{text}")

    print(f"[{len(results)}/{len(args.files)} files | {audio_s:.1f}s audio "
          f"in {infer_s:.2f}s ({audio_s / max(infer_s, 1e-9):.1f}x RT) | "
          f"model load {load_s:.1f}s]", file=sys.stderr)
    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
