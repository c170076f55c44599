"""Overfit a small checkpoint on a handful of real clips.

Counterpart of ``qwen3_asr_tpu/tools/overfit.py``: it produces a
non-degenerate checkpoint that emits real transcripts through the whole
serving stack (the e2e accuracy tiers), where the released weights cannot
be downloaded. The model is tiny and memorizes the given clips.

    python -m qwen3_asr_tpu_torch.tools.overfit --data-dir e2e/data/real \\
        --output /tmp/trained_ckpt

Data layout: <name>.wav + <name>.txt (+ <name>.lang). The output is an
HF-layout checkpoint (config.json, model.safetensors, tokenizer.json) plus
``overfit_manifest.json``, the marker the e2e accuracy gate reads.

Without ``--tokenizer`` it trains a byte-level BPE on the transcripts and
the prompt text, as the JAX tool does with the ``tokenizers`` package, with
the port's own trainer (``text/bpe_train.py``: the same vocabulary and
merges); ``--tokenizer`` reuses an existing one (a draft paired with a main
checkpoint needs its ids). It runs on the card in f32 unless
``--device cpu`` is given. The weights are drawn from ``--seed`` with
torch's generator, so they are not the JAX tool's.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import tempfile
import time
from pathlib import Path

log = logging.getLogger(__name__)


def collect_clips(data_dir: str):
    """[(wav_path, text, lang_code)] from an ASR_E2E_DATA-layout dir."""
    rows = []
    for wav in sorted(Path(data_dir).glob("*.wav")):
        txt = wav.with_suffix(".txt")
        if not txt.exists():
            continue
        lang_f = wav.with_suffix(".lang")
        lang = lang_f.read_text().strip() if lang_f.exists() else "en"
        rows.append((str(wav), txt.read_text().strip(), lang))
    return rows


SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>",
            "<|AUDIO|>", "<|audio_bos|>", "<|audio_eos|>"]


def build_tokenizer(texts, out_path: str, vocab_size: int = 2048) -> None:
    """Byte-level BPE trained on the target transcripts (+ prompt text),
    on the JAX tool's corpus."""
    from ..models.asr import LANGUAGE_NAMES
    from ..text.bpe_train import byte_alphabet, train_bpe, write_tokenizer

    corpus = list(texts) * 20
    corpus += [f"Language: {name}\n" for name in LANGUAGE_NAMES.values()] * 5
    corpus += ["You are a speech recognition model.",
               "system", "user", "assistant"] * 5
    vocab, merges = train_bpe(corpus, vocab_size, SPECIALS, byte_alphabet())
    write_tokenizer(out_path, vocab, merges, SPECIALS)


_ENCODERS = {
    "draft": dict(num_mel_bins=32, d_model=64, encoder_layers=2,
                  encoder_attention_heads=4, encoder_ffn_dim=128,
                  output_dim=96, downsample_hidden_size=16),
    "base": dict(num_mel_bins=32, d_model=96, encoder_layers=3,
                 encoder_attention_heads=4, encoder_ffn_dim=256,
                 output_dim=192, downsample_hidden_size=16),
    "medium": dict(num_mel_bins=128, d_model=512, encoder_layers=8,
                   encoder_attention_heads=8, encoder_ffn_dim=2048,
                   output_dim=896, downsample_hidden_size=128),
    "large": dict(num_mel_bins=128, d_model=768, encoder_layers=10,
                  encoder_attention_heads=12, encoder_ffn_dim=3072,
                  output_dim=1280, downsample_hidden_size=128),
}
_DECODERS = {
    "draft": dict(hidden_size=96, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=24),
    "base": dict(hidden_size=192, intermediate_size=512,
                 num_hidden_layers=4, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=48),
    "medium": dict(hidden_size=896, intermediate_size=2432,
                   num_hidden_layers=10, num_attention_heads=14,
                   num_key_value_heads=2, head_dim=64),
    "large": dict(hidden_size=1280, intermediate_size=3456,
                  num_hidden_layers=16, num_attention_heads=10,
                  num_key_value_heads=2, head_dim=128),
}


def build_config(vocab_size: int, specials: dict, size: str = "base"):
    """The proof-checkpoint architectures, by ``size``: ``draft`` (~2 M, the
    speculative companion), ``base`` (~8 M), ``medium`` (~110 M, the real
    model's structural shape: GQA, 64-dim heads) and ``large`` (~350 M,
    128-dim heads, a 1280-wide decoder)."""
    from ..models.config import AsrConfig, AudioEncoderConfig, DecoderConfig
    return AsrConfig(
        encoder=AudioEncoderConfig(
            n_window=50, n_window_infer=200, conv_chunksize=500,
            max_source_positions=1500, **_ENCODERS[size]),
        decoder=DecoderConfig(
            vocab_size=vocab_size, rms_norm_eps=1e-6,
            rope_theta=1_000_000.0, tie_word_embeddings=True,
            **_DECODERS[size]),
        audio_token_id=specials["<|AUDIO|>"],
        bos_token_id=specials["<|endoftext|>"],
        eos_token_id=specials["<|im_end|>"],
        pad_token_id=specials["<|endoftext|>"],
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", default="e2e/data/real")
    parser.add_argument("--output", required=True)
    parser.add_argument("--max-steps", type=int, default=1500)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--eval-every", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--force", action="store_true",
                        help="retrain even if the output already exists")
    parser.add_argument("--draft", action="store_true",
                        help="half-size architecture (speculative draft)")
    parser.add_argument("--size", default=None,
                        choices=["draft", "base", "medium", "large"],
                        help="architecture tier (default: base, or draft "
                             "when --draft is given)")
    parser.add_argument("--microbatch", type=int, default=None,
                        help="gradient-accumulation chunk rows (default: 4 "
                             "for --size large, else full-batch); the "
                             "accumulation is update-exact")
    parser.add_argument("--tokenizer", default=None,
                        help="reuse an existing tokenizer.json (needed for "
                             "a draft paired with a main checkpoint: "
                             "token-level speculation needs shared ids)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu; f32 on both")
    args = parser.parse_args(argv)

    manifest_path = os.path.join(args.output, "overfit_manifest.json")
    if os.path.exists(manifest_path) and not args.force:
        print(f"checkpoint already trained at {args.output} "
              "(use --force to retrain)")
        return

    import numpy as np
    import torch

    from ..audio.codec import decode_audio, encode_wav
    from ..audio.frontend import fir_bandpass_kernel, fir_same
    from ..audio.resample import resample
    from ..models.asr import AsrModel, PromptTemplate
    from ..models.decoder import init_decoder_params
    from ..models.encoder import init_encoder_params
    from ..runtime.checkpoint import save_asr_checkpoint
    from ..runtime.engine import TranscriptionEngine, max_new_tokens_for
    from ..runtime.optim import (adamw, chain, clip_by_global_norm,
                                 tree_leaves, tree_map,
                                 warmup_cosine_decay_schedule)
    from ..runtime.train import init_train_state, make_train_step
    from ..serving.ws import WS_FLUSH_SILENCE_MS, WS_WINDOW_MAX_S
    from ..text.tokenizer import BpeTokenizer
    from ..utils.device import resolve_device
    from ..utils.logging import setup_logging
    from ..utils.metrics import cer
    from .finetune import make_batch

    setup_logging()
    dev = resolve_device(args.device)
    rows = collect_clips(args.data_dir)
    if not rows:
        raise SystemExit(f"no wav/txt pairs under {args.data_dir}")
    log.info("Overfitting on %d clips from %s", len(rows), args.data_dir)

    os.makedirs(args.output, exist_ok=True)
    tok_path = os.path.join(args.output, "tokenizer.json")
    if args.tokenizer:
        if os.path.abspath(args.tokenizer) != os.path.abspath(tok_path):
            shutil.copyfile(args.tokenizer, tok_path)
    else:
        build_tokenizer([t for _, t, _ in rows], tok_path)
    tokenizer = BpeTokenizer.from_file(tok_path)
    with open(tok_path) as f:
        specials = {t["content"]: t["id"]
                    for t in json.load(f)["added_tokens"]}
    size = args.size or ("draft" if args.draft else "base")
    cfg = build_config(max(2048, tokenizer.vocab_size), specials, size=size)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = {
        "encoder": init_encoder_params(cfg.encoder, gen, dev, torch.float32),
        "decoder": init_decoder_params(cfg.decoder, gen, dev, torch.float32),
    }
    # the engine serves its own copy, refreshed from the trained params
    model = AsrModel(cfg, tree_map(torch.clone, params), tokenizer,
                     template=PromptTemplate())
    engine = TranscriptionEngine(model, device=dev, dtype=torch.float32)

    # Clips grouped by their serve-time bucket, so training sees the
    # zero-padded mel serving computes. Each clip gives three rows: the
    # clean clip under its language prompt, the same under the
    # no-language prompt (the auto-detect path), and its WS flush shape
    # (the band-passed last window plus the flush silence).
    crop_dir = tempfile.mkdtemp(prefix="overfit_ws_")
    bp_kernel = fir_bandpass_kernel()
    items, by_bucket = [], {}

    def add_item(wav_path, text, lang, n_samples):
        _, bucket_s = engine.bucket_frames(n_samples)
        budget = max_new_tokens_for(bucket_s)
        ids = tokenizer.encode(text)
        expected, strict = text, True
        if len(ids) + 1 > budget:
            # the bucket's decode budget cannot hold the transcript: the
            # achievable output is the truncated prefix, scored but not
            # counted toward the early stop
            expected = tokenizer.decode(ids[:budget - 1]).strip()
            strict = False
            log.warning("%s: transcript needs %d tokens > bucket budget %d;"
                        " evaluating against the achievable prefix",
                        wav_path, len(ids) + 1, budget)
        item = {"wav": wav_path, "text": text, "language": lang}
        items.append((item, expected, lang, strict))
        by_bucket.setdefault(bucket_s, []).append(item)

    for wav, text, lang in rows:
        with open(wav, "rb") as f:
            audio, sr = decode_audio(f.read())
        add_item(wav, text, lang, int(len(audio) * 16000 / sr))
        add_item(wav, text, None, int(len(audio) * 16000 / sr))
        if sr != 16000:
            audio = resample(audio, sr, 16000)
        window = audio[-int(WS_WINDOW_MAX_S * 16000):].astype(np.float32)
        padded = np.concatenate(
            [window,
             np.zeros(int(WS_FLUSH_SILENCE_MS / 1000 * 16000), np.float32)])
        ws_shape = fir_same(padded, bp_kernel)
        crop_path = os.path.join(crop_dir, "ws_" + os.path.basename(wav))
        with open(crop_path, "wb") as f:
            f.write(encode_wav(ws_shape, 16000))
        add_item(crop_path, text, lang, len(ws_shape))

    log.info("Bucket groups: %s", {k: len(v) for k, v in by_bucket.items()})
    batches = [(bucket_s, make_batch(engine, group, bucket_s))
               for bucket_s, group in sorted(by_bucket.items())]

    # Upweight the first transcript tokens: greedy decoding picks which
    # memorized transcript to follow at the first token, where teacher
    # forcing gives no exposure.
    for _, batch in batches:
        w = batch["target_mask"].astype(np.float32)
        for r in range(w.shape[0]):
            nz = np.nonzero(w[r])[0]
            if len(nz):
                w[r, nz[0]:nz[0] + 4] *= 8.0
        batch["target_mask"] = w

    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.lr, warmup_steps=30,
        decay_steps=args.max_steps * len(batches), end_value=1e-5)
    optimizer = chain(clip_by_global_norm(1.0), adamw(schedule))
    state = init_train_state(params, optimizer)
    micro = args.microbatch if args.microbatch is not None else (
        4 if size == "large" else 0)
    step_fn = make_train_step(cfg, optimizer, microbatch=micro)
    n_strict = sum(1 for _, _, _, strict in items if strict)

    def serve_params() -> None:
        # into the engine's own tensors: on the card its CUDA graphs
        # captured their addresses
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), model.params,
                     state.params)

    def eval_exact() -> tuple:
        """Greedy-decode every clip through the engine: (strict rows
        exact, the worst (name, CER)); budget-truncated rows score
        against their achievable prefix and never count as strict."""
        serve_params()
        n_ok, worst = 0, ("", 0.0)
        for item, expected, lang, strict in items:
            with open(item["wav"], "rb") as f:
                audio, sr = decode_audio(f.read())
            res = engine.transcribe(audio, sr, language=lang)
            got = " ".join(r.text for r in res).strip()
            c = cer(expected, got)
            if strict and got == expected:
                n_ok += 1
            if c >= worst[1]:
                worst = (os.path.basename(item["wav"]), c)
        return n_ok, worst

    t_start = time.time()
    done_reason = "max_steps"
    for step in range(1, args.max_steps + 1):
        losses = []
        for _, batch in batches:
            state, loss = step_fn(state, batch)
            losses.append(float(loss))
        if step % 10 == 0:
            log.info("step %d | loss %s | %.0fs", step,
                     " ".join(f"{x:.4f}" for x in losses),
                     time.time() - t_start)
        if step % args.eval_every == 0 or max(losses) < 5e-3:
            n_ok, worst = eval_exact()
            log.info("eval @ step %d: %d/%d exact (worst %s CER %.1f%%)",
                     step, n_ok, n_strict, worst[0], 100 * worst[1])
            if n_ok == n_strict:
                done_reason = f"all {n_ok} strict-exact at step {step}"
                break

    serve_params()
    save_asr_checkpoint(args.output, cfg, state.params)
    final_ok, final_worst = eval_exact()
    with open(manifest_path, "w") as f:
        json.dump({
            "purpose": "e2e real-text checkpoint (memorizes the listed "
                       "clips; NOT a general ASR model)",
            "data_dir": os.path.abspath(args.data_dir),
            "clips": sorted({os.path.basename(i["wav"])
                             for i, _, _, _ in items}),
            "auto_prompt_rows": True,
            "size": size,
            "n_params": int(sum(p.numel()
                                for p in tree_leaves(state.params))),
            "exact": final_ok, "total_strict": n_strict,
            "total": len(items),
            "worst_cer": round(final_worst[1], 4),
            "steps_reason": done_reason,
            "train_seconds": round(time.time() - t_start, 1),
        }, f, indent=1)
    log.info("Saved trained checkpoint to %s (%s; %d/%d exact)",
             args.output, done_reason, final_ok, len(items))


if __name__ == "__main__":
    main()
