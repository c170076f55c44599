"""Fine-tuning CLI: audio-conditioned LM training of a checkpoint.

Counterpart of ``qwen3_asr_tpu/tools/finetune.py``: a minimal trainer
around ``runtime/train.py`` for adapting checkpoints. Data format: a
manifest of ``{"wav": path, "text": transcript}`` JSON lines (an optional
``"language"``). The result is an HF-layout checkpoint directory
(``save_asr_checkpoint``, with the source's tokenizer and chat template)
that ``MODEL_ID`` can point at.

    python -m qwen3_asr_tpu_torch.tools.finetune \\
        --model-id /ckpt --manifest data.jsonl --steps 100 --lr 1e-5

It runs on the card (bf16) unless ``--device cpu`` is given (f32).
Data parallelism (``--dp`` above 1) is not ported (ROADMAP item 14).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import time

import numpy as np
import torch

log = logging.getLogger(__name__)

_SOURCE_FILES = ("tokenizer.json", "tokenizer_config.json",
                 "chat_template.jinja")


def make_batch(engine, items, bucket_s: float = 6.0) -> dict:
    """Manifest rows → a padded training batch of numpy arrays: mel
    [B, n_mels, frames] f32, feature_lens, prompt_ids left-padded to
    ``PREFIX_BUDGET`` with ``valid_from`` their first real index, and
    target_ids / target_mask at the bucket's static budget (the prompt
    suffix, then the transcript and EOS; the suffix is context, mask 0).
    The same arrays as the JAX package's ``make_batch``."""
    from ..audio.codec import decode_audio
    from ..audio.frontend import HOP_LENGTH
    from ..audio.resample import resample
    from ..runtime.engine import PREFIX_BUDGET, max_new_tokens_for

    model = engine.model
    chunk = model.cfg.encoder.n_window * 2
    frames = int(bucket_s * 100)
    frames = ((frames + chunk - 1) // chunk) * chunk
    n_samples = frames * HOP_LENGTH

    mels, prompts, targets, n_ctx = [], [], [], []
    # Targets start with the prompt SUFFIX (mask 0): inference decodes
    # after [prefix, audio, suffix], so training conditions the transcript
    # on the same layout. Shapes are static: prompts pad to PREFIX_BUDGET,
    # targets to the suffix plus the bucket's decode budget.
    _, suffix_ids, _ = model.prompt_ids(0, None)
    tgt_budget = len(suffix_ids) + max_new_tokens_for(frames / 100.0)
    for item in items:
        with open(item["wav"], "rb") as f:
            audio, sr = decode_audio(f.read())
        if sr != 16000:
            audio = resample(audio, sr, 16000)
        padded = np.zeros(n_samples, dtype=np.float32)
        padded[:min(len(audio), n_samples)] = audio[:n_samples]
        mel, _ = engine.frontend(torch.from_numpy(padded)[None].to(
            engine.device))
        mels.append(mel[0].cpu().numpy())

        prefix, _, _ = model.prompt_ids(0, item.get("language"))
        prefix = prefix[-PREFIX_BUDGET:]
        prompts.append(prefix)
        text_ids = model.tokenizer.encode(item["text"]) + [model.eos_id]
        tgt = (list(suffix_ids) + text_ids)[:tgt_budget]
        targets.append(tgt)
        n_ctx.append(min(len(suffix_ids), len(tgt)))

    b = len(items)
    batch = {
        "mel": np.stack(mels).astype(np.float32),
        "feature_lens": np.full((b,), frames, np.int32),
        "prompt_ids": np.full((b, PREFIX_BUDGET), model.pad_id, np.int32),
        "target_ids": np.full((b, tgt_budget), model.pad_id, np.int32),
        "target_mask": np.zeros((b, tgt_budget), np.int32),
        "valid_from": np.zeros((b,), np.int32),
    }
    for i, (p, t) in enumerate(zip(prompts, targets)):
        batch["prompt_ids"][i, -len(p):] = p
        batch["valid_from"][i] = PREFIX_BUDGET - len(p)
        batch["target_ids"][i, :len(t)] = t
        batch["target_mask"][i, n_ctx[i]:len(t)] = 1  # suffix is context
    return batch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-id", default=os.getenv("MODEL_ID"))
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--bucket-s", type=float, default=6.0)
    parser.add_argument("--output", default="finetuned")
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel width: only 1 (one device)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default, bf16) or cpu (f32)")
    args = parser.parse_args(argv)
    if args.dp not in (None, 1):
        parser.error(f"--dp {args.dp}: data parallelism is not ported "
                     "(ROADMAP item 14); run with --dp 1 or without it")
    if not args.model_id:
        parser.error("--model-id (or MODEL_ID) is required")

    from ..runtime.checkpoint import save_asr_checkpoint
    from ..runtime.lifecycle import load_engine
    from ..runtime.optim import adamw
    from ..runtime.train import init_train_state, make_train_step
    from ..utils.logging import setup_logging

    setup_logging()
    if os.getenv("QUANTIZE"):
        # load_engine would quantize the weights: gradients need float
        # weights, so the flag is dropped for this process
        log.warning("QUANTIZE=%s ignored for fine-tuning (float weights "
                    "required)", os.environ.pop("QUANTIZE"))
    engine = load_engine(args.model_id, device=args.device)
    model = engine.model

    with open(args.manifest) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    log.info("Fine-tuning on %d clips for %d steps", len(rows), args.steps)

    optimizer = adamw(args.lr)
    state = init_train_state(model.params, optimizer)
    step_fn = make_train_step(model.cfg, optimizer)
    for step in range(args.steps):
        items = [rows[(step * args.batch_size + i) % len(rows)]
                 for i in range(args.batch_size)]
        batch = make_batch(engine, items, args.bucket_s)
        t0 = time.time()
        state, loss = step_fn(state, batch)
        log.info("step %d | loss %.4f | %.2fs", step, float(loss),
                 time.time() - t0)

    save_asr_checkpoint(args.output, model.cfg, state.params)
    if os.path.isdir(args.model_id):
        # the tokenizer and chat template come from the source checkpoint
        for name in _SOURCE_FILES:
            src = os.path.join(args.model_id, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(args.output, name))
    log.info("Saved servable fine-tuned checkpoint to %s", args.output)


if __name__ == "__main__":
    main()
