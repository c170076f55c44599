"""Forced aligner: word-level timestamps from encoder-similarity alignment.

Counterpart of ``qwen3_asr_tpu/sidecars/aligner.py``. The checkpoint's
audio encoder gives per-token acoustic embeddings in the decoder's
embedding space (its proj2 maps into it), the target text is embedded with
the decoder's token table, and a forced-alignment Viterbi partition over
their cosine similarity gives each text token an exclusive span of
acoustic frames (silence edges trimmed); word edges are then refined below
the 80 ms frame grid by a least-squares fit of the partial-occupancy model
around each boundary (``_fit_boundary``, ``_fractional_edges``).

Device work is the encoder (``models/encoder.py`` ``encoder_forward``, run
eagerly once a call: its window attention is the flash kernel on the card)
and the token table's gather; both come back to the host as f32, and the
similarity, the partition and the edge fit are the JAX package's numpy,
copied here. The audio is padded to the engine's bucket ladder and, above
its largest bucket, to 30 s steps (the subtitle layer cuts audio into
calls of at most 300 s), so the encoder sees few shapes.

``FORCED_ALIGNER_ID`` may name any ASR-format checkpoint directory (a
dedicated aligner checkpoint or the serving model itself); ``load`` reads
it at full precision (``QUANTIZE`` does not apply), bf16 on the card and
f32 on the CPU, as JAX loads bf16 on the TPU and f32 elsewhere.
``AlignerEngine(model)`` takes an ``AsrModel`` already loaded, on the
device its weights are on.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class AlignedWord:
    text: str
    start: float
    end: float


class AlignerEngine:
    FRAME_SECONDS = 0.08  # one encoder token per 8 mel frames (80 ms)

    def __init__(self, model):
        from ..audio.frontend import LogMelFrontend
        self.model = model
        proj = model.params["encoder"]["proj1_w"]
        self.device, self.dtype = proj.device, proj.dtype
        self.frontend = LogMelFrontend(n_mels=model.cfg.encoder.num_mel_bins,
                                       device=self.device)

    @staticmethod
    def load(model_id: str, device=None, dtype=None) -> "AlignerEngine":
        """The aligner of checkpoint directory ``model_id`` on ``device``
        (the card unless asked for the CPU), in ``dtype`` (bf16 on the
        card and f32 on the CPU unless given)."""
        if not os.path.isdir(model_id):
            raise FileNotFoundError(
                f"FORCED_ALIGNER_ID '{model_id}' is not a local checkpoint "
                "directory (no network egress — mount the weights).")
        from ..models.asr import AsrModel
        from ..runtime.checkpoint import load_asr_checkpoint
        from ..text.tokenizer import BpeTokenizer
        from ..utils.device import resolve_device, working_dtype
        dev = resolve_device(device)
        cfg, params = load_asr_checkpoint(model_id, dev,
                                          dtype or working_dtype(dev))
        tok = BpeTokenizer.from_file(os.path.join(model_id, "tokenizer.json"))
        return AlignerEngine(AsrModel(cfg, params, tok))

    def mel_frames(self, n_samples: int) -> int:
        """Mel frames the encoder runs for ``n_samples`` at 16 kHz: the
        engine's smallest bucket that holds them, else 30 s steps, rounded
        up to the encoder chunk."""
        from ..runtime.engine import AUDIO_BUCKETS_S
        chunk = self.model.cfg.encoder.n_window * 2
        need = max(chunk, -(-n_samples // 160))
        for sec in AUDIO_BUCKETS_S:
            frames = ((int(sec * 100) + chunk - 1) // chunk) * chunk
            if need <= frames:
                return frames
        frames = ((need + 2999) // 3000) * 3000
        return ((frames + chunk - 1) // chunk) * chunk

    @torch.inference_mode()
    def encode(self, audio: np.ndarray) -> np.ndarray:
        """f32 mono 16 kHz audio → the acoustic token embeddings of its
        padded length, [encoder tokens, output_dim] f32 on the host."""
        from ..models.encoder import encoder_forward
        mel_frames = self.mel_frames(len(audio))
        padded = np.zeros(mel_frames * 160, dtype=np.float32)
        padded[:len(audio)] = audio[:len(padded)]
        mel, _ = self.frontend(torch.from_numpy(padded)[None].to(self.device))
        lens = torch.full((1,), mel_frames, dtype=torch.int32,
                          device=self.device)
        acoustic, tok_lens = encoder_forward(
            self.model.params["encoder"], self.model.cfg.encoder,
            mel.to(self.dtype), lens)
        n = int(tok_lens[0])
        return acoustic[0, :n].float().cpu().numpy()

    @torch.inference_mode()
    def embed_text(self, ids: List[int]) -> np.ndarray:
        """Token ids → their rows of the decoder's table, [n, H] f32."""
        from ..models.decoder import embed_tokens
        t = torch.tensor(ids, dtype=torch.int64, device=self.device)[None]
        return embed_tokens(self.model.params["decoder"], t,
                            self.model.cfg.decoder)[0].float().cpu().numpy()

    # -- alignment ---------------------------------------------------------------
    def similarity(self, audio: np.ndarray, sr: int, text: str):
        """The alignment's inputs: (words, each word's token ids, the
        cosine similarity [n_tokens, n_frames] f32 of text tokens to
        acoustic frames, the clip's seconds); None when there is nothing
        to align."""
        from ..audio.resample import resample
        from .subtitle import _is_cjk, _tokenize

        audio = np.asarray(audio)
        if audio.dtype == np.int16:  # wire-format PCM → [-1, 1] float
            audio = audio.astype(np.float32) / 32768.0
        audio = audio.astype(np.float32, copy=False)
        if sr != 16000:
            audio = resample(audio, sr, 16000)
            sr = 16000
        words = _tokenize(text)
        if not words or len(audio) == 0:
            return None

        acoustic = self.encode(audio)
        duration = len(audio) / sr
        n_frames = max(1, min(len(acoustic),
                              int(np.ceil(duration / self.FRAME_SECONDS))))
        acoustic = acoustic[:n_frames]

        # Text token embeddings from the decoder table. Tokens are encoded
        # exactly as they appear in the running transcript: the subtitle
        # layer joins CJK tokens with no separator (subtitle.py joiner=""),
        # so a leading space there would inject whitespace tokens that have
        # no acoustic counterpart and steal frames from real words.
        joiner = "" if _is_cjk(text) else " "
        word_ids = [self.model.tokenizer.encode(
            w if i == 0 else joiner + w, allow_special=False) or [0]
            for i, w in enumerate(words)]
        text_emb = self.embed_text([i for ids in word_ids for i in ids])

        a = acoustic / (np.linalg.norm(acoustic, axis=-1, keepdims=True) + 1e-6)
        t = text_emb / (np.linalg.norm(text_emb, axis=-1, keepdims=True) + 1e-6)
        return words, word_ids, t @ a.T, duration

    def align(self, audio: np.ndarray, sr: int, text: str, language: str
              ) -> List[AlignedWord]:
        found = self.similarity(audio, sr, text)
        if found is None:
            return []
        words, word_ids, sim, duration = found
        spans = _token_spans(sim)                        # [n_tokens, 2]
        # Fixed 80 ms encoder grid — NOT duration/n_frames: the ceil'd
        # frame count would uniformly compress every timestamp by up to
        # one frame across the clip (the end-of-clip clamp below handles
        # the final partial frame).
        return _spans_to_words(words, word_ids, spans, self.FRAME_SECONDS,
                               duration, sim=sim)


def _viterbi_partition(sim: np.ndarray) -> np.ndarray:
    """Forced-alignment Viterbi: partition ALL frames among the tokens,
    in order, maximizing summed per-frame similarity. Returns
    entry[i] = first frame owned by token i (strictly increasing).

    cost[i,j] = sim[i,j] + max(cost[i,j-1], cost[i-1,j-1]) — the in-row
    j-1 recurrence collapses to a cumsum + running max per row:
    cost[i,j] = S[j] + max_{k<=j}(cost[i-1,k-1] - S[k-1]), S = cumsum(sim[i]).
    """
    n_tok, n_frames = sim.shape
    if n_tok == 0:
        return np.zeros(0, np.int32)
    if n_tok > n_frames:  # degenerate: more tokens than frames
        return (np.arange(n_tok) * n_frames // n_tok).astype(np.int32)
    NEG = np.float32(-1e9)
    idx = np.arange(n_frames, dtype=np.int32)
    entry = np.zeros((n_tok, n_frames), np.int32)   # chosen k per (i, j)
    prev = np.cumsum(sim[0], dtype=np.float32)      # token 0 owns 0..j
    for i in range(1, n_tok):
        s = np.cumsum(sim[i], dtype=np.float32)
        # v[k] = cost[i-1, k-1] - S[k-1]; k=0 invalid (token i-1 needs a frame)
        v = np.concatenate(([NEG], prev[:-1] - s[:-1]))
        run = np.maximum.accumulate(v)
        is_new = v >= run                            # ties → later entry
        entry[i] = np.maximum.accumulate(np.where(is_new, idx, 0))
        prev = s + run
    entries = np.zeros(n_tok, np.int32)
    j = n_frames - 1
    for i in range(n_tok - 1, 0, -1):
        entries[i] = entry[i, j]
        j = entries[i] - 1
    return entries


def _token_spans(sim: np.ndarray, trim_frac: float = 0.3) -> np.ndarray:
    """Token → inclusive [first, last] frame spans.

    The Viterbi partition assigns every frame to a token, so a word before
    a silence gap would otherwise stretch across the silence. Trim span
    edges whose similarity falls below min + trim_frac*(max-min) within
    the span — clear-silence frames sit near the span minimum while real
    speech frames stay above it."""
    n_tok, n_frames = sim.shape
    entries = _viterbi_partition(sim)
    spans = np.zeros((n_tok, 2), np.int32)
    for i in range(n_tok):
        lo = int(entries[i])
        hi = int(entries[i + 1]) - 1 if i + 1 < n_tok else n_frames - 1
        hi = max(lo, hi)
        row = sim[i, lo:hi + 1]
        thr = row.min() + trim_frac * (row.max() - row.min())
        keep = np.nonzero(row >= thr)[0]
        if len(keep):
            lo, hi = lo + int(keep[0]), lo + int(keep[-1])
        spans[i] = (lo, hi)
    return spans


_B_GRID = 1.0 / 64  # boundary search resolution, frames (1.25 ms at 80 ms)


def _fit_boundary(measurements, b_lo: float, b_hi: float) -> float:
    """Least-squares sub-frame boundary position.

    ``measurements`` is a list of (value, plateau, side, frame): observed
    similarity of one token in one frame, the token's full-occupancy
    plateau, and which side of the boundary the token lies on ('left' =
    token covers time before the boundary). The occupancy model is
    value ≈ plateau · coverage(frame; b) with coverage = clip(b - frame)
    for left tokens and clip(frame + 1 - b) for right tokens. Grid-search
    b over [b_lo, b_hi] minimizing the summed squared residual across ALL
    measurements: every frame the boundary could touch, from both adjacent
    tokens, constrains the same scalar, which is what makes this robust to
    per-frame noise where a single edge-frame ratio is not."""
    bs = np.arange(b_lo, b_hi + 1e-9, _B_GRID, dtype=np.float32)
    sse = np.zeros_like(bs)
    for value, plateau, side, frame in measurements:
        if side == "left":
            cov = np.clip(bs - frame, 0.0, 1.0)
        else:
            cov = np.clip(frame + 1.0 - bs, 0.0, 1.0)
        r = value - plateau * cov
        sse += r * r
    return float(bs[int(np.argmin(sse))])


def _fractional_edges(sim: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """Sub-frame token edges from partial-occupancy similarity.

    A token boundary falling INSIDE a frame leaves a partial-occupancy
    signature — that frame's similarity to the token is proportional to
    how much of the frame the token actually covers, and frames wholly
    inside/outside the token sit at the plateau / at zero. Each boundary
    is recovered by a joint least-squares fit of that occupancy model
    (_fit_boundary) over a ±1-frame window: a boundary SHARED by adjacent
    tokens is fit once from BOTH tokens' rows, while an edge at real
    silence is fit from the one row against a zero-outside model.
    Returns float [n_tok, 2] in frame units, end exclusive."""
    n_tok, n_frames = sim.shape
    plateaus = np.zeros(n_tok, np.float32)
    for i, (lo, hi) in enumerate(spans):
        # Plateau = typical full-occupancy strength. Median of the interior
        # (edge frames excluded — they're the partial ones being measured)
        # resists per-frame noise; short spans fall back to the max.
        interior = sim[i, lo + 1:hi]
        plateaus[i] = (float(np.median(interior)) if interior.size >= 2
                       else float(sim[i, lo:hi + 1].max()))

    edges = np.asarray(spans, np.float32).copy()
    edges[:, 1] += 1.0  # grid default: [lo, hi+1)

    def _single(i: int, side: str, b_lo: float, b_hi: float) -> float:
        """One token's edge against silence: fit its own row, zero model
        outside the token (silence frames carry ~0 similarity)."""
        w_lo = max(0, int(np.floor(b_lo)) - 1)
        w_hi = min(n_frames - 1, int(np.ceil(b_hi)))
        meas = [(float(sim[i, j]), plateaus[i], side, float(j))
                for j in range(w_lo, w_hi + 1)]
        return _fit_boundary(meas, b_lo, b_hi)

    # A trim-induced hole of ≤ GAP_JOINT frames between spans is treated as
    # a shared boundary (the joint fit recovers where in the hole it falls);
    # larger holes are real silence and each side fits independently.
    GAP_JOINT, WIDE = 1, 2.0
    for i in range(n_tok):
        lo, hi = int(spans[i, 0]), int(spans[i, 1])
        if plateaus[i] <= 1e-6:
            continue
        prev_gap = lo - int(spans[i - 1, 1]) - 1 if i > 0 else n_frames
        next_gap = int(spans[i + 1, 0]) - hi - 1 if i + 1 < n_tok else n_frames
        # -- start edge (silence side only; shared edges are set by the
        # previous token's end fit) ---------------------------------------
        if prev_gap > GAP_JOINT:
            # Utterance start or silence gap: the boundary may sit up to
            # WIDE frames before the span (trim removed mostly-empty
            # frames) or inside its first frame.
            floor = float(int(spans[i - 1, 1]) + 1) if i > 0 else 0.0
            edges[i, 0] = _single(i, "right", max(floor, lo - WIDE), lo + 1.0)
        # -- end edge ------------------------------------------------------
        if i + 1 < n_tok and next_gap <= GAP_JOINT and plateaus[i + 1] > 1e-6:
            # Shared boundary: joint fit over both tokens' rows, searched
            # across both edge frames and the trim hole between them.
            nlo, nhi = int(spans[i + 1, 0]), int(spans[i + 1, 1])
            b_lo, b_hi = max(float(lo), hi - 1.0), min(float(nhi + 1),
                                                       nlo + 2.0)
            meas = []
            for j in range(max(lo, int(b_lo)), min(nhi, int(np.ceil(b_hi))) + 1):
                meas.append((float(sim[i, j]), plateaus[i], "left", float(j)))
                meas.append((float(sim[i + 1, j]), plateaus[i + 1],
                             "right", float(j)))
            b = _fit_boundary(meas, b_lo, b_hi)
            edges[i, 1] = edges[i + 1, 0] = b
        elif next_gap > GAP_JOINT:
            ceil = float(spans[i + 1, 0]) if i + 1 < n_tok else float(n_frames)
            edges[i, 1] = _single(i, "left", float(hi),
                                  min(ceil, hi + 1.0 + WIDE))
        edges[i, 1] = max(edges[i, 1], edges[i, 0] + 1e-3)
    return edges


def _spans_to_words(words: List[str], word_ids: List[List[int]],
                    spans: np.ndarray, frame_s: float,
                    duration: float, sim: np.ndarray = None
                    ) -> List[AlignedWord]:
    """Per-token frame spans → word-level [start, end) seconds. When
    ``sim`` is given, word edges use the sub-frame refinement (see
    _fractional_edges); otherwise they sit on the frame grid."""
    edges = _fractional_edges(sim, spans) if sim is not None else None
    out: List[AlignedWord] = []
    cursor = 0
    for w, ids in zip(words, word_ids):
        chunk = spans[cursor:cursor + len(ids)]
        if len(chunk) == 0:
            cursor += len(ids)
            continue
        if edges is not None:
            start = float(edges[cursor, 0]) * frame_s
            end = float(edges[cursor + len(ids) - 1, 1]) * frame_s
        else:
            start = float(chunk[0, 0]) * frame_s
            end = float(chunk[-1, 1] + 1) * frame_s
        cursor += len(ids)
        out.append(AlignedWord(w, round(min(start, duration), 3),
                               round(min(end, duration), 3)))
    # Enforce monotonic non-overlap.
    for prev, cur in zip(out, out[1:]):
        if cur.start < prev.end:
            cur.start = prev.end
        if cur.end < cur.start:
            cur.end = cur.start
    return out
