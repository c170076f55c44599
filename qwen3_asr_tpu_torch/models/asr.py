"""Qwen3-ASR model assembly: config, weights, tokenizer and prompt template.

Counterpart of ``qwen3_asr_tpu/models/asr.py`` (``normalize_language``,
``PromptTemplate`` with its built-in prompt format, ``AsrModel``). The
built-in prompt, used by checkpoints that ship no chat template:

    <|im_start|>system\\n{context}<|im_end|>\\n
    <|im_start|>user\\n{Language: {name}\\n}<|audio_bos|><|AUDIO|>*N
    <|audio_eos|><|im_end|>\\n<|im_start|>assistant\\n

Rendering a checkpoint's own chat template is not ported yet: a checkpoint
that ships one raises ``NotImplementedError`` (ROADMAP §1, chat templates).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

from ..text.tokenizer import BpeTokenizer
from .config import AsrConfig

LANGUAGE_NAMES = {
    "en": "English", "zh": "Chinese", "ja": "Japanese", "ko": "Korean",
    "yue": "Cantonese", "hi": "Hindi", "th": "Thai", "de": "German",
    "fr": "French", "es": "Spanish", "it": "Italian", "pt": "Portuguese",
    "ru": "Russian", "ar": "Arabic", "id": "Indonesian", "vi": "Vietnamese",
    "tr": "Turkish", "nl": "Dutch", "ms": "Malay", "ur": "Urdu",
}
_NAME_TO_CODE = {v.lower(): k for k, v in LANGUAGE_NAMES.items()}


def normalize_language(lang: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """Accept 'en' or 'English'. Returns (code, display_name) or (None, None)."""
    if not lang or lang.lower() == "auto":
        return None, None
    low = lang.lower()
    if low in LANGUAGE_NAMES:
        return low, LANGUAGE_NAMES[low]
    if low in _NAME_TO_CODE:
        return _NAME_TO_CODE[low], LANGUAGE_NAMES[_NAME_TO_CODE[low]]
    return low, lang


@dataclasses.dataclass
class PromptTemplate:
    """ASR prompt construction (the built-in format above)."""
    system: str = "You are a speech recognition model."
    im_start: str = "<|im_start|>"
    im_end: str = "<|im_end|>"
    audio_token: str = "<|AUDIO|>"
    audio_bos: str = "<|audio_bos|>"
    audio_eos: str = "<|audio_eos|>"

    @staticmethod
    def from_checkpoint(model_dir: str) -> "PromptTemplate":
        """Special-token strings from ``tokenizer_config.json``; a chat
        template in the checkpoint is refused until it is ported."""
        kwargs: dict = {}
        tc_path = os.path.join(model_dir, "tokenizer_config.json")
        chat_template = os.path.isfile(
            os.path.join(model_dir, "chat_template.jinja"))
        if os.path.isfile(tc_path):
            with open(tc_path) as f:
                tc = json.load(f)

            def tok_str(v):
                return v.get("content") if isinstance(v, dict) else v

            for field, key in (("audio_token", "audio_token"),
                               ("audio_bos", "audio_bos_token"),
                               ("audio_eos", "audio_eos_token")):
                if tc.get(key):
                    kwargs[field] = tok_str(tc[key])
            chat_template |= isinstance(tc.get("chat_template"), str)
        if chat_template:
            raise NotImplementedError(
                f"{model_dir} ships a chat template; rendering checkpoint chat "
                "templates is not ported yet (ROADMAP §1: chat templates)")
        return PromptTemplate(**kwargs)

    def prompt_texts(self, language_name: Optional[str], context: str = ""
                     ) -> Tuple[str, str]:
        """(prefix_text, suffix_text) around the audio embedding span."""
        sys_block = f"{self.im_start}system\n{context or self.system}{self.im_end}\n"
        lang_line = f"Language: {language_name}\n" if language_name else ""
        prefix = f"{sys_block}{self.im_start}user\n{lang_line}{self.audio_bos}"
        suffix = f"{self.audio_eos}{self.im_end}\n{self.im_start}assistant\n"
        return prefix, suffix

    def prefix_text(self, language_name: Optional[str], context: str = "") -> str:
        return self.prompt_texts(language_name, context)[0]

    def suffix_text(self) -> str:
        return self.prompt_texts(None, "")[1]


class AsrModel:
    """Bundles config, weights (on their device), tokenizer and template."""

    def __init__(self, cfg: AsrConfig, params: dict, tokenizer: BpeTokenizer,
                 template: Optional[PromptTemplate] = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.template = template or PromptTemplate()
        self.eos_id = tokenizer.special_tokens.get(self.template.im_end,
                                                   cfg.eos_token_id)
        self.pad_id = cfg.pad_token_id

    def prompt_ids(self, n_audio_tokens: int, language: Optional[str],
                   context: str = "") -> Tuple[List[int], List[int], int]:
        """Returns (prefix_ids, suffix_ids, audio_span) for a bucket."""
        _, lang_name = normalize_language(language)
        prefix_t, suffix_t = self.template.prompt_texts(lang_name, context)
        return (self.tokenizer.encode(prefix_t),
                self.tokenizer.encode(suffix_t), n_audio_tokens)
