"""Qwen3-ASR model assembly: config, weights, tokenizer and prompt template.

Counterpart of ``qwen3_asr_tpu/models/asr.py`` (``normalize_language``,
``PromptTemplate``, ``AsrModel``). A checkpoint's own chat template
(``chat_template.jinja``, or ``tokenizer_config.json``'s
``chat_template``) is rendered with the ASR messages (system = the context
or the default system text, user = the language line and the audio) by
``text/chat_template.py``, and split at the audio placeholder; a template
that fails, renders other than one placeholder, or puts the language or
context after the audio warns once and gives the built-in prompt, as JAX's
does:

    <|im_start|>system\\n{context}<|im_end|>\\n
    <|im_start|>user\\n{Language: {name}\\n}<|audio_bos|><|AUDIO|>*N
    <|audio_eos|><|im_end|>\\n<|im_start|>assistant\\n
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import List, Optional, Tuple

from ..text.chat_template import compile_template
from ..text.tokenizer import BpeTokenizer
from .config import AsrConfig

log = logging.getLogger(__name__)

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
    """ASR prompt construction: the checkpoint's chat template where it
    ships a usable one, else the built-in format above."""
    system: str = "You are a speech recognition model."
    im_start: str = "<|im_start|>"
    im_end: str = "<|im_end|>"
    audio_token: str = "<|AUDIO|>"
    audio_bos: str = "<|audio_bos|>"
    audio_eos: str = "<|audio_eos|>"
    chat_template: Optional[str] = None     # the checkpoint's source
    # parsed once: a 450 ms WS tick renders without parsing again
    _compiled: object = dataclasses.field(default=None, init=False,
                                          repr=False, compare=False)
    _suffix_static: Optional[bool] = dataclasses.field(default=None,
                                                       init=False,
                                                       repr=False,
                                                       compare=False)
    _template_warned: bool = dataclasses.field(default=False, init=False,
                                               repr=False, compare=False)

    @staticmethod
    def from_checkpoint(model_dir: str) -> "PromptTemplate":
        """Special-token strings and the chat template from
        ``tokenizer_config.json``; ``chat_template.jinja`` wins over the
        config's template (the HF convention)."""
        kwargs: dict = {}
        tc_path = os.path.join(model_dir, "tokenizer_config.json")
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
            if isinstance(tc.get("chat_template"), str):
                kwargs["chat_template"] = tc["chat_template"]
        jinja_path = os.path.join(model_dir, "chat_template.jinja")
        if os.path.isfile(jinja_path):
            with open(jinja_path) as f:
                kwargs["chat_template"] = f.read()
        return PromptTemplate(**kwargs)

    def _render_chat(self, language_name: Optional[str], context: str
                     ) -> Optional[Tuple[str, str]]:
        """The checkpoint's template rendered and split at the audio
        placeholder: (prefix, suffix), or None (no template, or one that
        failed or rendered other than one placeholder)."""
        if not self.chat_template:
            return None
        try:
            if self._compiled is None:
                self._compiled = compile_template(self.chat_template)
            lang_line = f"Language: {language_name}\n" if language_name else ""
            user_content = [{"type": "audio", "audio": ""}]
            if lang_line:
                user_content.insert(0, {"type": "text", "text": lang_line})
            messages = []
            if context or self.system:
                messages.append({"role": "system",
                                 "content": context or self.system})
            messages.append({"role": "user", "content": user_content})
            text = self._compiled.render(
                messages=messages, add_generation_prompt=True,
                audio_token=self.audio_token, audio_bos_token=self.audio_bos,
                audio_eos_token=self.audio_eos)
            if text.count(self.audio_token) != 1:
                self._warn_template_fallback(
                    f"rendered {text.count(self.audio_token)} audio "
                    "placeholders (need exactly 1)")
                return None
            prefix, suffix = text.split(self.audio_token)
            return prefix, suffix
        except Exception as e:
            # the builtin format is an approximation the checkpoint may not
            # have been trained with: say so rather than fall back silently
            self._warn_template_fallback(f"render failed: {e!r}")
            return None

    def _warn_template_fallback(self, reason: str) -> None:
        if self._template_warned:
            return
        self._template_warned = True
        log.warning("checkpoint chat template unusable (%s); using the "
                    "builtin prompt format — transcripts may differ from "
                    "the upstream SDK's", reason)

    def _suffix_is_static(self) -> bool:
        """Whether the text after the audio span does not depend on the
        language or the context (probed once). The engine builds the
        suffix ids once per key, so a template that renders the language
        hint after the audio would lose it: such a template falls back to
        the builtin format, with a warning."""
        if self._suffix_static is None:
            base = self._render_chat(None, "")
            probe = self._render_chat("French", "probe context")
            self._suffix_static = (base is not None and probe is not None
                                   and base[1] == probe[1])
            if not self._suffix_static and base is not None:
                log.warning(
                    "checkpoint chat template renders language/context AFTER "
                    "the audio span; falling back to the builtin prompt "
                    "format so the hint stays in the (dynamic) prefix")
        return self._suffix_static

    def prompt_texts(self, language_name: Optional[str], context: str = ""
                     ) -> Tuple[str, str]:
        """(prefix_text, suffix_text) around the audio embedding span."""
        if self.chat_template and self._suffix_is_static():
            rendered = self._render_chat(language_name, context)
            if rendered is not None:
                return rendered
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
