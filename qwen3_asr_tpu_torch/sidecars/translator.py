"""LLM-backed translation over any OpenAI-compatible chat API, on the
standard library.

Counterpart of ``qwen3_asr_tpu/sidecars/translator.py`` (which runs on
aiohttp): the same request body (``model``, ``messages``,
``temperature``) to ``{OPENAI_BASE_URL}/chat/completions`` with
``Authorization: Bearer {OPENAI_API_KEY}``, text at
``TRANSLATE_TEMPERATURE`` and SRT at ``TRANSLATE_SRT_TEMPERATURE`` with
the same prompts, markdown-fence stripping, the empty-input short-circuit,
and a raise on an HTTP error or no choices. Synchronous (``urllib``): the
server calls it on the request's own thread, never on the device thread.

Env: ``OPENAI_BASE_URL`` (default ``https://api.openai.com/v1``; e.g.
``http://localhost:11434/v1`` for Ollama), ``OPENAI_API_KEY`` (default
``EMPTY``), ``TRANSLATE_MODEL`` (default ``gpt-3.5-turbo``),
``TRANSLATE_TIMEOUT`` (seconds, default 120).
"""
from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request

from ..config import TRANSLATE_SRT_TEMPERATURE, TRANSLATE_TEMPERATURE

log = logging.getLogger(__name__)


def _lang_name(target_lang: str) -> str:
    low = target_lang.lower()
    if low in ("en", "english"):
        return "English"
    if low in ("zh", "chinese"):
        return "Chinese"
    return target_lang


def _chat_completion(messages: list, temperature: float) -> str:
    base_url = os.getenv("OPENAI_BASE_URL", "https://api.openai.com/v1")
    api_key = os.getenv("OPENAI_API_KEY", "EMPTY")
    model = os.getenv("TRANSLATE_MODEL", "gpt-3.5-turbo")
    url = base_url.rstrip("/") + "/chat/completions"
    payload = {"model": model, "messages": messages,
               "temperature": temperature}
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"), method="POST",
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"})
    timeout = float(os.getenv("TRANSLATE_TIMEOUT", "120"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", errors="replace")
        raise RuntimeError(
            f"translation API returned {e.code}: {body[:200]}") from e
    choices = data.get("choices") or []
    if not choices:
        raise ValueError("Translation returned no choices")
    return (choices[0].get("message", {}).get("content") or "").strip()


def translate_text(text: str, target_lang: str) -> str:
    """Translate plain transcription text."""
    if not text.strip():
        return text
    lang = _lang_name(target_lang)
    model = os.getenv("TRANSLATE_MODEL", "gpt-3.5-turbo")
    log.info("translate_text start | %d chars -> %s via %s",
             len(text), lang, model)
    prompt = (
        f"Translate the following spoken audio transcription into {lang}. "
        f"Preserve the original meaning and tone. Output ONLY the translated "
        f"text required without any introduction, markdown blocks, quotes, "
        f"or commentary.\n\nText: {text}")
    t0 = time.time()
    result = _chat_completion(
        [{"role": "system",
          "content": "You are a professional and highly accurate translator."},
         {"role": "user", "content": prompt}],
        TRANSLATE_TEMPERATURE)
    log.info("translate_text done in %.2fs | %d -> %d chars",
             time.time() - t0, len(text), len(result))
    return result


def translate_srt(srt_content: str, target_lang: str) -> str:
    """Translate SRT content, preserving indices and timestamp lines."""
    if not srt_content.strip():
        return srt_content
    lang = _lang_name(target_lang)
    model = os.getenv("TRANSLATE_MODEL", "gpt-3.5-turbo")
    log.info("translate_srt start | %d chars -> %s via %s",
             len(srt_content), lang, model)
    prompt = (
        f"Translate the following subtitle (SRT) content into {lang}. "
        f"Preserve the original SRT format and timing tags perfectly. "
        f"Output ONLY the valid translated SRT content without any "
        f"introduction, markdown wrapping blocks (like ```srt), or "
        f"commentary. Do NOT change the SRT index numbers or timestamp "
        f"lines.\n\nSRT Content:\n{srt_content}")
    t0 = time.time()
    result = _chat_completion(
        [{"role": "system",
          "content": "You are a professional subtitle translator. You MUST "
                     "output ONLY valid SRT format."},
         {"role": "user", "content": prompt}],
        TRANSLATE_SRT_TEMPERATURE)

    # Strip a markdown fence if the model ignored instructions.
    if result.startswith("```"):
        log.debug("removing markdown fence from SRT translation")
        lines = result.split("\n")
        if lines and lines[0].startswith("```"):
            lines.pop(0)
        if lines and lines[-1].startswith("```"):
            lines.pop(-1)
        result = "\n".join(lines).strip()

    log.info("translate_srt done in %.2fs | %d -> %d chars",
             time.time() - t0, len(srt_content), len(result))
    return result
