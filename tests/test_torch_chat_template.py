"""The port's chat-template renderer (``text/chat_template.py``) and
``PromptTemplate`` against the JAX package's, which renders with ``jinja2``:

- the renderer against ``jinja2`` with JAX's environment (``trim_blocks``,
  ``lstrip_blocks``, ``loopcontrols``, ``raise_exception``) on a corpus
  (the JAX tests' templates, Qwen2/Qwen2-Audio/Qwen3-style chat templates,
  whitespace control), and on templates and message lists that hypothesis
  draws from the supported grammar: the same string, or both fail;
- a counterpart of every ``tests/test_prompt_template.py`` case, and the
  fallbacks, against JAX's ``PromptTemplate``;
- token ids and texts equal to the JAX engine on a tiny checkpoint written
  with a chat template: one that renders the builtin layout and one that
  drops the system block (``chip_smoke.py``'s phase-17 templates).
"""
import importlib.util
import json
import logging
import os

import jax  # noqa: F401  (the port's tests import both frameworks)
import jax.numpy as jnp
import jinja2
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from qwen3_asr_tpu.models.asr import AsrModel as JaxModel
from qwen3_asr_tpu.models.asr import PromptTemplate as JaxTemplate
from qwen3_asr_tpu.models.asr import _jinja_raise
from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint as jax_load
from qwen3_asr_tpu.runtime.engine import TranscriptionEngine as JaxEngine
from qwen3_asr_tpu.text.tokenizer import BpeTokenizer as JaxTokenizer
from qwen3_asr_tpu_torch.models.asr import PromptTemplate
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
from qwen3_asr_tpu_torch.text.chat_template import (TemplateError,
                                                    compile_template)
from tests.fixtures import write_tiny_checkpoint
from tests.test_prompt_template import OMNI_TEMPLATE
from tests.util_audio import speech_like

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
BUILTIN_LAYOUT = SMOKE.TEMPLATE_BUILTIN_LAYOUT
NO_SYSTEM = SMOKE.TEMPLATE_NO_SYSTEM


def _jinja_env():
    env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True,
                             extensions=["jinja2.ext.loopcontrols"])
    env.globals["raise_exception"] = _jinja_raise
    return env


ENV = _jinja_env()


def _both(source: str, variables: dict):
    """(jinja2's string or None if it failed, ours or None)."""
    try:
        ref = ENV.from_string(source).render(**variables)
    except Exception:
        ref = None
    try:
        ours = compile_template(source).render(**variables)
    except TemplateError:
        ours = None
    return ref, ours


# -- the corpus ------------------------------------------------------------------

MODEL_TEMPLATE = (   # tests/test_prompt_template.py's model case
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n"
    "{% if message['content'] is string %}{{ message['content'] }}"
    "{% else %}{% for content in message['content'] %}"
    "{% if content['type'] == 'audio' %}<|audio_bos|><|AUDIO|><|audio_eos|>"
    "{% elif content['type'] == 'text' %}{{ content['text'] }}"
    "{% endif %}{% endfor %}{% endif %}<|im_end|>\n{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
TEXT_ONLY = ("{% for m in messages %}{{ m['role'] }}: {{ m['content'] }}\n"
             "{% endfor %}")

QWEN2 = """{% for message in messages %}{% if loop.first and messages[0]['role'] != 'system' %}{{ '<|im_start|>system
You are a helpful assistant.<|im_end|>
' }}{% endif %}{{'<|im_start|>' + message['role'] + '
' + message['content'] + '<|im_end|>' + '
'}}{% endfor %}{% if add_generation_prompt %}{{ '<|im_start|>assistant
' }}{% endif %}"""

QWEN2_AUDIO = """{% set audio_count = namespace(value=0) %}{% for message in messages %}{% if loop.first and message['role'] != 'system' %}<|im_start|>system
You are a helpful assistant.<|im_end|>
{% endif %}<|im_start|>{{ message['role'] }}
{% if message['content'] is string %}{{ message['content'] }}<|im_end|>
{% else %}{% for content in message['content'] %}{% if 'audio' in content or 'audio_url' in content %}{% set audio_count.value = audio_count.value + 1 %}Audio {{ audio_count.value }}: <|audio_bos|><|AUDIO|><|audio_eos|>
{% elif 'text' in content %}{{ content['text'] }}{% endif %}{% endfor %}<|im_end|>
{% endif %}{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant
{% endif %}"""

QWEN25_TOOLS = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""

QWEN3 = """{%- if messages[0].role == 'system' %}
    {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if message.reasoning_content is string %}
            {%- set reasoning_content = message.reasoning_content %}
        {%- else %}
            {%- if '</think>' in content %}
                {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
                {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
            {%- endif %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}"""

QWEN3_ASR_STYLE = """{# the ASR messages: a system turn, then the audio #}
{%- set ns = namespace(system=false) %}
{%- for message in messages %}
    {%- if message.role == 'system' %}
        {%- set ns.system = true %}
    {%- endif %}
{%- endfor %}
{%- if not ns.system %}
<|im_start|>system
You are a speech recognition model.<|im_end|>
{% endif %}
{%- for message in messages %}
<|im_start|>{{ message.role }}
{% if message.content is string -%}
    {{ message.content | trim }}
{%- else -%}
    {%- for part in message.content -%}
        {%- if part.type == 'text' -%}{{ part.text }}
        {%- elif part.type == 'audio' -%}{{ audio_bos_token ~ audio_token ~ audio_eos_token }}
        {%- else -%}{{ raise_exception('unknown part ' ~ part.type) }}
        {%- endif -%}
    {%- endfor -%}
{%- endif %}<|im_end|>
{% endfor -%}
{% if add_generation_prompt %}<|im_start|>assistant
{% endif %}"""

WHITESPACE = (
    "a\n  {% if true %}\n  b\n  {% endif %}\nc\n"
    "  {#- c #}  x {# c #}\n y\n"
    "{%- if true -%}\n  hi  \n{%- endif -%}\n!\n"
    "   {%+ if true %}kept{% endif +%}\n\n"
    "\t{% for i in [1, 2] %}\n\t{{ i }}\n\t{% endfor %}\r\n"
    "{{ 'q' if false }}|{{- '  s  ' -}}  |\r")

CORPUS = {"omni": OMNI_TEMPLATE, "model": MODEL_TEMPLATE,
          "text_only": TEXT_ONLY, "unclosed": "{{ unclosed",
          "broken": "BROKEN {{", "qwen2": QWEN2, "qwen2_audio": QWEN2_AUDIO,
          "qwen25_tools": QWEN25_TOOLS, "qwen3": QWEN3,
          "qwen3_asr_style": QWEN3_ASR_STYLE, "whitespace": WHITESPACE,
          "builtin_layout": BUILTIN_LAYOUT, "no_system": NO_SYSTEM,
          "raises": "{{ raise_exception('no system turn') }}",
          "namespace_attr": "{% set x = 1 %}{% set x.a = 2 %}"}


def _asr_messages(language, context, system="You are a speech recognition "
                  "model."):
    """The messages JAX's ``_render_chat`` builds."""
    user = [{"type": "audio", "audio": ""}]
    if language:
        user.insert(0, {"type": "text", "text": f"Language: {language}\n"})
    messages = []
    if context or system:
        messages.append({"role": "system", "content": context or system})
    messages.append({"role": "user", "content": user})
    return messages


CHAT = [{"role": "system", "content": "Be <brief> & 'exact'."},
        {"role": "user", "content": "  hi\n"},
        {"role": "assistant", "content": "<think>\nhmm\n</think>\n\nhello",
         "tool_calls": [{"function": {"name": "f",
                                      "arguments": {"b": 1, "a": "<x>"}}}]},
        {"role": "tool", "content": "42"},
        {"role": "user", "content": "<tool_response>r</tool_response>"}]
VARIABLES = {
    "asr_english": dict(messages=_asr_messages("English", ""),
                        add_generation_prompt=True),
    "asr_context": dict(messages=_asr_messages(None, "bias words"),
                        add_generation_prompt=True),
    "asr_no_system": dict(messages=_asr_messages("French", "", system=""),
                          add_generation_prompt=False),
    "chat": dict(messages=CHAT, add_generation_prompt=True,
                 enable_thinking=False),
    "chat_tools": dict(messages=CHAT[1:], add_generation_prompt=True,
                       tools=[{"name": "f", "parameters": {"x": "<&'>"}}]),
    "unknown_part": dict(messages=[{"role": "user", "content": [
        {"type": "video"}]}], add_generation_prompt=True),
}
for _v in VARIABLES.values():
    _v.update(audio_token="<|AUDIO|>", audio_bos_token="<|audio_bos|>",
              audio_eos_token="<|audio_eos|>")


@pytest.mark.parametrize("variables", list(VARIABLES))
@pytest.mark.parametrize("name", list(CORPUS))
def test_corpus_renders_as_jinja2(name, variables):
    ref, ours = _both(CORPUS[name], VARIABLES[variables])
    assert ours == ref


def test_corpus_renders_something():
    """The corpus is not all failures: every template renders for some
    variables, and all but the broken ones for the ASR messages."""
    broken = {"unclosed", "broken", "raises", "namespace_attr"}
    for name, source in CORPUS.items():
        rendered = [_both(source, v)[1] for v in VARIABLES.values()]
        assert any(r is not None for r in rendered) != (name in broken), name
    for name in ("omni", "model", "qwen2_audio", "qwen3_asr_style",
                 "builtin_layout", "no_system", "whitespace"):
        assert _both(CORPUS[name], VARIABLES["asr_english"])[1], name


@pytest.mark.parametrize("source", [
    "{% raw %}x{% endraw %}", "{% macro m() %}{% endmacro %}",
    "{{ x|default('a') }}", "{{ x is divisibleby(3) }}",
    "{% for x in y if x %}{% endfor %}", "{% set x %}a{% endset %}",
    "{{ 'a'.format() }}", "{% break %}",
    "{% for i in [1] %}{{ loop.cycle }}{% endfor %}",
    "{{ x[1, 2] }}", "{% include 'a' %}", "{{ f(*a) }}"])
def test_outside_the_subset_raises_the_renderers_error(source):
    with pytest.raises(TemplateError):
        compile_template(source).render(x="ab", y=[1], f=len, a=[1])


def test_tojson_result_refuses_plus():
    """jinja2 escapes the plain side of ``+`` with a tojson result; the
    renderer refuses the operation instead of giving another string."""
    ref = ENV.from_string("{{ '<' + (d|tojson) }}").render(d={"a": 1})
    assert ref.startswith("&lt;")
    with pytest.raises(TemplateError):
        compile_template("{{ '<' + (d|tojson) }}").render(d={"a": 1})


def test_parse_once_render_many():
    tmpl = compile_template(QWEN3)
    for v in VARIABLES.values():
        try:
            out = tmpl.render(**v)
        except TemplateError:
            continue
        assert out == ENV.from_string(QWEN3).render(**v)


# -- templates drawn from the grammar ---------------------------------------------

TEXTS = ["", "a", " ", "  ", "\n", "\n  ", "  \n", "\t", "x\n  ", "<|im_end|>\n",
         "\r\n", "-", "}"]
STRINGS = ["'a'", '"b"', "'\\n'", "'<|im_start|>'", "' x '", "''", "'&'",
           "'user'", "'system'"]


@st.composite
def _text(draw):
    return "".join(draw(st.lists(st.sampled_from(TEXTS), max_size=3)))


def _open(draw, var=False):
    return draw(st.sampled_from(["", "-"] if var else ["", "-", "+"]))


def _close(draw, var=False):
    return draw(st.sampled_from(["", "-"] if var else ["", "-", "+"]))


@st.composite
def _value(draw, scope):
    """A printable expression; ``scope`` holds the loop variables."""
    atoms = list(STRINGS) + ["messages|length", "messages[0].role",
                             "messages[-1]['role']", "ns.n", "x",
                             "add_generation_prompt", "audio_token", "1",
                             "-2", "2.5", "none", "true"]
    if "m" in scope:
        atoms += ["m.role", "m['role']", "m.content", "loop.index",
                  "loop.index0", "loop.first", "loop.last", "loop.length",
                  "loop.revindex", "m.content|length"]
    if "c" in scope:
        atoms += ["c.type", "c['text']", "c.text|trim", "c"]
    atom = draw(st.sampled_from(atoms))
    form = draw(st.integers(0, 9))
    if form == 0:
        return f"{atom} ~ {draw(_value(scope))}"
    if form == 1:
        return f"{draw(st.sampled_from(STRINGS))} + {draw(st.sampled_from(STRINGS))}"
    if form == 2:
        return f"({atom} if {draw(_cond(scope))} else {draw(_value(scope))})"
    if form == 3:
        return f"{atom}|tojson"
    if form == 4:
        return f"{draw(st.sampled_from(STRINGS))}.strip()"
    if form == 5:
        return f"({atom}|string).split('a')[0]"
    if form == 6:
        return f"messages[::-1][0].role"
    return atom


@st.composite
def _cond(draw, scope):
    atoms = ["add_generation_prompt", "messages|length > 1", "x is defined",
             "x is not defined", "ns.n == 0", "'a' in 'abc'",
             "none is none", "messages[0].content is string",
             "messages is mapping", "1 < 2 <= 2"]
    if "m" in scope:
        atoms += ["m.role == 'user'", "m.role != 'system'",
                  "m.content is string", "m.content is not string",
                  "loop.first", "not loop.last", "loop.index > 1",
                  "'s' in m.role", "m.role not in ['user']"]
    if "c" in scope:
        atoms += ["c.type == 'audio'", "c.text is defined",
                  "'text' in c", "c is mapping"]
    atom = draw(st.sampled_from(atoms))
    form = draw(st.integers(0, 6))
    if form == 0:
        return f"{atom} and {draw(_cond(scope))}"
    if form == 1:
        return f"{atom} or {draw(_cond(scope))}"
    if form == 2:
        return f"not {atom}"
    if form == 3:
        return f"not ({atom})"
    return atom


@st.composite
def _body(draw, scope, depth):
    parts = []
    for _ in range(draw(st.integers(0, 4))):
        parts.append(draw(_text()))
        kind = draw(st.sampled_from(
            ["var", "var", "if", "for", "set", "ns", "comment", "loopctl"]
            if depth < 2 else ["var", "var", "set", "ns", "comment"]))
        if kind == "var":
            parts.append(f"{{{{{_open(draw, True)} {draw(_value(scope))} "
                         f"{_close(draw, True)}}}}}")
        elif kind == "if":
            parts.append(f"{{%{_open(draw)} if {draw(_cond(scope))} "
                         f"{_close(draw)}%}}{draw(_body(scope, depth + 1))}")
            for _ in range(draw(st.integers(0, 1))):
                parts.append(f"{{%{_open(draw)} elif {draw(_cond(scope))} "
                             f"{_close(draw)}%}}{draw(_body(scope, depth + 1))}")
            if draw(st.booleans()):
                parts.append(f"{{%{_open(draw)} else {_close(draw)}%}}"
                             f"{draw(_body(scope, depth + 1))}")
            parts.append(f"{{%{_open(draw)} endif {_close(draw)}%}}")
        elif kind == "for":
            if "m" in scope and draw(st.booleans()):
                head, inner = "c in m.content", scope | {"c"}
            else:
                seq = draw(st.sampled_from(["messages", "messages[::-1]",
                                            "messages[1:]"]))
                head, inner = f"m in {seq}", scope | {"m"}
            parts.append(f"{{%{_open(draw)} for {head} {_close(draw)}%}}"
                         f"{draw(_body(inner, depth + 1))}")
            if draw(st.booleans()):
                parts.append(f"{{%{_open(draw)} else {_close(draw)}%}}"
                             f"{draw(_body(scope, depth + 1))}")
            parts.append(f"{{%{_open(draw)} endfor {_close(draw)}%}}")
        elif kind == "set":
            parts.append(f"{{%{_open(draw)} set x = {draw(_value(scope))} "
                         f"{_close(draw)}%}}")
        elif kind == "ns":
            parts.append(f"{{%{_open(draw)} set ns.n = ns.n + 1 "
                         f"{_close(draw)}%}}")
        elif kind == "comment":
            parts.append(f"{{#{_open(draw)} note {_close(draw)}#}}")
        elif scope:
            word = draw(st.sampled_from(["break", "continue"]))
            parts.append(f"{{% if {draw(_cond(scope))} %}}{{%{_open(draw)} "
                         f"{word} {_close(draw)}%}}{{% endif %}}")
    parts.append(draw(_text()))
    return "".join(parts)


_MESSAGE = st.fixed_dictionaries({
    "role": st.sampled_from(["system", "user", "assistant"]),
    "content": st.one_of(
        st.text(alphabet="ab <>&'\n", max_size=6),
        st.lists(st.one_of(
            st.fixed_dictionaries({"type": st.just("text"),
                                   "text": st.text(alphabet="ab \n",
                                                   max_size=4)}),
            st.just({"type": "audio", "audio": ""})), max_size=3))})


@settings(max_examples=400, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(body=_body(frozenset(), 0),
       messages=st.lists(_MESSAGE, min_size=1, max_size=3),
       prompt=st.booleans(), with_ns=st.booleans())
def test_drawn_templates_render_as_jinja2(body, messages, prompt, with_ns):
    source = ("{% set ns = namespace(n=0) %}" if with_ns else "") + body
    variables = dict(messages=messages, add_generation_prompt=prompt,
                     audio_token="<|AUDIO|>")
    ref, ours = _both(source, variables)
    assert ours == ref, source


# -- PromptTemplate: counterparts of tests/test_prompt_template.py ------------------

def _pair(**kwargs):
    return JaxTemplate(**kwargs), PromptTemplate(**kwargs)


def test_builtin_prefix_suffix_golden():
    jax_t, t = _pair()
    prefix, suffix = t.prompt_texts("English", "")
    assert (prefix, suffix) == jax_t.prompt_texts("English", "")
    assert prefix == ("<|im_start|>system\nYou are a speech recognition "
                      "model.<|im_end|>\n<|im_start|>user\n"
                      "Language: English\n<|audio_bos|>")
    assert suffix == "<|audio_eos|><|im_end|>\n<|im_start|>assistant\n"


def test_builtin_no_language_no_lang_line():
    jax_t, t = _pair()
    assert t.prompt_texts(None, "") == jax_t.prompt_texts(None, "")
    assert "Language:" not in t.prompt_texts(None, "")[0]


def test_builtin_context_replaces_system():
    jax_t, t = _pair()
    prefix, _ = t.prompt_texts("English", "Names: Kata, Jo")
    assert prefix == jax_t.prompt_texts("English", "Names: Kata, Jo")[0]
    assert "Names: Kata, Jo" in prefix
    assert "speech recognition model" not in prefix


def _omni_dir(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": OMNI_TEMPLATE,
        "audio_token": "<|audio_pad|>",
        "audio_bos_token": "<|audio_start|>",
        "audio_eos_token": "<|audio_end|>",
    }))
    return str(d)


def test_checkpoint_template_loaded_and_rendered(tmp_path):
    d = _omni_dir(tmp_path)
    t, jax_t = PromptTemplate.from_checkpoint(d), JaxTemplate.from_checkpoint(d)
    assert t.chat_template == jax_t.chat_template == OMNI_TEMPLATE
    assert (t.audio_token, t.audio_bos, t.audio_eos) == (
        jax_t.audio_token, jax_t.audio_bos, jax_t.audio_eos)
    prefix, suffix = t.prompt_texts("English", "bias words")
    assert (prefix, suffix) == jax_t.prompt_texts("English", "bias words")
    assert prefix == ("<|im_start|>system\nbias words<|im_end|>\n"
                      "<|im_start|>user\nLanguage: English\n<|audio_start|>")
    assert suffix == "<|audio_end|><|im_end|>\n<|im_start|>assistant\n"
    for lang, ctx in ((None, ""), ("Chinese", ""), (None, "ctx")):
        assert t.prompt_texts(lang, ctx) == jax_t.prompt_texts(lang, ctx)


def test_checkpoint_template_jinja_file_wins(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": "BROKEN {{"}))
    (d / "chat_template.jinja").write_text(OMNI_TEMPLATE)
    t, jax_t = (PromptTemplate.from_checkpoint(str(d)),
                JaxTemplate.from_checkpoint(str(d)))
    assert t.chat_template == jax_t.chat_template == OMNI_TEMPLATE


@pytest.mark.parametrize("source,reason", [
    ("{{ unclosed", "render failed"),
    ("{% for m in messages %}{{ m['role'] }}: {{ m['content'] }}\n"
     "{% endfor %}", "audio placeholders"),
    ("{{ raise_exception('no') }}", "render failed"),
    ("{{ x|default('a') }}<|AUDIO|>", "render failed")])
def test_unusable_template_falls_back_to_builtin(caplog, source, reason):
    """A template that fails (or, outside the renderer's subset, would
    need jinja2) or renders no placeholder: one warning, then the builtin
    prompt, as JAX's."""
    jax_t, t = _pair(chat_template=source)
    with caplog.at_level(logging.WARNING,
                         logger="qwen3_asr_tpu_torch.models.asr"):
        for _ in range(3):
            assert t.prompt_texts("English", "") == \
                PromptTemplate().prompt_texts("English", "")
    warned = [r for r in caplog.records
              if r.name == "qwen3_asr_tpu_torch.models.asr"]
    assert len(warned) == 1 and reason in warned[0].getMessage()
    if "default" not in source:        # jinja2 renders |default
        assert t.prompt_texts(None, "") == jax_t.prompt_texts(None, "")


def test_language_after_audio_falls_back():
    """A template that renders the language hint after the audio: the
    suffix is not static, so both fall back to the builtin format."""
    source = ("{{ audio_token }}{% for m in messages %}{% if m.content is "
              "not string %}{% for c in m.content %}{% if c.type == 'text' %}"
              "{{ c.text }}{% endif %}{% endfor %}{% endif %}{% endfor %}")
    jax_t, t = _pair(chat_template=source)
    assert t.prompt_texts("French", "") == jax_t.prompt_texts("French", "")
    assert t.prompt_texts("French", "") == \
        PromptTemplate().prompt_texts("French", "")
    assert t._suffix_static is False


def test_template_is_parsed_once(monkeypatch):
    from qwen3_asr_tpu_torch.models import asr
    calls = []
    real = asr.compile_template
    monkeypatch.setattr(asr, "compile_template",
                        lambda s: calls.append(s) or real(s))
    t = PromptTemplate(chat_template=BUILTIN_LAYOUT)
    for lang in ("English", "French", None, "English"):
        t.prompt_texts(lang, "")
    assert calls == [BUILTIN_LAYOUT]


# -- a checkpoint with a chat template: the JAX engine's token ids ----------------

def _engines(path):
    cfg, params = jax_load(path, dtype=jnp.float32, cache=False)
    jax_model = JaxModel(cfg, params,
                         JaxTokenizer.from_file(os.path.join(path,
                                                             "tokenizer.json")),
                         JaxTemplate.from_checkpoint(path))
    return JaxEngine(jax_model, dtype=jnp.float32), load_engine(path,
                                                                device="cpu")


@pytest.mark.parametrize("name", ["builtin_layout", "no_system", "model"])
def test_checkpoint_template_token_ids_equal_jax(tmp_path, caplog, name):
    path = write_tiny_checkpoint(str(tmp_path / "ckpt"),
                                 chat_template=CORPUS[name])
    torch.set_num_threads(2)
    with caplog.at_level(logging.INFO,
                         logger="qwen3_asr_tpu_torch.runtime.lifecycle"):
        jax_eng, eng = _engines(path)
    assert f"Using checkpoint chat template ({len(CORPUS[name])} chars)" in \
        caplog.text
    assert eng.model.template.chat_template == CORPUS[name]
    for lang in (None, "en", "zh"):
        ours = eng.model.prompt_ids(7, lang, "")
        assert ours == jax_eng.model.prompt_ids(7, lang, "")
    builtin = PromptTemplate().prompt_texts("English", "")
    rendered = eng.model.template.prompt_texts("English", "")
    assert (rendered == builtin) == (name != "no_system")
    if name == "no_system":
        assert rendered[0] == "<|im_start|>user\nLanguage: English\n" \
                              "<|audio_bos|>"
    audio = speech_like(1.5, seed=3)
    for lang in (None, "en"):
        ref = jax_eng.transcribe(audio, 16000, language=lang)
        got = eng.transcribe(audio, 16000, language=lang)
        assert [r.token_ids for r in got] == [r.token_ids for r in ref]
        assert [(r.text, r.language) for r in got] == \
            [(r.text, r.language) for r in ref]
