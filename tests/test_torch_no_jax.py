"""The port and chip_smoke.py import neither ``jax`` nor the JAX package
(``qwen3_asr_tpu``); importing ``qwen3_asr_tpu_torch`` is fine."""
import ast
import os

import pytest

import jax  # noqa: F401  (the port's tests import both frameworks)
import torch  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "qwen3_asr_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "qwen3_asr_tpu", "regex", "aiohttp",
             "safetensors", "jinja2", "pydantic", "pygame")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
