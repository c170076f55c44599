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
             "safetensors", "jinja2", "pydantic", "pygame", "optax",
             "tokenizers")


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


# The gateway's process must not load torch or numpy (a CUDA context would
# hold card memory through the idle kill): these modules import neither,
# and only each other within the package.
TORCH_FREE = ("serving/gateway.py", "serving/wsproto.py", "serving/http.py",
              "serving/meta.py", "serving/schemas.py", "config.py",
              "utils/logging.py", "utils/errors.py", "text/chat_template.py")


def _relative_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    here = os.path.dirname(os.path.relpath(path, PKG))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = os.path.normpath(os.path.join(here, *[".."] * (
                node.level - 1)))
            parts = [p for p in (base, *(node.module or "").split("."))
                     if p and p != "."]
            target = os.path.join(*parts) if parts else ""
            if node.module is None:
                for alias in node.names:
                    yield os.path.join(target, alias.name) + ".py"
            elif os.path.isdir(os.path.join(PKG, target)):
                for alias in node.names:
                    yield os.path.join(target, alias.name) + ".py"
            else:
                yield target + ".py"


@pytest.mark.parametrize("module", TORCH_FREE)
def test_gateway_modules_import_no_torch(module):
    path = os.path.join(PKG, module)
    bad = sorted(set(_imported_roots(path)) & {"torch", "numpy"})
    assert not bad, f"{module} imports {bad}"
    inside = {p for p in _relative_imports(path)
              if os.path.isfile(os.path.join(PKG, p))}
    assert inside <= set(TORCH_FREE), f"{module} imports {inside}"
