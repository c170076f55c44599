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


# The port decodes MP3 and Ogg Vorbis itself: no codec library is loaded
# through ctypes or imported (JAX's decode goes through pygame's SDL_mixer,
# mpg123 and libvorbisfile).
CODEC_LIBS = ("mpg123", "vorbisfile", "mp3lame", "sndfile", "sdl", "opus")
_LOADERS = ("CDLL", "PyDLL", "LoadLibrary", "find_library", "dlopen",
            "load_library")


def _loads_and_imports(path):
    """The module names a source imports and the strings it hands to a
    library loader."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in _LOADERS:
                for arg in ast.walk(node):
                    if isinstance(arg, ast.Constant) and isinstance(
                            arg.value, str):
                        yield arg.value


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_codec_library(path):
    bad = sorted({s for s in _loads_and_imports(path)
                  if any(lib in s.lower() for lib in CODEC_LIBS)})
    assert not bad, f"{os.path.relpath(path, ROOT)} loads {bad}"


def test_the_codec_check_sees_a_ctypes_load(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import ctypes\nctypes.CDLL('libmpg123.so.0')\n"
                   "from ctypes.util import find_library\n"
                   "find_library('vorbisfile')\n")
    assert sorted(s for s in _loads_and_imports(str(src))
                  if any(lib in s.lower() for lib in CODEC_LIBS)) == \
        ["libmpg123.so.0", "vorbisfile"]


# Slice 23's modules, imported in a fresh interpreter: none of them loads
# a forbidden package at run time either (the BPE trainer in particular
# must not reach for the `tokenizers` package the JAX tool uses).
SLICE_23 = ("text/bpe_train.py", "runtime/roofline.py",
            "runtime/aot_cache.py", "tools/transcribe.py",
            "tools/debug_audio.py", "tools/train_vad.py",
            "tools/export_encoder.py", "tools/overfit.py",
            "tools_perf/boot.py")


@pytest.fixture(scope="module")
def slice_23_loaded():
    import json
    import subprocess
    import sys
    mods = ["qwen3_asr_tpu_torch." + m[:-3].replace("/", ".")
            for m in SLICE_23]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", SLICE_23)
def test_slice_23_module_loads_no_forbidden_package(module,
                                                    slice_23_loaded):
    assert os.path.join(PKG, module) in _sources()
    bad = sorted(slice_23_loaded & set(FORBIDDEN))
    assert not bad, f"importing slice 23's modules loaded {bad}"
