"""Boot cache under ``ASR_AOT_CACHE_DIR``: the built kernel and host
libraries.

Counterpart of ``qwen3_asr_tpu/runtime/aot_cache.py``. JAX serializes its
compiled executables so that a boot skips tracing and compiling. Torch
cannot serialize a CUDA graph, so the port captures its graphs again at
every boot (a key 0.6-3 s); what a boot rebuilds that can be kept is the
libraries ``ops/_build.py`` compiles at first use: every ``csrc/*.cu`` with
``nvcc`` and ``csrc/audio_dsp.cpp`` with ``g++``, 14-26 s of a 28-47 s
cold boot at preset:1.7b on the H100 (``tools_perf/boot.py``). With the cache
set, ``build`` and ``build_host`` look a library up here before compiling
it and publish each one they compile or find built, so a deployment whose
``_build/`` is empty boots without ``nvcc``. Quantized weights are not
kept: quantizing preset:1.7b to int8 took 0.15-0.24 s on the card, reading
a kept copy back 1.5 s and writing it 2.6-2.9 s (``PERF.md`` §6).

Staleness, by JAX's rules: every library lives under a fingerprint of what
shapes it, so a changed input gives a new fingerprint, never a stale
entry. The fingerprint hashes ``package_source_hash`` (the bytes of every
``.py``, ``.cu``, ``.cuh``, ``.cpp`` and ``.h`` file of the package, sorted
by path: any source edit invalidates every library, as JAX's blobs are),
torch's version and its CUDA version, the machine, the compiler flags, and
the environment that shapes a build (``_BUILD_ENV``: which toolkit
``nvcc`` comes from). JAX's program-shaping variables (``QUANTIZE`` and
the rest) change no library, so they are not in it. A library's file name
already carries a hash of its source, headers and flags. Entries are
written to a temporary file and renamed, so a crashed writer leaves no
torn entry; each library's SHA-256 is kept beside it, and a copy whose
bytes differ is rebuilt and published again.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch

log = logging.getLogger(__name__)

# Env that changes what a build produces (ops/_build.py nvcc_path).
_BUILD_ENV = ("CUDA_HOME",)
_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".h")
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_source_hash_cache: dict = {}


def package_source_hash(pkg_root: Optional[str] = None) -> str:
    """Content hash of the package's program-defining source: every
    ``.py``, ``.cu``, ``.cuh``, ``.cpp`` and ``.h`` file under the package
    (``_build`` and ``__pycache__`` left out), in sorted relative paths,
    bytes not modification times. Cached per process for the installed
    tree; an explicit ``pkg_root`` is hashed afresh."""
    default_root = pkg_root is None
    if default_root:
        pkg_root = _PKG_ROOT
        cached = _source_hash_cache.get(pkg_root)
        if cached is not None:
            return cached
    h = hashlib.sha256()
    # top-down, sorted in place: the pruning below takes effect
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames.sort()
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build")]
        for fn in sorted(filenames):
            if not fn.endswith(_SOURCE_SUFFIXES):
                continue
            full = os.path.join(dirpath, fn)
            h.update(os.path.relpath(full, pkg_root).encode())
            with open(full, "rb") as f:
                h.update(f.read())
    digest = h.hexdigest()[:16]
    if default_root:
        _source_hash_cache[pkg_root] = digest
    return digest


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str)
                          .encode()).hexdigest()[:16]


def _toolchain() -> dict:
    return {"src": package_source_hash(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "machine": platform.machine(),
            "env": {k: os.getenv(k, "") for k in _BUILD_ENV}}


class AotCache:
    """One ``ASR_AOT_CACHE_DIR``."""

    @classmethod
    def from_env(cls) -> Optional["AotCache"]:
        path = os.getenv("ASR_AOT_CACHE_DIR")
        return cls(path) if path else None

    def __init__(self, path: str):
        self.path = os.path.abspath(os.path.expanduser(path))
        os.makedirs(self.path, exist_ok=True)

    # -- libraries --------------------------------------------------------------
    def library_dir(self, flags) -> str:
        """The directory of the libraries built with ``flags``."""
        return os.path.join(self.path, "lib-" + _digest(
            dict(_toolchain(), flags=list(flags))))

    def fetch_library(self, lib: Path, flags) -> bool:
        """Copy the cached ``lib`` (its name carries its source hash) and
        its build log into place; False when the cache has none, or holds
        one whose bytes are not the ones published (then it is rebuilt and
        published again)."""
        where = self.library_dir(flags)
        cached = os.path.join(where, lib.name)
        if not os.path.isfile(cached):
            return False
        if self._holds(cached) is None:
            log.warning("boot cache library %s is corrupt; rebuilding",
                        lib.name)
            return False
        lib.parent.mkdir(parents=True, exist_ok=True)
        log_file = lib.with_suffix(".log")
        cached_log = os.path.join(where, log_file.name)
        if os.path.isfile(cached_log):
            shutil.copyfile(cached_log, log_file)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        shutil.copyfile(cached, tmp)
        os.replace(tmp, lib)
        log.info("library %s taken from the boot cache", lib.name)
        return True

    @staticmethod
    def _holds(cached: str) -> Optional[str]:
        """The digest of the library at ``cached`` when its bytes are the
        ones published (its ``.sha256`` says so), else None."""
        try:
            with open(cached + ".sha256") as f:
                want = f.read().strip()
            return want if want == _file_digest(cached) else None
        except OSError:
            return None

    def publish_library(self, lib: Path, flags) -> None:
        """Keep ``lib``, its digest and its build log for later boots,
        unless the cache holds the same bytes already."""
        dest = self.library_dir(flags)
        digest = _file_digest(str(lib))
        if self._holds(os.path.join(dest, lib.name)) == digest:
            return
        os.makedirs(dest, exist_ok=True)
        log_file = lib.with_suffix(".log")
        if log_file.is_file():
            _publish(str(log_file), os.path.join(dest, log_file.name))
        _publish(str(lib), os.path.join(dest, lib.name))
        _publish_text(digest, os.path.join(dest, lib.name + ".sha256"))


def _file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _publish(src: str, dest: str) -> None:
    """Copy ``src`` to ``dest`` atomically."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest), suffix=".tmp")
    os.close(fd)
    shutil.copyfile(src, tmp)
    os.replace(tmp, dest)


def _publish_text(text: str, dest: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, dest)
