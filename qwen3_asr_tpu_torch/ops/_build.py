"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``. The
library's file name carries a hash of its source, of every header under
``csrc/`` (``*.cuh``) and of the flags, so an edited source or header
rebuilds and an unchanged one is reused. Builds happen at first use
(never at import) into ``qwen3_asr_tpu_torch/_build/``. A failed build
raises; nothing falls back.

``build_host`` does the same for a host source, ``csrc/<name>.cpp``: C++
with a plain C interface, compiled with ``g++`` into ``_build/``, keyed by
a hash of the source and the flags.

With ``ASR_AOT_CACHE_DIR`` set (``runtime/aot_cache.py``), a library that
is not in ``_build/`` is first looked up in that cache, and one that is
compiled here, or found here, is published there (unless the cache holds
it already), so a later boot with an empty ``_build/`` needs no compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _boot_cache():
    from ..runtime.aot_cache import AotCache
    return AotCache.from_env()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once (one
    ``nvcc`` process per source). Returns ``{name: ptxas report}``, read
    from the log kept beside each library."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cache = _boot_cache()
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            if cache:
                cache.publish_library(lib, NVCC_FLAGS)
            continue
        if cache and cache.fetch_library(lib, NVCC_FLAGS):
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)
        if cache:
            cache.publish_library(lib, NVCC_FLAGS)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        reports[name] = log.read_text() if log.exists() else ""
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def host_library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """The path of ``csrc/<name>.cpp``'s library, compiling it first if it
    is not built. Raises ``RuntimeError`` if the compiler fails or is
    missing."""
    lib = host_library_path(name)
    cache = _boot_cache()
    if lib.exists():
        if cache:
            cache.publish_library(lib, HOST_FLAGS)
        return lib
    if cache and cache.fetch_library(lib, HOST_FLAGS):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *HOST_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"host build of {name} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {name}: {cmd[0]} exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)
    if cache:
        cache.publish_library(lib, HOST_FLAGS)
    return lib
