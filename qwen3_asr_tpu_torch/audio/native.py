"""ctypes bindings to the audio decoders' bit loops in C++
(``csrc/audio_dsp.cpp``): FLAC's residuals and prediction, MP3's side
information, scale factors and Huffman regions, and Vorbis's packets
(floors, residues, coupling).

Counterpart of the FLAC half of ``qwen3_asr_tpu/audio/native.py``: the
library is built at first use (``ops/_build.py`` ``build_host``, into
``_build/``) and loaded with ``ctypes``. Where it cannot be built or
loaded, ``get_lib()`` logs JAX's warning once and returns None, and the
decoder takes its Python loops, the plain version.
"""
from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded helper, or None when it could not be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        from ..ops._build import build_host
        try:
            path = build_host("audio_dsp")
        except RuntimeError as e:
            log.warning("native audio DSP build failed (%s); using numpy "
                        "paths", e)
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native audio DSP load failed (%s); using numpy "
                        "paths", e)
            return None
        i64, i32 = ctypes.c_int64, ctypes.c_int
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.flac_rice_decode.argtypes = [u8p, i64, i64, i64, i32, i64p]
        lib.flac_rice_decode.restype = i64
        lib.flac_raw_decode.argtypes = [u8p, i64, i64, i64, i32, i64p]
        lib.flac_raw_decode.restype = i64
        lib.flac_predict.argtypes = [i64p, i64, i32p, i32, i32]
        lib.flac_predict.restype = i32
        lib.mp3_frames.argtypes = [u8p, i64, i64p, i64, i32, i32, i32, i32p,
                                   i32p, i64, i32p, i32p, u8p, i32p, i32p,
                                   i32p, i32p]
        lib.mp3_frames.restype = i64
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.vorbis_packets.argtypes = [u8p, i64, i64p, i64, i32p, i64,
                                       i32p, i64, f64p, i64, f64p, i64p,
                                       f64p, i64]
        lib.vorbis_packets.restype = i64
        _lib = lib
        log.info("native audio DSP loaded: %s", path)
        return _lib
