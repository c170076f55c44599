"""ctypes bindings to the audio decoders' bit loops in C++
(``csrc/audio_dsp.cpp``): FLAC's residuals and prediction, MP3's side
information, scale factors and Huffman regions, MPEG Layer I/II's frames,
Vorbis's packets (floors, residues, coupling), and Opus: CELT's range-coded
frame and its post-filter, SILK's frames, and opusfile's 16-bit
conversion.

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
        lib.mpa_frames.argtypes = [u8p, i64, i64p, i64, i32, i32, i32p, i32p,
                                   i32p, i32p, i32p]
        lib.mpa_frames.restype = i64
        # Opus runs a few calls a frame: raw pointers (``_ptr``), not
        # ndpointer's checks, which cost more than the calls themselves
        vp = ctypes.c_void_p
        lib.celt_frame.argtypes = [vp] * 4 + [i32, vp] + [i32] * 7 \
            + [vp] * 5 + [i64, vp]
        lib.celt_frame.restype = i64
        lib.opus_pcm16.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp]
        lib.opus_pcm16.restype = None
        lib.silk_new.argtypes = [i32]
        lib.silk_new.restype = vp
        lib.silk_reset.argtypes = [vp]
        lib.silk_reset.restype = None
        lib.silk_free.argtypes = [vp]
        lib.silk_free.restype = None
        lib.silk_frame.argtypes = [vp] * 5 + [i32] * 5 + [vp]
        lib.silk_frame.restype = i64
        _lib = lib
        log.info("native audio DSP loaded: %s", path)
        return _lib


# -- Opus (audio/celt.py, audio/silk.py, audio/ogg_opus.py) -------------------

# the integer tables the C++ decoder reads, in the order of csrc/audio_dsp.cpp
# enum OpusTable
OPUS_TABLES = (
    "celt:EBANDS", "celt:ALLOC_VECTORS", "celt:E_PROB_MODEL",
    "celt:CACHE_INDEX", "celt:CACHE_BITS", "celt:CACHE_CAPS", "celt:LOGN",
    "celt:LOG2_FRAC", "celt:TF_SELECT", "celt:SMALL_ENERGY_ICDF",
    "celt:TRIM_ICDF", "celt:SPREAD_ICDF", "celt:TAPSET_ICDF",
    "silk:GAIN_ICDF", "silk:DELTA_GAIN_ICDF", "silk:PITCH_LAG_ICDF",
    "silk:PITCH_DELTA_ICDF", "silk:PITCH_CONTOUR_ICDF",
    "silk:PITCH_CONTOUR_NB_ICDF", "silk:PITCH_CONTOUR_10MS_ICDF",
    "silk:PITCH_CONTOUR_10MS_NB_ICDF", "silk:CB_LAGS_STAGE2",
    "silk:CB_LAGS_STAGE3", "silk:CB_LAGS_STAGE2_10MS",
    "silk:CB_LAGS_STAGE3_10MS", "silk:LTP_PER_INDEX_ICDF",
    "silk:LTP_GAIN_ICDF_0", "silk:LTP_GAIN_ICDF_1", "silk:LTP_GAIN_ICDF_2",
    "silk:LTP_VQ_0", "silk:LTP_VQ_1", "silk:LTP_VQ_2", "silk:LTPSCALE_ICDF",
    "silk:LTP_SCALES_Q14", "silk:TYPE_OFFSET_VAD_ICDF",
    "silk:TYPE_OFFSET_NO_VAD_ICDF", "silk:NLSF_INTERP_ICDF",
    "silk:NLSF_EXT_ICDF", "silk:UNIFORM3_ICDF", "silk:UNIFORM4_ICDF",
    "silk:UNIFORM5_ICDF", "silk:UNIFORM6_ICDF", "silk:UNIFORM8_ICDF",
    "silk:QUANT_OFFSETS_Q10", "silk:LSB_ICDF", "silk:LBRR_FLAGS_3_ICDF",
    "silk:LBRR_FLAGS_2_ICDF", "silk:STEREO_ONLY_MID_ICDF",
    "silk:STEREO_PRED_JOINT_ICDF", "silk:STEREO_PRED_QUANT_Q13",
    "silk:RATE_LEVELS_ICDF", "silk:PULSES_PER_BLOCK_ICDF",
    "silk:SHELL_CODE_TABLE0", "silk:SHELL_CODE_TABLE1",
    "silk:SHELL_CODE_TABLE2", "silk:SHELL_CODE_TABLE3",
    "silk:SHELL_CODE_TABLE_OFFSETS", "silk:SIGN_ICDF", "silk:LSF_COS_TAB_Q12",
    "silk:NLSF_NB_MB_CB1_Q8", "silk:NLSF_NB_MB_CB1_WGHT_Q9",
    "silk:NLSF_NB_MB_CB1_ICDF", "silk:NLSF_NB_MB_CB2_SELECT",
    "silk:NLSF_NB_MB_CB2_ICDF", "silk:NLSF_NB_MB_PRED_Q8",
    "silk:NLSF_NB_MB_DELTA_MIN_Q15", "silk:NLSF_WB_CB1_Q8",
    "silk:NLSF_WB_CB1_WGHT_Q9", "silk:NLSF_WB_CB1_ICDF",
    "silk:NLSF_WB_CB2_SELECT", "silk:NLSF_WB_CB2_ICDF", "silk:NLSF_WB_PRED_Q8",
    "silk:NLSF_WB_DELTA_MIN_Q15", "silk:RESAMPLER_FRAC_FIR_12",
    "silk:DELAY_MATRIX_DEC", "silk:RESAMPLER_UP2_HQ_0",
    "silk:RESAMPLER_UP2_HQ_1",
)
_opus_blob = None


def opus_blob():
    """(int32 values of every table of ``OPUS_TABLES`` one after another,
    int64 offsets [len + 1]) for the C++ decoder."""
    global _opus_blob
    if _opus_blob is None:
        from . import celt_tables, silk_tables
        mods = {"celt": celt_tables, "silk": silk_tables}
        parts = []
        for name in OPUS_TABLES:
            mod, attr = name.split(":")
            value = getattr(mods[mod], attr)
            if attr == "TF_SELECT":
                value = [v for row in value for v in row]
            parts.append(np.asarray(value, np.int32).reshape(-1))
        off = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
        _opus_blob = (np.ascontiguousarray(np.concatenate(parts)),
                      off.astype(np.int64))
    return _opus_blob


RANGE_FIELDS = ("storage", "offs", "end_offs", "end_window", "nend_bits",
                "nbits_total", "rng", "val", "rem", "ext", "error")


def _ptr(a: np.ndarray) -> int:
    """The address of a C-contiguous array's data."""
    if not a.flags.c_contiguous:
        raise ValueError("the helper takes C-contiguous arrays")
    return a.__array_interface__["data"][0]


def _range_in(rd) -> np.ndarray:
    return np.asarray([getattr(rd, f) for f in RANGE_FIELDS], np.int64)


def _range_out(rd, state: np.ndarray) -> None:
    for f, v in zip(RANGE_FIELDS, state.tolist()):
        setattr(rd, f, int(v))


_synth = None


def celt_decode(lib, rd, st, n: int) -> np.ndarray:
    """``celt.decode_frame``'s three steps through the helper
    (``celt_frame``): float64 [n, channels]."""
    global _synth
    if _synth is None:
        from .celt import synth_blob
        _synth = synth_blob()
    blob, off = opus_blob()
    buf = np.frombuffer(rd.buf, np.uint8)
    state = _range_in(rd)
    rng = np.asarray([st.rng], np.int64)
    pcm = np.empty((n, st.channels))
    hist = st.history
    got = lib.celt_frame(_ptr(buf), _ptr(state), _ptr(blob), _ptr(off),
                         len(off) - 1, _ptr(_synth), n, st.stream_channels,
                         st.channels, st.start, st.end, int(st.disable_inv),
                         st.loss_count, _ptr(st.energy), _ptr(rng),
                         _ptr(st.postfilter),
                         _ptr(st.preemph), _ptr(hist), hist.shape[1],
                         _ptr(pcm))
    _range_out(rd, state)
    if got < 0:
        from .celt import CeltError
        raise CeltError("corrupt CELT frame")
    st.rng = int(rng[0])
    return pcm


def pcm16(lib, x: np.ndarray, st) -> np.ndarray:
    """``ogg_opus.pcm16_plain`` through the helper (``opus_pcm16``)."""
    n, ch = x.shape
    out = np.empty((n, ch), np.int16)
    ms = np.asarray([st.mute, st.seed], np.int64)
    x = np.ascontiguousarray(x, np.float32)
    lib.opus_pcm16(_ptr(x), n, ch, _ptr(st.clip), _ptr(st.a), _ptr(st.b),
                   _ptr(ms), _ptr(out))
    st.mute, st.seed = int(ms[0]), int(ms[1])
    return out


def silk_frame(lib, dec, rd, n_internal: int, internal_rate: int,
               payload_ms: int, frame_size: int) -> np.ndarray:
    """``silk.decode`` through the helper (``silk_frame``, its state in
    the C++ object ``dec.handle``); with no ``rd``, a lost frame's
    concealment."""
    blob, off = opus_blob()
    out = np.zeros((frame_size, dec.channels_api), np.int16)
    if rd is None:  # the concealment of a lost frame
        got = lib.silk_frame(dec.handle, None, None, _ptr(blob), _ptr(off),
                             len(off) - 1, n_internal, internal_rate,
                             payload_ms, frame_size, _ptr(out))
    else:
        buf = np.frombuffer(rd.buf, np.uint8)
        state = _range_in(rd)
        got = lib.silk_frame(dec.handle, _ptr(buf), _ptr(state), _ptr(blob),
                             _ptr(off), len(off) - 1, n_internal,
                             internal_rate, payload_ms, frame_size,
                             _ptr(out))
        _range_out(rd, state)
    if got < 0:
        from .opus import OpusError
        raise OpusError("corrupt SILK frame")
    return out.astype(np.float64)
