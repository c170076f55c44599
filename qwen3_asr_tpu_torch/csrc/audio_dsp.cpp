// FLAC's per-sample loops for the port's host decoder (audio/flac.py).
//
// Counterpart of the FLAC routines of qwen3_asr_tpu/native/audio_dsp.cpp:
// Rice and raw residual decoding and the LPC/fixed prediction recurrence.
// The frame and subframe parsing stays in Python; a call takes the
// stream's bytes and an ABSOLUTE bit offset (MSB first within each byte)
// and returns the offset where it stopped, so the Python bit reader hands
// off and resumes around each call.
//
// Host code with a plain C interface, built by ops/_build.py build_host
// into qwen3_asr_tpu_torch/_build/ at first use and loaded with ctypes
// (audio/native.py).

#include <cstdint>

extern "C" {

static inline int64_t flac_read_bits(const uint8_t* d, int64_t n_bytes,
                                     int64_t& bp, int k, bool& ok) {
    int64_t v = 0;
    for (int i = 0; i < k; ++i) {
        const int64_t byte = bp >> 3;
        if (byte >= n_bytes) { ok = false; return 0; }
        v = (v << 1) | ((d[byte] >> (7 - (bp & 7))) & 1);
        ++bp;
    }
    return v;
}

static inline int64_t flac_read_unary(const uint8_t* d, int64_t n_bytes,
                                      int64_t& bp, bool& ok) {
    int64_t q = 0;
    while (true) {
        const int64_t byte = bp >> 3;
        if (byte >= n_bytes) { ok = false; return 0; }
        const int rem = 8 - (bp & 7);
        const uint8_t cur = d[byte] & ((1u << rem) - 1);
        if (cur == 0) { q += rem; bp += rem; continue; }
        const int top = 31 - __builtin_clz(static_cast<unsigned>(cur));
        const int zeros = rem - 1 - top;
        q += zeros;
        bp += zeros + 1;  // the zeros plus the terminating 1-bit
        return q;
    }
}

// n zigzag Rice codes with fixed parameter. Returns the new absolute bit
// position, or -1 on stream overrun.
int64_t flac_rice_decode(const uint8_t* data, int64_t n_bytes,
                         int64_t bit_pos, int64_t n, int param,
                         int64_t* out) {
    bool ok = true;
    for (int64_t i = 0; i < n; ++i) {
        int64_t u = flac_read_unary(data, n_bytes, bit_pos, ok);
        if (param)
            u = (u << param) | flac_read_bits(data, n_bytes, bit_pos,
                                              param, ok);
        if (!ok) return -1;
        out[i] = (u >> 1) ^ -(u & 1);
    }
    return bit_pos;
}

// n raw two's-complement values of `bits` bits (escape partitions, VERBATIM
// subframes, warmup samples). Returns the new bit position or -1.
int64_t flac_raw_decode(const uint8_t* data, int64_t n_bytes,
                        int64_t bit_pos, int64_t n, int bits,
                        int64_t* out) {
    bool ok = true;
    const int64_t sign = int64_t(1) << (bits - 1);
    const int64_t full = int64_t(1) << bits;
    for (int64_t i = 0; i < n; ++i) {
        int64_t v = flac_read_bits(data, n_bytes, bit_pos, bits, ok);
        if (!ok) return -1;
        out[i] = (v & sign) ? v - full : v;
    }
    return bit_pos;
}

// In-place prediction restore: buf holds warmup samples followed by
// residuals; buf[i] += (sum_j coeffs[j]*buf[i-1-j]) >> shift for i >= order.
// (Arithmetic >> matches Python's floor shift for negatives; shift = 0 for
// fixed predictors.)
int flac_predict(int64_t* buf, int64_t n, const int32_t* coeffs, int order,
                 int shift) {
    for (int64_t i = order; i < n; ++i) {
        int64_t pred = 0;
        for (int j = 0; j < order; ++j)
            pred += static_cast<int64_t>(coeffs[j]) * buf[i - 1 - j];
        buf[i] += pred >> shift;
    }
    return 0;
}

}  // extern "C"
